"""What the reference encoders share, as plain functions of a dict of
weights under the port's parameter names, in float32 unless ``prec`` rounds
the operands of the products or runs LayerNorm lower; and the encoder of a
configuration found by name: ``encoders/<encoder in lower case>.py`` with
``forward(x, p, arch, prec, draws)``."""
from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

from portbench.reference.precision import F32, Precision


def linear(x, w, b, prec: Precision):
    return F.linear(prec.g(x), prec.g(w), b)


def drop_path(x: torch.Tensor, rate: float, u: torch.Tensor | None) -> torch.Tensor:
    """x / keep where floor(keep + u) is 1, else 0, per sample."""
    if u is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return x / keep * torch.floor(keep + u).view(-1, *(1,) * (x.dim() - 1))


def softmax_attention(q, k, v, scale: float, prec: Precision, bias=None):
    """softmax(q k^T * scale + bias) v, q [N, Lq, D], k, v [N, Lk, D]."""
    s = torch.matmul(prec.a(q) * scale, prec.a(k).transpose(-1, -2))
    if bias is not None:
        s = s + bias
    return torch.matmul(prec.a(torch.softmax(s, dim=-1)), prec.a(v))


def sub(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def encoder(kind: str):
    """The reference module of the configuration's ``encoder`` (``MAST`` ->
    ``encoders/mast.py``)."""
    return importlib.import_module(f"portbench.reference.encoders.{kind.lower()}")


def encoder_forward(kind: str, x, p: dict, arch: dict, prec: Precision = F32, draws=None):
    """[B, 1, F, T] features -> [B, D] embeddings through the reference of ``kind``."""
    return encoder(kind).forward(x, p, arch, prec, draws)
