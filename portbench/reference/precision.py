"""Operand precision of the reference's products.

``Precision("f32")`` is IEEE float32 with TF32 off; ``"tf32"``, ``"bf16"``
and ``"fp8"`` round each operand of a product to TF32 (10 mantissa bits, as
the tensor cores read float32 with TF32 on), to bfloat16, or to float8 e4m3
with a per-tensor scale, and multiply in float32, so that a mode reads the
same on any device. LayerNorm runs in float32, or with ``norm="bf16"`` in bfloat16
arithmetic: its input, mean, centred values, variance, scale and result
each rounded to bfloat16. A control of the output check is the reference at
a precision one step below one that the configuration states.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale (amax -> 448), back in t's dtype."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


class RoundOperand(torch.autograd.Function):
    """Round in the forward, pass the gradient straight through (and round it
    too, as a low-precision backward product would read it)."""

    @staticmethod
    def forward(ctx, t, mode):
        ctx.mode = mode
        return _round(t, mode)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mode), None


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the nearest TF32 value (ties to even), back in t's dtype."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32).to(t.dtype)


def _round(t: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tf32":
        return round_tf32(t)
    if mode == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    if mode == "fp8":
        return round_fp8(t)
    return t


class Precision:
    """How the reference computes: ``gemm`` for the dense and conv layers,
    ``attn`` for the attention products (q k^T and p v), each one of f32,
    tf32, bf16 or fp8; ``norm`` for LayerNorm, f32 or bf16."""

    MODES = ("f32", "tf32", "bf16", "fp8")
    NORM_MODES = ("f32", "bf16")

    def __init__(self, gemm: str = "f32", attn: str | None = None, norm: str = "f32"):
        attn = attn or gemm
        if gemm not in self.MODES or attn not in self.MODES or norm not in self.NORM_MODES:
            raise ValueError(f"precision modes are {self.MODES} (norm {self.NORM_MODES}), "
                             f"got {gemm!r} / {attn!r} / {norm!r}")
        self.gemm, self.attn, self.norm = gemm, attn, norm

    def __repr__(self) -> str:
        return f"Precision(gemm={self.gemm}, attn={self.attn}, norm={self.norm})"

    def g(self, t: torch.Tensor) -> torch.Tensor:
        """A dense or conv operand."""
        return RoundOperand.apply(t, self.gemm) if self.gemm != "f32" else t

    def a(self, t: torch.Tensor) -> torch.Tensor:
        """An attention operand."""
        return RoundOperand.apply(t, self.attn) if self.attn != "f32" else t

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """A dense layer's result: bfloat16 where its operands are narrower
        than float32 (the type a bf16 or fp8 product is stored in)."""
        return RoundOperand.apply(t, "bf16") if self.gemm in ("bf16", "fp8") else t

    def layer_norm(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
        """LayerNorm over the last axis in this precision's ``norm`` mode."""
        if self.norm == "f32":
            return F.layer_norm(x, (x.shape[-1],), w, b, eps)
        r = lambda t: RoundOperand.apply(t, "bf16")  # noqa: E731
        x = r(x)
        d = r(x - r(x.mean(-1, keepdim=True)))
        rstd = r(torch.rsqrt(r(d.square().mean(-1, keepdim=True)) + eps))
        return r(r(r(d * rstd) * r(w)) + r(b))

    @contextlib.contextmanager
    def products(self):
        """The device's TF32 off (every mode rounds its operands itself), restored after."""
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


F32 = Precision("f32")
