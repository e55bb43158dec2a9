"""Token-level ops: PatchDrop for transformer inputs (port of
``audiossl_tpu.ops.tokens``).

The reference PatchDrop (src/augmentations/augmentations.py:64-79) means to
keep a random ``1 - ratio`` fraction of the patch tokens; the keep-count is
``floor(N * (1 - ratio))``, a constant of the config. The JAX package draws
each sample's kept tokens with threefry, which torch cannot reproduce, so
the port splits the op: ``keep_indices`` draws the indices from a
``torch.Generator`` and ``gather_tokens`` is the deterministic core the
parity tests feed with JAX's own indices.
"""
from __future__ import annotations

import math

import torch


def keep_count(n: int, ratio: float) -> int:
    return int(math.floor(n * (1.0 - ratio)))


def keep_indices(b: int, n: int, ratio: float, generator: torch.Generator, device=None) -> torch.Tensor:
    """[B, N_keep] int64: the first N_keep entries of an independent random
    permutation of the N tokens per sample (order arbitrary, like randperm)."""
    n_keep = keep_count(n, ratio)
    perm = torch.argsort(torch.rand((b, n), generator=generator, device=generator.device), dim=1)
    return perm[:, :n_keep].to(device)


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C] and [B, N_keep] indices -> [B, N_keep, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def patch_drop(x: torch.Tensor, ratio: float, generator: torch.Generator) -> torch.Tensor:
    """[B, N, C] -> [B, floor(N (1 - ratio)), C], the kept tokens drawn per sample."""
    b, n, _ = x.shape
    if keep_count(n, ratio) >= n:
        return x
    return gather_tokens(x, keep_indices(b, n, ratio, generator, x.device))
