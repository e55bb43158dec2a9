"""Normalization blocks over carried state (port of ``audiossl_tpu.ops.stats``).

Reference: RunningNorm / NormalizeBatch (src/augmentations/augmentations.py:
215-328). RunningNorm keeps an online scalar mean and variance, updated once
per sample until a cap of ``epoch_samples * max_update_epochs`` samples, and
frozen after it.
"""
from __future__ import annotations

import dataclasses

import torch

EPS = 1.1920929e-7  # torch.finfo(float32).eps, the std clamp floor


@dataclasses.dataclass
class RunningNormState:
    n: int  # samples absorbed
    mean: torch.Tensor  # f32 scalar: running mean of per-sample means
    var: torch.Tensor  # f32 scalar: running mean of per-sample squared deviations
    max_update: int  # sample cap, frozen afterwards


def running_norm_init(
    epoch_samples: int, max_update_epochs: int = 10, device: str | torch.device = "cpu"
) -> RunningNormState:
    return RunningNormState(
        n=0,
        mean=torch.zeros((), dtype=torch.float32, device=device),
        var=torch.ones((), dtype=torch.float32, device=device),
        max_update=epoch_samples * max_update_epochs,
    )


def _recurrence(k0: int, first: torch.Tensor, vals: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The reference's per-sample recursion mu_k = (1 - 1/k) mu_{k-1} + v_k / k
    (mu = v at k = 0 and k = 1), for samples k = k0, k0 + 1, ..., in closed
    form: k mu_k = (k0 - 1) mu_{k0-1} + sum of v over samples 1 .. k in this
    batch. ``first`` is v of a k = 0 sample, which k = 1 overwrites."""
    ks = k0 + torch.arange(vals.shape[0], device=vals.device)
    base = (k0 - 1) * prev if k0 >= 1 else torch.zeros_like(prev)
    running = (base + torch.cumsum(torch.where(ks == 0, 0.0, vals), 0)) / ks.clamp_min(1)
    return torch.where(ks == 0, first, running)


def running_norm_apply(state: RunningNormState, x: torch.Tensor) -> tuple[RunningNormState, torch.Tensor]:
    """Absorb batch ``x [B, ...]`` sample by sample (below the cap) and
    normalize it with the statistics after the last sample."""
    red = tuple(range(1, x.dim()))
    m1 = x.mean(red).float()  # per-sample mean
    m2 = x.square().mean(red).float()  # per-sample E[x²]
    k0 = state.n
    u = max(0, min(x.shape[0], state.max_update - k0))  # samples below the cap
    mean, var = state.mean, state.var
    if u:
        mus = _recurrence(k0, m1[0], m1[:u], state.mean)
        sq = m2[:u] - 2.0 * mus * m1[:u] + mus * mus  # uses the mean after each sample
        mean = mus[-1]
        var = _recurrence(k0, sq[0], sq, state.var)[-1]
    std = torch.sqrt(var.clamp_min(0.0)).clamp_min(EPS)
    return RunningNormState(n=k0 + u, mean=mean, var=var, max_update=state.max_update), (x - mean) / std


def precomputed_norm(x: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """(x - mean) / std with dataset statistics (MAST passes 2 * std)."""
    return (x - mean) / std


def normalize_batch(x: torch.Tensor, dim=(0, 2, 3)) -> torch.Tensor:
    """Zero mean, unit std over ``dim`` (NormalizeBatch; torch .std() is unbiased)."""
    mean = x.mean(dim, keepdim=True)
    cnt = 1
    for d in dim:
        cnt *= x.shape[d]
    var = (x - mean).square().sum(dim, keepdim=True) / max(cnt - 1, 1)
    return (x - mean) / torch.sqrt(var).clamp_min(EPS)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x * rsqrt(|x|² + eps²): F.normalize's values, with a bounded gradient at 0."""
    return x * torch.rsqrt(x.square().sum(dim, keepdim=True) + eps * eps)
