"""Projection and classifier heads and the Barlow loss (port of
``audiossl_tpu.models.heads``).

``MLPProjector`` keeps the reference ``Projection`` layout
(src/upstream/delores_s/upstream_expert.py:11-28): ``projector.{0,3,6}``
bias-free Linears and ``projector.{1,4}`` BatchNorm1d, plus the affine-free
``bn`` whose state the reference stores (the loss standardizes with
``batch_standardize`` instead), so ``models.convert.projection_from_flax``
and ``audiossl_tpu.models.torch_export.projection_to_torch`` both load with
``strict=True``. Matmuls run in ``compute_dtype``; BatchNorm follows the
encoder's training rule (f32 batch statistics, running stats 0.9 / 0.1 with
the biased variance); the projection is f32.

``ClusterProjector`` (SLICER's cluster head) and ``LinearClassifier``
(UnFuSeD's classifier) are biased Linears that run in the dtype of their
input, f32 on the objectives' paths, with TF32 off for an f32 input.

Across processes (parallel/dist.py) the projector's BatchNorms are SyncBN
(``batch_norm_train``), ``batch_standardize`` takes the group's moments, and
the Barlow cross-correlation is divided by the world size and summed over
the group, as the JAX package does under ``axis_name``; the all-reduces'
backward sums the cotangents, so the mean of the gradients is the
one-process gradient of the whole batch. One process: no collective.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.models.audiontt import batch_norm_train
from audiossl_tpu_torch.parallel import dist


class MLPProjector(nn.Module):
    """[in] -> hidden -> hidden -> out, BN + ReLU between bias-free Linears."""

    def __init__(self, in_dim: int, hidden: int = 2048, out: int = 2048, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.projector = nn.Sequential(
            nn.Linear(in_dim, hidden, bias=False),
            nn.BatchNorm1d(hidden, eps=1e-5),
            nn.ReLU(),
            nn.Linear(hidden, hidden, bias=False),
            nn.BatchNorm1d(hidden, eps=1e-5),
            nn.ReLU(),
            nn.Linear(hidden, out, bias=False),
        )
        self.bn = nn.BatchNorm1d(out, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            dt = self.compute_dtype
            x = x.to(dt)
            for lin, bn in ((self.projector[0], self.projector[1]), (self.projector[3], self.projector[4])):
                x = F.linear(x, lin.weight.to(dt))
                if self.training:
                    x = batch_norm_train(bn, x)
                else:
                    x = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias, eps=bn.eps)
                x = F.relu(x.to(dt))
            return F.linear(x, self.projector[6].weight.to(dt)).float()


def _f32_exact(x: torch.Tensor):
    """``no_tf32()`` for an f32 input, else nothing."""
    return no_tf32() if x.dtype == torch.float32 else contextlib.nullcontext()


class LinearClassifier(nn.Linear):
    """A biased Linear run in its input's dtype (flax ``Dense(dtype=x.dtype)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _f32_exact(x):
            return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ClusterProjector(nn.Sequential):
    """Linear -> ReLU -> Linear -> softmax over clusters (SLICER's cluster
    head, src/upstream/slicer/upstream_encoder.py:15-21), biased, in the
    input's dtype."""

    def __init__(self, in_dim: int, hidden: int, num_clusters: int):
        super().__init__(nn.Linear(in_dim, hidden), nn.ReLU(), nn.Linear(hidden, num_clusters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        with _f32_exact(x):
            h = F.relu(F.linear(x, self[0].weight.to(dt), self[0].bias.to(dt)))
            return torch.softmax(F.linear(h, self[2].weight.to(dt), self[2].bias.to(dt)), dim=1)


def batch_standardize(z: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm1d(affine=False) in training, as a function: standardize
    each feature over the batch with the biased variance E[z²] − E[z]²,
    the group's moments across processes (JAX heads.py:67-76)."""
    mean, sq = z.mean(0), z.square().mean(0)
    if dist.data_active():
        mean, sq = dist.all_reduce_mean(torch.stack([mean, sq]), "barlow").unbind(0)
    var = sq - mean.square()
    return (z - mean) * torch.rsqrt(var + eps)


def off_diagonal_sq_sum(c: torch.Tensor) -> torch.Tensor:
    """Sum of the squared off-diagonal entries."""
    return c.square().sum() - torch.diagonal(c).square().sum()


def barlow_loss(z1: torch.Tensor, z2: torch.Tensor, lambd: float | None = 5e-5, scale_loss: float = 1.0 / 32.0) -> torch.Tensor:
    """The unified framework's Barlow-Twins loss (``variant="src"``,
    src/upstream/delores_s/upstream_expert.py:30-46):
    lambd * scale * (on_diag + off_diag) over the cross-correlation of the
    standardized projections, an f32 product with TF32 off; across
    processes divided by the world size and summed (JAX heads.py:108-112)."""
    b = z1.shape[0]
    with no_tf32():
        c = batch_standardize(z1).T @ batch_standardize(z2) / b
    if dist.data_active():
        c = dist.all_reduce_sum(c / dist.dp_world(), "barlow")
    on_diag = (torch.diagonal(c) - 1.0).square().sum()
    off_diag = off_diagonal_sq_sum(c)
    if lambd:
        return lambd * scale_loss * on_diag + lambd * scale_loss * off_diag
    return scale_loss * (on_diag + off_diag)
