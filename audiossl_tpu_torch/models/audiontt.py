"""AudioNTT2020Task6 encoder (BYOL-A conv net), PyTorch, eval and training.

Port of ``audiossl_tpu.models.audiontt`` in the reference's own layout:
NCHW input [B, 1, F, T] and the reference ``state_dict`` (``features_{1,2,3}.
{0: Conv2d, 1: BatchNorm2d}``, ``fc.{0, 3}``), so a state_dict written by
``audiossl_tpu.models.torch_export`` or by ``models.convert`` loads with
``strict=True``. Three conv blocks (Conv 3x3 -> BN -> ReLU -> MaxPool 2x2)
with per-block time-pooled taps, then a per-timestep MLP (Linear(64 *
n_mels/8 -> d), ReLU, Dropout, Linear(d, d), ReLU).

Numerics follow the JAX module: parameters are f32 and conv and linear run
in ``compute_dtype`` (bf16 by default, f32 for exact parity; an f32 model
turns TF32 off for cuDNN and cuBLAS while it runs, since cuDNN convs default
to TF32 on the card); BatchNorm runs in f32 and casts back; taps and outputs
are f32. In eval mode BN uses its running statistics. In training mode:

* block 1 goes through ``ops.block1.fused_block1`` (the Hopper kernels on
  the card) wherever ``block1.feasible`` holds, as the JAX module does;
  otherwise, and for blocks 2 and 3, the conv runs in ``compute_dtype`` and
  BN takes the batch statistics of its output in f32 (E[x²] − E[x]², flax's
  fast variance);
* running statistics update as 0.9 · running + 0.1 · batch with the BIASED
  batch variance (flax's rule; ``nn.BatchNorm2d``'s own update stores the
  unbiased one);
* dropout draws its mask from the ``generator`` passed to ``forward``.

Across processes (parallel/dist.py) every training-mode BatchNorm is
SyncBN as flax's ``BatchNorm(axis_name=...)`` is: the group's mean of the
batch mean and of the mean of squares, through an all-reduce whose backward
sums the cotangents, and the running statistics fed the group's biased
variance. Not ``nn.SyncBatchNorm``, which combines per-process variances by
count and stores the unbiased one. Block 1's kernels do the same
(ops/block1.py).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.ops import block1
from audiossl_tpu_torch.parallel import dist


def _conv_block(c_in: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(c_in, 64, 3, stride=1, padding=1),
        nn.BatchNorm2d(64, eps=1e-5),
        nn.ReLU(),
        nn.MaxPool2d(2, stride=2),
    )


def _time_major(x: torch.Tensor) -> torch.Tensor:
    """NCHW [B, C, F', T'] -> [B, T', F'*C] — (freq, channel)-major rows, the
    flatten order of the JAX module's time-major [B, T', F', C]."""
    b, c, f, t = x.shape
    return x.permute(0, 3, 2, 1).reshape(b, t, f * c)


BN_MOMENTUM = 0.9  # flax's convention: running = 0.9 * running + 0.1 * batch


def update_running_stats(bn: nn.modules.batchnorm._BatchNorm, mean: torch.Tensor, var: torch.Tensor) -> None:
    """Fold one batch's mean and biased variance into ``bn``'s running
    statistics, as flax does."""
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)


def sync_moments(x: torch.Tensor, axes: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x²]) over ``axes``, the group's mean of each across processes
    (flax's pmean of the two under ``axis_name``); differentiable."""
    mean, msq = x.mean(axes), (x * x).mean(axes)
    if dist.data_active():
        mean, msq = dist.all_reduce_mean(torch.stack([mean, msq]), "syncbn").unbind(0)
    return mean, msq


def batch_norm_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=False, dtype=f32)`` over every
    axis but 1: batch mean and fast biased variance in f32 (the group's,
    across processes), running stats updated, f32 output."""
    axes = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.float()
    mean, msq = sync_moments(xf, axes)
    var = (msq - mean * mean).clamp_min(0.0)
    update_running_stats(bn, mean.detach(), var.detach())
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)


class AudioNTT2020Task6(nn.Module):
    """[B, 1, F, T] spectrogram -> per-frame features [B, T/8, d] (f32); with
    ``return_all_layers`` also the three time-pooled taps (2048 / 1024 /
    512-d for n_mels=64)."""

    def __init__(
        self,
        n_mels: int = 64,
        d: int = 2048,
        return_all_layers: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
        dropout_rate: float = 0.3,
    ):
        super().__init__()
        self.n_mels, self.d = n_mels, d
        self.return_all_layers = return_all_layers
        self.compute_dtype = compute_dtype
        self.features_1 = _conv_block(1)
        self.features_2 = _conv_block(64)
        self.features_3 = _conv_block(64)
        self.fc = nn.Sequential(
            nn.Linear(64 * (n_mels // 8), d),
            nn.ReLU(),
            nn.Dropout(p=dropout_rate),
            nn.Linear(d, d),
            nn.ReLU(),
        )

    def _block(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        conv, bn = seq[0], seq[1]
        dt = self.compute_dtype
        x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
        if self.training:
            x = batch_norm_train(bn, x).to(dt)
        else:  # BN from running statistics in f32, cast back to the compute dtype
            x = F.batch_norm(
                x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                training=False, eps=bn.eps,
            ).to(dt)
        return F.max_pool2d(F.relu(x), 2, 2)

    def _fused_block1(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.features_1[0], self.features_1[1]
        pooled, mean, var = block1.fused_block1(x, conv.weight, conv.bias, bn.weight, bn.bias)
        update_running_stats(bn, mean, var)
        return pooled

    def _dropout(self, h: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        rate = self.fc[2].p
        if rate == 0.0:
            return h
        if generator is None:
            raise ValueError("AudioNTT2020Task6 in training mode with dropout needs an explicit torch.Generator")
        keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - rate
        return torch.where(keep, h / (1.0 - rate), 0.0)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        """``generator`` carries the dropout draws in training mode."""
        with no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            return self._forward(x, generator)

    def _forward(self, x: torch.Tensor, generator: torch.Generator | None):
        dt = self.compute_dtype
        x = x.to(dt)
        taps = []
        for i, seq in enumerate((self.features_1, self.features_2, self.features_3)):
            if i == 0 and self.training and block1.feasible(x.shape[3], x.shape[2], 64):
                x = self._fused_block1(x)
            else:
                x = self._block(seq, x)
            taps.append(_time_major(x).float().mean(dim=1))
        h = _time_major(x)  # [B, T', F'*C]
        fc0, fc3 = self.fc[0], self.fc[3]
        h = F.relu(F.linear(h, fc0.weight.to(dt), fc0.bias.to(dt)))
        if self.training:
            h = self._dropout(h, generator)
        h = F.relu(F.linear(h, fc3.weight.to(dt), fc3.bias.to(dt))).float()
        if self.return_all_layers:
            return taps[0], taps[1], taps[2], h
        return h


def max_mean_pool(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """max + mean temporal pooling (upstream_encoder.py:26-28)."""
    return x.amax(dim=dim) + x.mean(dim=dim)


def random_state_dict(n_mels: int = 64, d: int = 2048, seed: int = 0) -> dict[str, torch.Tensor]:
    """A seeded random AudioNTT state_dict in the reference layout: lecun-
    normal conv/linear weights (flax's default init), small random biases,
    and BN affine and running statistics drawn around identity (var > 0)."""
    g = torch.Generator().manual_seed(seed)
    model = AudioNTT2020Task6(n_mels=n_mels, d=d)
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros((), dtype=torch.long)
        elif name.endswith("running_var"):
            sd[name] = 0.5 + torch.rand(t.shape, generator=g)
        elif name.endswith("running_mean") or (name.endswith(".bias") and t.dim() == 1):
            sd[name] = 0.1 * torch.randn(t.shape, generator=g)
        elif t.dim() == 1:  # BN scale
            sd[name] = 1.0 + 0.1 * torch.randn(t.shape, generator=g)
        else:
            fan_in = t[0].numel()
            sd[name] = torch.randn(t.shape, generator=g) / fan_in**0.5
    return sd
