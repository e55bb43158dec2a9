"""EfficientNet-B0 encoder on a 1-channel spectrogram (port of
``audiossl_tpu.models.efficientnet``; reference: src/encoder/efficientnet.py,
``EfficientNet.from_name('efficientnet-b0', include_top=False,
in_channels=1)``).

MBConv blocks with squeeze-excitation and swish, BatchNorm eps 1e-3,
stochastic depth 0.2 · block / 16 on the residual blocks, a 1280-wide head
conv and a global average pool: [B, 1, F, T] -> [B, 1280]. Parameter names
are efficientnet_pytorch's (``_conv_stem``, ``_bn0``, ``_blocks.{i}.
{_expand_conv, _bn0, _depthwise_conv, _bn1, _se_reduce, _se_expand,
_project_conv, _bn2}``, ``_conv_head``, ``_bn1``); ``models.convert.
efficientnet_from_flax`` carries the JAX module's variables over.

Numerics follow the JAX module: f32 throughout (TF32 off), "SAME" padding
as flax computes it (the extra row or column after, for a stride of 2),
and BatchNorm as flax's: in training mode the batch mean and biased
variance, and running statistics updated as 0.99 · running + 0.01 · batch
with the biased variance. Stochastic depth keeps a sample with probability
1 − rate, where a U(0, 1) draw falls below 1 − rate (``jax.random.
bernoulli``'s rule): the draws come from the ``generator`` passed to
``forward``, or from ``draws`` (one [B] tensor per residual block with a
rate, in block order), which the parity tests pass.
"""
from __future__ import annotations

import math
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.models.audiontt import sync_moments

B0_STAGES = (
    # expand_ratio, out_ch, repeats, kernel, stride
    (1, 16, 1, 3, 1),
    (6, 24, 2, 3, 2),
    (6, 40, 2, 5, 2),
    (6, 80, 3, 3, 2),
    (6, 112, 3, 5, 1),
    (6, 192, 4, 5, 2),
    (6, 320, 1, 3, 1),
)
BN_EPS = 1e-3
BN_MOMENTUM = 0.99  # flax's convention: running = 0.99 * running + 0.01 * batch


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, training: bool) -> torch.Tensor:
    """flax ``BatchNorm(momentum=0.99, epsilon=1e-3)`` on NCHW."""
    if not training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, training=False, eps=bn.eps)
    mean, msq = sync_moments(x, [0, 2, 3])  # SyncBN across processes, as flax's axis_name
    var = (msq - mean * mean).clamp_min(0.0)  # flax's fast biased variance
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)


def conv_same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` with flax's "SAME" padding: out = ceil(in / stride), the
    total padding split with the odd element after."""
    pads = []
    for size, k, s in zip(reversed(x.shape[2:]), reversed(conv.kernel_size), reversed(conv.stride)):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), conv.weight, conv.bias, conv.stride, 0, 1, conv.groups)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int, kernel: int, stride: int, drop_rate: float,
                 se_ratio: float = 0.25):
        super().__init__()
        mid = in_ch * expand_ratio
        self.expand_ratio, self.drop_rate = expand_ratio, drop_rate
        self.residual = stride == 1 and in_ch == out_ch
        if expand_ratio != 1:
            self._expand_conv = nn.Conv2d(in_ch, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        self._depthwise_conv = nn.Conv2d(mid, mid, kernel, stride, groups=mid, bias=False)
        self._bn1 = _bn(mid)
        hidden = max(1, int(in_ch * se_ratio))
        self._se_reduce = nn.Conv2d(mid, hidden, 1)
        self._se_expand = nn.Conv2d(hidden, mid, 1)
        self._project_conv = nn.Conv2d(mid, out_ch, 1, bias=False)
        self._bn2 = _bn(out_ch)

    @property
    def draws(self) -> bool:
        """Whether the block draws a stochastic-depth mask in training mode."""
        return self.residual and self.drop_rate > 0.0

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        """``keep`` [B] of 0 / 1: the stochastic-depth mask (training mode)."""
        inputs = x
        if self.expand_ratio != 1:
            x = F.silu(batch_norm(self._bn0, F.conv2d(x, self._expand_conv.weight), self.training))
        x = F.silu(batch_norm(self._bn1, conv_same(x, self._depthwise_conv), self.training))
        s = F.silu(F.conv2d(x.mean((2, 3), keepdim=True), self._se_reduce.weight, self._se_reduce.bias))
        x = x * torch.sigmoid(F.conv2d(s, self._se_expand.weight, self._se_expand.bias))
        x = batch_norm(self._bn2, F.conv2d(x, self._project_conv.weight), self.training)
        if not self.residual:
            return x
        if keep is not None:
            x = x / (1.0 - self.drop_rate) * keep.to(x.dtype).view(-1, 1, 1, 1)
        return x + inputs


class EfficientNetB0(nn.Module):
    """[B, 1, F, T] -> [B, 1280] pooled features (the include_top=False path)."""

    out_dim = 1280

    def __init__(self, drop_connect_rate: float = 0.2):
        super().__init__()
        self._conv_stem = nn.Conv2d(1, 32, 3, 2, bias=False)
        self._bn0 = _bn(32)
        total = sum(s[2] for s in B0_STAGES)
        blocks, in_ch = [], 32
        for expand, out_ch, repeats, kernel, stride in B0_STAGES:
            for r in range(repeats):
                blocks.append(MBConv(in_ch, out_ch, expand, kernel, stride if r == 0 else 1,
                                     drop_connect_rate * len(blocks) / total))
                in_ch = out_ch
        self._blocks = nn.ModuleList(blocks)
        self._conv_head = nn.Conv2d(in_ch, 1280, 1, bias=False)
        self._bn1 = _bn(1280)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                draws: Iterator[torch.Tensor] | None = None) -> torch.Tensor:
        """In training mode the stochastic-depth draws come from ``draws``
        (an iterator of U(0, 1) [B] tensors, one per drawing block in order)
        or from ``generator``."""
        if self.training and draws is None and generator is None:
            raise ValueError("EfficientNetB0 in training mode needs a generator or draws for its stochastic depth")
        with no_tf32():
            x = x.float()
            x = F.silu(batch_norm(self._bn0, conv_same(x, self._conv_stem), self.training))
            for blk in self._blocks:
                keep = None
                if self.training and blk.draws:
                    draw = next(draws) if draws is not None else \
                        torch.rand(x.shape[0], generator=generator, device=generator.device)
                    keep = (draw.to(x.device) < 1.0 - blk.drop_rate).float()
                x = blk(x, keep)
            x = F.silu(batch_norm(self._bn1, F.conv2d(x, self._conv_head.weight), self.training))
        return x.mean((2, 3))
