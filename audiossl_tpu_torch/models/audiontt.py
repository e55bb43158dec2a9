"""AudioNTT2020Task6 encoder (BYOL-A conv net), PyTorch, eval path.

Port of ``audiossl_tpu.models.audiontt`` in the reference's own layout:
NCHW input [B, 1, F, T] and the reference ``state_dict`` (``features_{1,2,3}.
{0: Conv2d, 1: BatchNorm2d}``, ``fc.{0, 3}``), so a state_dict written by
``audiossl_tpu.models.torch_export`` or by ``models.convert`` loads with
``strict=True``. Three conv blocks (Conv 3x3 -> BN -> ReLU -> MaxPool 2x2)
with per-block time-pooled taps, then a per-timestep MLP (Linear(64 *
n_mels/8 -> d), ReLU, Dropout 0.3, Linear(d, d), ReLU).

Numerics follow the JAX module: conv and linear run in ``compute_dtype``
(bf16 by default, f32 for exact parity; an f32 model turns TF32 off for
cuDNN and cuBLAS while it runs, since cuDNN convs default to TF32 on the
card), BatchNorm uses its running statistics (eps 1e-5) computed in f32 and
cast back, taps and outputs are f32. The training path (batch statistics, the fused block-1 kernel) is the
next slice of the port; ``forward`` refuses to run in training mode.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


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


@contextlib.contextmanager
def _no_tf32():
    """IEEE f32 for cuDNN convs and cuBLAS matmuls inside the block; restores
    the caller's TF32 settings after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


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
            nn.Dropout(p=0.3),
            nn.Linear(d, d),
            nn.ReLU(),
        )

    def _block(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        conv, bn = seq[0], seq[1]
        dt = self.compute_dtype
        x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
        # BN from running statistics in f32, cast back to the compute dtype
        x = F.batch_norm(
            x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
            training=False, eps=bn.eps,
        ).to(dt)
        return F.max_pool2d(F.relu(x), 2, 2)

    def forward(self, x: torch.Tensor):
        if self.training:
            raise NotImplementedError(
                "AudioNTT2020Task6 is ported on its eval path only; call .eval() "
                "(the training path is the next slice, ROADMAP.md)"
            )
        with _no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            return self._forward(x)

    def _forward(self, x: torch.Tensor):
        dt = self.compute_dtype
        x = x.to(dt)
        taps = []
        for seq in (self.features_1, self.features_2, self.features_3):
            x = self._block(seq, x)
            taps.append(_time_major(x).float().mean(dim=1))
        h = _time_major(x)  # [B, T', F'*C]
        fc0, fc3 = self.fc[0], self.fc[3]
        h = F.relu(F.linear(h, fc0.weight.to(dt), fc0.bias.to(dt)))
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
