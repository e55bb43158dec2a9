"""MAST: an MViTv2 trunk over AST-style patches of a log-fbank (port of
``audiossl_tpu.models.mast``).

The input [B, 1, F, T] (the port's view layout) is turned time-major, so
that time is the token grid's H axis as in the JAX module (mast.py:80),
patchified by a 1-channel 16x16 conv with stride 10 and no padding, run
through the MViTv2 stages without a final norm, and mean-pooled over tokens
in f32. ``MASTWithHead`` adds the SS-MAST Linear(d -> output_dim), in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.models.mvit import MViT, MViTConfig

VARIANTS = {"tiny": MViTConfig.tiny, "small": MViTConfig.small, "base": MViTConfig.base}


def mast_config(model_size: str = "base", fstride: int = 10, tstride: int = 10, compute_dtype=None,
                droppath_rate: float | None = None, fused_attention: str = "auto", pool_impl: str = "conv") -> MViTConfig:
    kw: dict = dict(
        patch_kernel=(16, 16),
        patch_stride=(tstride, fstride),  # H = time, W = freq
        patch_padding=(0, 0),
        use_abs_pos=False,
        cls_embed_on=False,
        compute_dtype=compute_dtype,
        fused_attention=fused_attention,
        pool_impl=pool_impl,
    )
    if droppath_rate is not None:  # MVIT.DROPPATH_RATE; None keeps 0.1 / 0.2 / 0.3 for T / S / B
        kw["droppath_rate"] = float(droppath_rate)
    return VARIANTS[model_size](**kw)


class MASTEncoder(MViT):
    """[B, 1, F, T] log-fbank -> [B, D] f32 token mean."""

    def __init__(self, input_fdim: int = 128, input_tdim: int = 1024, model_size: str = "base", fstride: int = 10,
                 tstride: int = 10, remat: bool = False, compute_dtype: torch.dtype | None = torch.bfloat16,
                 droppath_rate: float | None = None, fused_attention: str = "auto", pool_impl: str = "conv"):
        cfg = mast_config(model_size, fstride, tstride, compute_dtype, droppath_rate, fused_attention, pool_impl)
        super().__init__(cfg, input_hw=(input_tdim, input_fdim), in_chans=1, final_norm=False, remat=remat)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, *, draws=None) -> torch.Tensor:
        tokens = super().forward(x.transpose(-1, -2), generator, draws=draws)
        return tokens.float().mean(1)


class MASTWithHead(nn.Module):
    """MAST + Linear(d -> output_dim) (models_msn.py:167-173)."""

    def __init__(self, output_dim: int = 256, **mast_kw):
        super().__init__()
        self.mast = MASTEncoder(**mast_kw)
        self.mlp_fc1 = nn.Linear(self.mast.embed_dim, output_dim)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.mast.cfg.compute_dtype or torch.float32

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        z = self.mast(x, generator)
        with no_tf32():
            return F.linear(z, self.mlp_fc1.weight, self.mlp_fc1.bias)
