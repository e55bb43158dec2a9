"""Downstream encoder + linear head (port of audiossl_tpu.downstream.model).

``finetune_layer == -1`` uses the final per-frame features, pooled by their
time MEAN (not max+mean); 0/1/2 use the per-block taps (already time-pooled,
dims 2048/1024/512 for 64 mels). ``num_classes == 0`` drops the head and
returns the pooled embedding itself — the serving surface (serve/export.py).

Only the AudioNTT2020Task6 encoder is ported; the transformer and
EfficientNet encoders raise until their slices land.
"""
from __future__ import annotations

import torch
from torch import nn

from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6


class DownstreamModel(nn.Module):
    """[B, 1, F, T] spectrogram -> [B, D] embedding, or [B, num_classes]
    logits. The encoder's parameters live under ``encoder.``, the head's
    under ``final.``."""

    def __init__(
        self,
        n_mels: int,
        d: int,
        num_classes: int,
        finetune_layer: int = -1,
        encoder_type: str = "AudioNTT2020Task6",
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        if encoder_type != "AudioNTT2020Task6":
            raise NotImplementedError(
                f"encoder {encoder_type!r} is not ported yet; only AudioNTT2020Task6 is "
                "(ROADMAP.md, Queue 1)"
            )
        self.finetune_layer = finetune_layer
        self.num_classes = num_classes
        self.encoder = AudioNTT2020Task6(
            n_mels=n_mels, d=d, return_all_layers=True, compute_dtype=compute_dtype
        )
        if num_classes:
            in_dim = d if finetune_layer == -1 else 64 * (n_mels // 2 ** (finetune_layer + 1))
            self.final = nn.Linear(in_dim, num_classes)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        l1, l2, l3, x = self.encoder(v)
        h = x.mean(dim=1) if self.finetune_layer == -1 else (l1, l2, l3)[self.finetune_layer]
        if self.num_classes == 0:
            return h
        return self.final(h)
