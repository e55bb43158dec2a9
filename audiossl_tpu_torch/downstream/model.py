"""Downstream encoder + linear head (port of audiossl_tpu.downstream.model).

AudioNTT2020Task6: ``finetune_layer == -1`` uses the final per-frame
features, pooled by their time MEAN (not max+mean); 0/1/2 use the per-block
taps (already time-pooled, dims 2048/1024/512 for 64 mels). AST: the
encoder's (cls + dist) / 2 embedding. ``num_classes == 0`` drops the head
and returns the pooled embedding itself — the serving surface
(serve/export.py).

``compute_dtype`` is AudioNTT's (None: its bf16 default, as in JAX); AST
runs in f32, as the JAX probe builds it. ``dropout_rate``
overrides AudioNTT's 0.3 dropout (0 gives a deterministic fine-tune
forward); ``patch_drop`` is AST's token drop; each raises for the other
encoder, as in JAX. The MAST and EfficientNet encoders raise until their
items land (ROADMAP.md Queue 1, items 2 and 8).
"""
from __future__ import annotations

import torch
from torch import nn

from audiossl_tpu_torch.models.ast import ASTEncoder
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
        compute_dtype: torch.dtype | None = None,
        input_tdim: int = 96,
        model_size: str = "base",
        dropout_rate: float | None = None,
        patch_drop: float = 0.0,
    ):
        super().__init__()
        if patch_drop > 0.0 and encoder_type != "AST":
            raise ValueError(f"patch_drop is AST-only (plain-ViT tokens); {encoder_type!r} cannot drop tokens")
        if dropout_rate is not None and encoder_type != "AudioNTT2020Task6":
            raise ValueError(f"the dropout_rate override applies to the AudioNTT encoder only, not {encoder_type!r}")
        self.encoder_type = encoder_type
        self.finetune_layer = finetune_layer
        self.num_classes = num_classes
        if encoder_type == "AudioNTT2020Task6":
            kw = {} if dropout_rate is None else {"dropout_rate": dropout_rate}
            self.encoder = AudioNTT2020Task6(
                n_mels=n_mels, d=d, return_all_layers=True, compute_dtype=compute_dtype or torch.bfloat16, **kw
            )
            in_dim = d if finetune_layer == -1 else 64 * (n_mels // 2 ** (finetune_layer + 1))
        elif encoder_type == "AST":
            if compute_dtype is not None:
                raise ValueError("compute_dtype applies to the AudioNTT encoder; AST runs in f32")
            self.encoder = ASTEncoder(n_mels, input_tdim, model_size, patch_drop=patch_drop)
            in_dim = self.encoder.cfg.embed_dim
        else:
            raise NotImplementedError(
                f"encoder {encoder_type!r} is not ported yet; AudioNTT2020Task6 and AST are "
                "(ROADMAP.md Queue 1: MAST is item 2, Efficient_Net item 8)"
            )
        if num_classes:
            self.final = nn.Linear(in_dim, num_classes)

    def forward(self, v: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` carries the training-mode draws (AudioNTT's dropout,
        AST's patch drop)."""
        if self.encoder_type == "AST":
            h = self.encoder(v, generator)
        else:
            l1, l2, l3, x = self.encoder(v, generator)
            h = x.mean(dim=1) if self.finetune_layer == -1 else (l1, l2, l3)[self.finetune_layer]
        if self.num_classes == 0:
            return h
        return self.final(h)
