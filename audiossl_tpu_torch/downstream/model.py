"""Downstream encoder + linear head (port of audiossl_tpu.downstream.model).

AudioNTT2020Task6: ``finetune_layer == -1`` uses the final per-frame
features, pooled by their time MEAN (not max+mean); 0/1/2 use the per-block
taps (already time-pooled, dims 2048/1024/512 for 64 mels). EfficientNet-B0:
its 1280-d pooled features. MAST: the MViTv2 trunk's token mean, at
``input_fdim = n_mels`` and ``input_tdim`` frames. AST: the encoder's
(cls + dist) / 2 embedding. ``num_classes == 0`` drops the head and returns
the pooled embedding itself — the serving surface (serve/export.py).

``compute_dtype`` None keeps each encoder's default, as in JAX: AudioNTT and
MAST bf16, AST and EfficientNet f32. For AST a dtype reaches only the patch
conv (as in JAX); f32 also takes the attention operands to f32, so that f32
is IEEE f32 on the card, where the default attention operands are bf16.
``dropout_rate`` overrides AudioNTT's 0.3 dropout (0 gives a deterministic
fine-tune forward); ``patch_drop`` is AST's token drop; each raises for
another encoder, as in JAX.

In training mode MAST draws drop path and EfficientNet stochastic depth
from the ``generator`` of ``forward``, frozen or not, as JAX does under
``train=True``; ``draws``, an iterator of U(0, 1) [B] tensors in the
encoder's order, hands them in instead (the parity tests pass JAX's). The
other encoders take no ``draws``.
"""
from __future__ import annotations

import torch
from torch import nn

from audiossl_tpu_torch.models.ast import ASTEncoder
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6
from audiossl_tpu_torch.models.efficientnet import EfficientNetB0
from audiossl_tpu_torch.models.mast import MASTEncoder

ENCODER_TYPES = ("AudioNTT2020Task6", "Efficient_Net", "MAST", "AST")


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
        self.compute_dtype = compute_dtype
        if encoder_type == "AudioNTT2020Task6":
            kw = {} if dropout_rate is None else {"dropout_rate": dropout_rate}
            self.encoder = AudioNTT2020Task6(
                n_mels=n_mels, d=d, return_all_layers=True, compute_dtype=compute_dtype or torch.bfloat16, **kw
            )
            in_dim = d if finetune_layer == -1 else 64 * (n_mels // 2 ** (finetune_layer + 1))
        elif encoder_type == "Efficient_Net":
            if compute_dtype not in (None, torch.float32):
                raise ValueError("the EfficientNet encoder runs in f32, as in JAX")
            self.encoder = EfficientNetB0()
            in_dim = 1280
        elif encoder_type == "MAST":
            self.encoder = MASTEncoder(n_mels, input_tdim, model_size,
                                       compute_dtype=compute_dtype if compute_dtype is not None else torch.bfloat16)
            in_dim = self.encoder.embed_dim
        elif encoder_type == "AST":
            f32 = compute_dtype == torch.float32
            self.encoder = ASTEncoder(n_mels, input_tdim, model_size, patch_drop=patch_drop,
                                      attention_dtype=torch.float32 if f32 else None,
                                      compute_dtype=None if f32 else compute_dtype)
            in_dim = self.encoder.cfg.embed_dim
        else:
            raise NotImplementedError(f"unknown downstream encoder {encoder_type!r} (one of {ENCODER_TYPES})")
        if num_classes:
            self.final = nn.Linear(in_dim, num_classes)

    def forward(self, v: torch.Tensor, generator: torch.Generator | None = None, *, draws=None) -> torch.Tensor:
        """``generator`` carries the training-mode draws (AudioNTT's dropout,
        AST's patch drop, MAST's drop path, EfficientNet's stochastic
        depth); ``draws`` gives MAST's or EfficientNet's as tensors instead."""
        if self.encoder_type in ("MAST", "Efficient_Net"):
            h = self.encoder(v, generator, draws=draws)
        elif draws is not None:
            raise ValueError(f"the {self.encoder_type} encoder takes no draws")
        elif self.encoder_type == "AST":
            h = self.encoder(v, generator)
        else:
            l1, l2, l3, x = self.encoder(v, generator)
            h = x.mean(dim=1) if self.finetune_layer == -1 else (l1, l2, l3)[self.finetune_layer]
        if self.num_classes == 0:
            return h
        return self.final(h)
