"""DeLoRes-S: one shared encoder + Barlow-Twins decorrelation (port of
``audiossl_tpu.objectives.delores_s``).

Reference behaviour (src/upstream/delores_s/upstream_expert.py:191-203):
both views through one AudioNTT encoder (view 1 then view 2, each updating
the BatchNorm running statistics in turn), max+mean temporal pooling, a
d -> P -> P -> P projector, and the Barlow loss with lambda 5e-5 and scale
1/32. Across processes the BatchNorms are SyncBN and the cross-correlation
is summed over the group (models/heads.py), as in JAX. With
``base_encoder.type: Efficient_Net`` (the EfficientNet-Barlow variant,
extras/delores-s/models.py:7-40) the encoder is EfficientNet-B0 and its
pooled 1280-d features go straight into the projector. Under ``run.fsdp``
the encoder and the projector are the gathering units.
"""
from __future__ import annotations

from typing import Any

import torch

from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6, max_mean_pool
from audiossl_tpu_torch.models.efficientnet import EfficientNetB0
from audiossl_tpu_torch.models.heads import MLPProjector, barlow_loss
from audiossl_tpu_torch.objectives.api import Objective, register, sub_state_dict

DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16, "float32": torch.float32, "f32": torch.float32}


@register("delores_s")
class DeloresS(Objective):
    fsdp_units = ("encoder", "projector")

    def __init__(self, config: dict[str, Any]):
        super().__init__()
        pre = config["pretrain"]
        enc = pre["base_encoder"]
        self.encoder_type = str(enc.get("type", "AudioNTT2020Task6"))
        if self.encoder_type not in ("AudioNTT2020Task6", "Efficient_Net"):
            raise NotImplementedError(f"DeLoRes-S supports AudioNTT2020Task6 | Efficient_Net, got {self.encoder_type!r}")
        self.lambd = float(pre.get("lambda_barlow", 5e-5) or 0.0)
        self.scale_loss = 1.0 / 32.0
        dtype = DTYPES[str(enc.get("compute_dtype") or "bfloat16")]
        proj = int(pre.get("projection_dim", 2048))
        if self.encoder_type == "Efficient_Net":
            self.encoder = EfficientNetB0()
            d = EfficientNetB0.out_dim
        else:
            d = int(enc["output_dim"])
            self.encoder = AudioNTT2020Task6(
                n_mels=int(pre["input"]["n_mels"]), d=d, compute_dtype=dtype,
                dropout_rate=float(enc["dropout"]) if enc.get("dropout") is not None else 0.3,
            )
        self.projector = MLPProjector(d, proj, proj, compute_dtype=dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.projector.compute_dtype

    def embed(self, v: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if self.encoder_type == "Efficient_Net":
            return self.projector(self.encoder(v, generator))
        return self.projector(max_mean_pool(self.encoder(v, generator)))

    def export_state_dict(self, sd: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """The encoder in the reference layout (what checkpoints export), from
        this module or from its (dense) state_dict ``sd``."""
        return self.encoder.state_dict() if sd is None else sub_state_dict(sd, "encoder.")

    def loss(self, v1: torch.Tensor, v2: torch.Tensor, generator: torch.Generator | None = None,
             labels: torch.Tensor | None = None) -> torch.Tensor:
        return barlow_loss(self.embed(v1, generator), self.embed(v2, generator), self.lambd, self.scale_loss)
