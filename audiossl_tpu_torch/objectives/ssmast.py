"""SS-MAST: MoCo contrastive pretraining of the MAST spectrogram transformer
(port of ``audiossl_tpu.objectives.ssmast``).

Reference behaviour (src/upstream/ssmast/upstream_expert.py): query and key
``MASTWithHead`` encoders (MViTv2 trunk + Linear(d -> 256)), a 65536-key
queue, symmetric InfoNCE over both view orders, each enqueueing its keys
(training_step:316-340), the key encoder moved by the cosine momentum
m(e) = 1 - 0.5 (1 + cos(pi e / 200)) (1 - 0.99) at epoch e + 1, TWICE per
step (once inside each of the two forward calls, :268), and AdamW.

``batched_views`` (the default) encodes concat(v1, v2) in one query pass and
concat(v2, v1) in one key pass after both EMA steps, as the JAX package does;
``batched_views: false`` runs the reference's four sequential passes. The
key encoder's parameters take no gradient and are not the optimizer's; they,
the queue, its pointer and the step counter are part of the state_dict, so a
checkpoint carries the whole MoCo state. Both passes run in training mode
(drop path on), with draws from the step's generator. Not ported:
``grad_accum_steps > 1`` (ROADMAP.md Queue 1); shuffle-BN is a no-op for the
LayerNorm-only MAST on one device.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from audiossl_tpu_torch.models.convert import mvit_reference_layout
from audiossl_tpu_torch.models.mast import MASTWithHead
from audiossl_tpu_torch.objectives.api import Objective, register
from audiossl_tpu_torch.objectives.delores_m import info_nce, queue_update
from audiossl_tpu_torch.ops.stats import l2_normalize


def cosine_momentum(epoch: torch.Tensor, base: float = 0.99, total_epochs: int = 200) -> torch.Tensor:
    return 1.0 - 0.5 * (1.0 + torch.cos(math.pi * epoch / total_epochs)) * (1.0 - base)


@register("ssmast")
class SSMast(Objective):
    def __init__(self, config: dict[str, Any]):
        super().__init__()
        pre = config["pretrain"]
        self.emb_dim = int(pre.get("contrastive_dim", 256))
        self.num_negatives = int(pre.get("num_negatives", 65536))
        self.temperature = float(pre.get("softmax_temperature", 0.07))
        self.momentum_base = float(pre.get("encoder_momentum", 0.99))
        self.momentum_epochs = int(pre.get("momentum_total_epochs", 200))
        self.steps_per_epoch = int(pre.get("steps_per_epoch", 1000))
        self.batched_views = bool(pre.get("batched_views", True))
        if int(pre.get("grad_accum_steps", 1)) > 1:
            raise NotImplementedError("pretrain.grad_accum_steps > 1 is not ported yet (ROADMAP.md Queue 1)")
        inp = pre["input"]
        kw = dict(
            output_dim=self.emb_dim,
            input_fdim=int(inp.get("n_mels", 128)),
            input_tdim=int(inp.get("target_length", 1024)),
            model_size=str(pre.get("model_size", "base")),
            remat=bool(pre.get("remat", False)),
            compute_dtype=None if pre.get("compute_dtype") == "f32" else torch.bfloat16,  # None: the exact-f32 trunk
            droppath_rate=pre.get("droppath_rate"),
            fused_attention=str(pre.get("fused_attention", "auto")),
            pool_impl=str(pre.get("pool_impl", "conv")),
        )
        self.encoder = MASTWithHead(**kw)
        self.encoder_k = MASTWithHead(**kw).requires_grad_(False)
        self.register_buffer("queue", torch.zeros(self.emb_dim, self.num_negatives))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long))
        self.register_buffer("step", torch.zeros((), dtype=torch.long))

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.encoder.compute_dtype

    @torch.no_grad()
    def init_state_(self, generator: torch.Generator) -> None:
        """The key encoder as a copy of the query encoder, the queue as
        normalised normal columns, pointer and step at 0."""
        for pk, p in zip(self.encoder_k.parameters(), self.encoder.parameters()):
            pk.copy_(p)
        queue = torch.randn(self.emb_dim, self.num_negatives, generator=generator, device=generator.device)
        self.queue.copy_(queue / queue.norm(dim=0, keepdim=True))
        self.queue_ptr.zero_()
        self.step.zero_()

    def momentum(self) -> torch.Tensor:
        """m at this step's epoch + 1, a device scalar (no host sync)."""
        epoch = torch.div(self.step, self.steps_per_epoch, rounding_mode="floor") + 1
        return cosine_momentum(epoch.float(), self.momentum_base, self.momentum_epochs)

    @torch.no_grad()
    def _ema_(self, m: torch.Tensor) -> None:
        """key = m * key + (1 - m) * query, in place."""
        pk, p = list(self.encoder_k.parameters()), list(self.encoder.parameters())
        torch._foreach_mul_(pk, m)
        torch._foreach_add_(pk, torch._foreach_mul(p, 1.0 - m))

    def _keys(self, v: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        with torch.no_grad():
            return l2_normalize(self.encoder_k(v, generator), dim=1)

    def loss(self, v1: torch.Tensor, v2: torch.Tensor, generator: torch.Generator | None = None,
             labels: torch.Tensor | None = None) -> torch.Tensor:
        """The step's InfoNCE sum; advances the key encoder, queue, pointer and step."""
        m = self.momentum()
        queue, ptr = self.queue, self.queue_ptr
        if self.batched_views:
            b = v1.shape[0]
            self._ema_(m)
            self._ema_(m)
            q12 = l2_normalize(self.encoder(torch.cat([v1, v2]), generator), dim=1)
            k21 = self._keys(torch.cat([v2, v1]), generator)
            total = info_nce(q12[:b], k21[:b], queue, self.temperature)
            queue, ptr = queue_update(queue, ptr, k21[:b])
            total = total + info_nce(q12[b:], k21[b:], queue, self.temperature)
            queue, ptr = queue_update(queue, ptr, k21[b:])
        else:
            total = 0.0
            for vq, vk in ((v1, v2), (v2, v1)):
                self._ema_(m)  # reference-exact: one EMA application per forward pass
                q = l2_normalize(self.encoder(vq, generator), dim=1)
                k = self._keys(vk, generator)
                total = total + info_nce(q, k, queue, self.temperature)
                queue, ptr = queue_update(queue, ptr, k)
        self.queue, self.queue_ptr = queue, ptr  # new tensors: the loss's backward keeps the old queue
        self.step.add_(1)
        return total

    def export_state_dict(self) -> dict[str, torch.Tensor]:
        """The MAST trunk (no head) in the reference's freq-major layout."""
        return mvit_reference_layout(self.encoder.mast.state_dict())
