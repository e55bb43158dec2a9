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
(drop path on), with draws from the step's generator.

Across processes (parallel/dist.py) every enqueue takes the all-gathered
keys of the data axis in rank order, as JAX's ``queue_update`` does; under
tensor parallelism (``pretrain.tp``, parallel/tp_mvit.py) both towers hold
this rank's shards, the EMA runs shard by shard, and the queue stays whole
on every rank. Under ``run.fsdp`` (parallel/fsdp.py, the layout kept as
``fsdp_shards``) the two towers and the queue (``fsdp_buffers``, [emb, K]
split on K when JAX's rule splits it) hold this rank's pieces between
steps, as JAX's ``tree_shardings`` leaves them: each MViT block, and each
tower's other weights (``fsdp_units``), are gathered around their forward,
the EMA runs piece by piece, the queue is gathered where the
logits use it and each enqueue writes the data axis's keys, in rank order,
into the whole queue before this rank keeps its piece; the pointer is the
same on every rank. With
``pretrain.shuffle_bn`` there the step takes the sequential path (JAX
excludes the batched views under shuffle-BN, ssmast.py:126) and each key
pass runs on the batch shuffled across the data axis by an agreed permutation,
unshuffled after; MAST has no batch statistics, so this moves only which
clip takes which drop-path draw. On one process shuffle-BN changes nothing.

``pretrain.grad_accum_steps: A`` (``loss_and_backward``) runs the batch as A
microbatches with one microbatch's activations live at a time, exact
against A = 1 for both view paths (JAX's ``SSMast.value_and_grad``): with
batched views all A key passes run first and build the two queue snapshots
of the whole batch, then each microbatch's query pass runs forward and
backward against them; with sequential views each pass applies one EMA,
runs its microbatches against the queue it started from, and enqueues all
its keys in batch order.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from audiossl_tpu_torch.models.convert import mvit_reference_layout
from audiossl_tpu_torch.models.mast import MASTWithHead
from audiossl_tpu_torch.objectives.api import Objective, register
from audiossl_tpu_torch.objectives.delores_m import (agreed_permutation, batch_shuffle, batch_unshuffle, info_nce,
                                                     queue_update)
from audiossl_tpu_torch.ops.stats import l2_normalize
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.train.accum import microbatched_value_and_grad, set_grads, split_batch


def cosine_momentum(epoch: torch.Tensor, base: float = 0.99, total_epochs: int = 200) -> torch.Tensor:
    return 1.0 - 0.5 * (1.0 + torch.cos(math.pi * epoch / total_epochs)) * (1.0 - base)


@register("ssmast")
class SSMast(Objective):
    fsdp_units = ("encoder", "encoder.mast.blocks.*", "encoder_k", "encoder_k.mast.blocks.*")
    fsdp_buffers = ("queue",)

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
        self.grad_accum = max(1, int(pre.get("grad_accum_steps", 1)))
        self.shuffle_bn = bool(pre.get("shuffle_bn", False))
        if self.grad_accum > 1 and self.shuffle_bn:
            raise ValueError("pretrain.grad_accum_steps > 1 is incompatible with shuffle_bn")
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

    def _keys(self, v: torch.Tensor, generator: torch.Generator | None, shuffle: bool = False) -> torch.Tensor:
        with torch.no_grad():
            if not shuffle:
                return l2_normalize(self.encoder_k(v, generator), dim=1)
            perm = agreed_permutation(v.shape[0] * dist.dp_world(), generator)
            return l2_normalize(batch_unshuffle(self.encoder_k(batch_shuffle(v, perm), generator), perm), dim=1)

    def loss(self, v1: torch.Tensor, v2: torch.Tensor, generator: torch.Generator | None = None,
             labels: torch.Tensor | None = None) -> torch.Tensor:
        """The step's InfoNCE sum; advances the key encoder, queue, pointer and step."""
        m = self.momentum()
        queue, ptr = self._whole("queue"), self.queue_ptr
        shuffle = self.shuffle_bn and dist.data_active()
        if self.batched_views and not shuffle:
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
                k = self._keys(vk, generator, shuffle)
                total = total + info_nce(q, k, queue, self.temperature)
                queue, ptr = queue_update(queue, ptr, k)
        self.queue, self.queue_ptr = self._mine("queue", queue), ptr  # new tensors: the backward keeps the old queue
        self.step.add_(1)
        return total

    def loss_and_backward(self, v1: torch.Tensor, v2: torch.Tensor, generator: torch.Generator | None = None,
                          labels: torch.Tensor | None = None) -> torch.Tensor:
        """The step's loss (detached), its gradients left on the query
        encoder's parameters, the MoCo state advanced; A = grad_accum_steps
        microbatches at a time (one forward and one backward at A = 1).
        Raises JAX's ValueError for a batch that A does not divide."""
        accum = self.grad_accum
        if accum == 1:
            loss = self.loss(v1, v2, generator)
            loss.backward()
            return loss.detach()
        b = v1.shape[0]
        if b % accum:
            raise ValueError(f"per-chip batch {b} not divisible by pretrain.grad_accum_steps {accum}")
        mb = b // accum
        params = list(self.encoder.parameters())
        m = self.momentum()
        queue0 = queue = self._whole("queue")
        ptr = self.queue_ptr
        tau = self.temperature
        query = lambda v: l2_normalize(self.encoder(v, generator), dim=1)  # noqa: E731
        if self.batched_views:
            self._ema_(m)
            self._ema_(m)
            # the key passes first (no gradient), then the queue snapshots of
            # the whole batch: pass 1 against the initial queue, pass 2 against
            # the queue after pass 1's keys (microbatches are contiguous slices)
            ks = [self._keys(torch.cat([v2j, v1j]), generator) for v1j, v2j in split_batch((v1, v2), accum)]
            q1, p1 = queue_update(queue, ptr, torch.cat([k[:mb] for k in ks]))
            queue, ptr = queue_update(q1, p1, torch.cat([k[mb:] for k in ks]))

            def micro_loss(views, j):
                q12 = query(torch.cat(views))
                return info_nce(q12[:mb], ks[j][:mb], queue0, tau) + info_nce(q12[mb:], ks[j][mb:], q1, tau)

            total, grads = microbatched_value_and_grad(micro_loss, accum)(params, (v1, v2))
        else:
            total, grads = 0.0, None
            for vq, vk in ((v1, v2), (v2, v1)):
                self._ema_(m)  # one EMA application per pass
                fixed, ks = queue, []

                def micro_loss(views, j, fixed=fixed, ks=ks):
                    ks.append(self._keys(views[1], generator))
                    return info_nce(query(views[0]), ks[-1], fixed, tau)

                loss, g = microbatched_value_and_grad(micro_loss, accum)(params, (vq, vk))
                total = total + loss
                grads = g if grads is None else [a + c for a, c in zip(grads, g)]
                queue, ptr = queue_update(queue, ptr, torch.cat(ks))  # bulk enqueue in batch order
        set_grads(params, grads)
        self.queue, self.queue_ptr = self._mine("queue", queue), ptr  # new tensors: the backward keeps the old queue
        self.step.add_(1)
        return total

    def export_state_dict(self, sd: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """The MAST trunk (no head) in the reference's freq-major layout, from
        this module or from its (dense) state_dict ``sd``."""
        if sd is None:
            return mvit_reference_layout(self.encoder.mast.state_dict())
        head = "encoder.mast."
        return mvit_reference_layout({k[len(head):]: v for k, v in sd.items() if k.startswith(head)})
