"""SLICER: symmetric MoCo InfoNCE + cluster-contrastive loss (port of
``audiossl_tpu.objectives.slicer``).

Reference behaviour (src/upstream/slicer/upstream_expert.py:180-237, the
SLICER encoder of upstream_encoder.py:4-36 and ClusterLoss of
extras/slicer/contrastive_loss.py:45-92): AudioNTT -> max+mean pool -> an
f32 Linear instance head and an f32 MLP + softmax cluster head, on a query
encoder and its EMA key encoder (m = 0.999), with a 65536-key queue. A step
runs two directions, (v1 -> v2) then (v2 -> v1); each applies the EMA once,
runs the query pass, the key pass and InfoNCE, and enqueues its keys, so the
second direction's InfoNCE sees the queue after the first's enqueue, and
the query encoder's BatchNorm statistics move on v1, then on v2, in one
autograd graph.

The loss is ce_12 + ce_21 + the cluster loss of the two query passes'
assignments, the JAX package's combined loss (the reference backpropagates
only ce_12, upstream_expert.py:237; JAX's choice is kept). Across
processes the queue takes every process's keys and the BatchNorms are SyncBN;
``shuffle_bn`` shuffles each key pass's batch across them
(``MocoObjective._key_pass``) and changes nothing on one process.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6, max_mean_pool
from audiossl_tpu_torch.models.heads import ClusterProjector
from audiossl_tpu_torch.objectives.api import register
from audiossl_tpu_torch.objectives.delores_m import MocoObjective, audiontt_kwargs, info_nce
from audiossl_tpu_torch.ops.stats import l2_normalize


class EncoderSlicer(nn.Module):
    """AudioNTT -> max+mean pool -> (f32 instance embedding, f32 cluster assignment)."""

    def __init__(self, instance_dim: int, cluster_dim: int, **audiontt):
        super().__init__()
        self.encoder = AudioNTT2020Task6(**audiontt)
        d = self.encoder.d
        self.instance_projector = nn.Linear(d, instance_dim)
        self.cluster_projector = ClusterProjector(d, d, cluster_dim)

    def forward(self, v: torch.Tensor, generator: torch.Generator | None = None):
        x = max_mean_pool(self.encoder(v, generator))
        with no_tf32():
            inst = F.linear(x, self.instance_projector.weight, self.instance_projector.bias)
        return inst, self.cluster_projector(x)


def _pair_logits(z: torch.Tensor, half: int, temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """For rows z [2h, ·]: (the positive logit of each row, its pair at
    distance h; the logits [positive | the other 2h − 2 rows, self and
    positive at −inf]), from z zᵀ / temperature in f32 with TF32 off."""
    with no_tf32():
        sim = z @ z.T / temperature
    n = z.shape[0]
    idx = torch.arange(n, device=z.device)
    pair = (idx + half) % n
    pos = sim[idx, pair]
    mask = torch.zeros((n, n), dtype=torch.bool, device=z.device)
    mask[idx, idx] = True
    mask[idx, pair] = True
    return pos, torch.cat([pos[:, None], sim.masked_fill(mask, float("-inf"))], dim=1)


def instance_loss(z_i: torch.Tensor, z_j: torch.Tensor, temperature: float = 0.5) -> torch.Tensor:
    """SimCLR-style instance loss (extras/slicer/contrastive_loss.py:6-42):
    2B-way contrast over raw dot products, the CE summed over 2B rows / 2B."""
    pos, logits = _pair_logits(torch.cat([z_i, z_j]), z_i.shape[0], temperature)
    return (torch.logsumexp(logits, dim=1) - pos).sum() / logits.shape[0]


def cluster_loss(c_i: torch.Tensor, c_j: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """ClusterLoss.forward: the K columns of the two views' [B, K] softmax
    assignments contrasted as prototypes by cosine similarity; the entropy
    term stays out of the loss, as in the reference."""
    c = torch.cat([c_i.T, c_j.T])  # [2K, B]
    cn = c / c.norm(dim=1, keepdim=True).clamp_min(1e-8)
    pos, logits = _pair_logits(cn, c_i.shape[1], temperature)
    return (torch.logsumexp(logits, dim=1) - pos).sum() / logits.shape[0]


@register("slicer")
class Slicer(MocoObjective):
    def __init__(self, config: dict[str, Any]):
        super().__init__()
        pre = config["pretrain"]
        kw = audiontt_kwargs(pre, "SLICER")
        emb = int(pre.get("instance_contrastive_dim", 128))
        clusters = int(pre.get("cluster_contrastive_dim", 128))
        self.encoder = EncoderSlicer(emb, clusters, **kw)
        self.encoder_k = EncoderSlicer(emb, clusters, **kw)
        self._init_moco(pre, emb)
        self.cluster_temperature = float(pre.get("cluster_temperature", 1.0))

    def _one_direction(self, vq: torch.Tensor, vk: torch.Tensor, generator: torch.Generator | None):
        q, q_clus = self.encoder(vq, generator)
        q = l2_normalize(q, dim=1)
        self._ema_()
        k = l2_normalize(self._key_pass(vk, generator)[0], dim=1)
        ce = info_nce(q, k, self.queue, self.temperature)
        self._enqueue(k)
        return ce, q_clus

    def loss(self, v1: torch.Tensor, v2: torch.Tensor, generator: torch.Generator | None = None,
             labels: torch.Tensor | None = None) -> torch.Tensor:
        """ce_12 + ce_21 + cluster loss; advances the key encoder (twice),
        the queue and its pointer (by 2B)."""
        ce_a, clus_a = self._one_direction(v1, v2, generator)
        ce_b, clus_b = self._one_direction(v2, v1, generator)
        return ce_a + ce_b + cluster_loss(clus_a, clus_b, self.cluster_temperature)
