"""DECAR-v2 (DeepCluster-v2): online k-means pseudo-labels (port of
``audiossl_tpu.objectives.decar``).

Reference behaviour (extras/decar-v2):
  * model: AudioNTT (d = 512) -> max+mean pool -> projection head
    (512 -> 2048 -> BN -> ReLU -> feat_dim) + bias-free prototype layers
    (models_delores.py:80-122);
  * each epoch: spherical k-means over an embedding memory bank
    (utils.py:276-346 ``cluster_memory``), the centroids copied into the
    prototype weights;
  * each step: CE(prototype scores / T, assignments[idx]) with ignore
    index -100, the prototype gradients zeroed for the first
    ``freeze_prototypes_niters`` steps, the bank refreshed with the
    detached view-1 embeddings (main.py:216-291).

Across processes each holds its shard of the bank and ``kmeans_on_mesh``
runs the JAX package's collectives: the initial centroids from rank 0's
shard (broadcast), the counts and sums summed over the group each
iteration, and every shard's assignments and indices gathered; with one
process it is the shard of one. The k-means products run
in f32 with TF32 off (the JAX package's Precision.HIGHEST); ``argmax`` ties
take the first index on both sides. The initial centroids' pick comes in as
an argument. The head runs in f32: BN on batch statistics with running
statistics 0.9 / 0.1 (flax's momentum 0.9), as the encoder's.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6, batch_norm_train, max_mean_pool
from audiossl_tpu_torch.objectives.api import Objective, register
from audiossl_tpu_torch.objectives.delores_s import DTYPES
from audiossl_tpu_torch.parallel import dist

IGNORE_INDEX = -100


class DecarNet(nn.Module):
    """Encoder + projection head + prototype layers: [B, 1, F, T] ->
    (embedding [B, feat_dim], [scores [B, K] per prototype head])."""

    def __init__(self, n_mels: int = 64, d: int = 512, feat_dim: int = 128, nmb_prototypes: Sequence[int] = (1024,),
                 compute_dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.3):
        super().__init__()
        self.encoder = AudioNTT2020Task6(n_mels=n_mels, d=d, compute_dtype=compute_dtype, dropout_rate=dropout_rate)
        self.proj_fc1 = nn.Linear(d, 2048)
        self.proj_bn = nn.BatchNorm1d(2048, eps=1e-5)
        self.proj_fc2 = nn.Linear(2048, feat_dim)
        self.nmb_prototypes = tuple(int(k) for k in nmb_prototypes)
        for i, k in enumerate(self.nmb_prototypes):
            self.add_module(f"prototypes{i}", nn.Linear(feat_dim, k, bias=False))

    def prototypes(self) -> list[nn.Linear]:
        return [getattr(self, f"prototypes{i}") for i in range(len(self.nmb_prototypes))]

    def forward(self, v: torch.Tensor, generator: torch.Generator | None = None):
        z = max_mean_pool(self.encoder(v, generator))
        with no_tf32():
            z = F.linear(z, self.proj_fc1.weight, self.proj_fc1.bias)
            if self.training:
                z = batch_norm_train(self.proj_bn, z)
            else:
                bn = self.proj_bn
                z = F.batch_norm(z, bn.running_mean, bn.running_var, bn.weight, bn.bias, eps=bn.eps)
            emb = F.linear(F.relu(z), self.proj_fc2.weight, self.proj_fc2.bias)
            return emb, [F.linear(emb, p.weight) for p in self.prototypes()]


def memory_update(mem_emb: torch.Tensor, mem_idx: torch.Tensor, emb: torch.Tensor, idx: torch.Tensor,
                  step_in_epoch: int) -> None:
    """Write the batch's embeddings and dataset indices at the epoch's
    sequential slots (step * B + arange(B)) mod M, in place (main.py:246-250)."""
    b, m = emb.shape[0], mem_emb.shape[0]
    slots = (step_in_epoch * b + torch.arange(b, device=mem_emb.device)) % m
    mem_emb[slots] = emb.detach().to(mem_emb.dtype)
    mem_idx[slots] = idx.to(mem_idx.dtype)


def kmeans_on_mesh(mem_emb: torch.Tensor, mem_idx: torch.Tensor, n_total: int, k: int, pick: torch.Tensor,
                   n_iters: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means over the bank -> (centroids [k, D], assignments
    [n_total], -100 for a clip no filled slot holds). ``pick`` [k] are the
    bank slots of the initial centroids (the JAX package's
    ``permutation(key, M)[:k]``). Only filled slots (index >= 0) count in
    the M-step; an empty cluster keeps its centroid."""
    m = mem_emb.shape[0]
    if k > m:
        raise ValueError(f"nmb_prototypes={k} exceeds per-shard memory {m}; reduce the number "
                         "of centroids (reference assert, utils.py:287)")
    valid = mem_idx >= 0
    cents = dist.broadcast_from(mem_emb[pick.to(mem_emb.device)])  # rank 0's shard (JAX: a masked psum)
    arange_k = torch.arange(k, device=mem_emb.device)
    with no_tf32():
        for _ in range(n_iters):
            assign = (mem_emb @ cents.T).argmax(dim=1)
            onehot = ((assign[:, None] == arange_k[None, :]) & valid[:, None]).to(mem_emb.dtype)
            counts = dist.all_reduce_sum(onehot.sum(dim=0), "kmeans")
            sums = dist.all_reduce_sum(onehot.T @ mem_emb, "kmeans")
            cents = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], cents)
            cents = cents / torch.linalg.vector_norm(cents, dim=1, keepdim=True).clamp_min(1e-12)
        assign = (mem_emb @ cents.T).argmax(dim=1)
    all_assign, all_idx = dist.all_gather(assign), dist.all_gather(mem_idx)
    assignments = torch.full((n_total + 1,), IGNORE_INDEX, dtype=torch.long, device=mem_emb.device)
    # unfilled slots land in the dropped last entry
    assignments[torch.where(all_idx >= 0, all_idx.long(), n_total)] = all_assign
    return cents, assignments[:n_total]


def decar_ce(scores: torch.Tensor, targets: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """CE over the rows whose target is not -100, summed and divided by
    max(#kept, 1): 0 when every target is -100 (``F.cross_entropy`` with
    ``ignore_index`` gives NaN there)."""
    logits = scores.float() / temperature
    keep = targets != IGNORE_INDEX
    safe = torch.where(keep, targets, 0).long()
    nll = torch.logsumexp(logits, dim=1) - logits.gather(1, safe[:, None])[:, 0]
    return torch.where(keep, nll, 0.0).sum() / keep.sum().clamp_min(1)


@register("decar_v2")
class DecarV2(Objective):
    """Config keys (pretrain.*): feat_dim, nmb_prototypes, temperature,
    freeze_prototypes_niters, kmeans_iters, base_encoder.output_dim (512)
    and, as every AudioNTT objective, base_encoder.compute_dtype and
    dropout. ``labeled``: the batches carry dataset indices, which the
    trainer turns into the epoch's cluster targets."""

    labeled = True

    def __init__(self, config: dict[str, Any]):
        super().__init__()
        pre = config["pretrain"]
        enc = pre["base_encoder"]
        if str(enc.get("type", "AudioNTT2020Task6")) != "AudioNTT2020Task6":
            raise NotImplementedError(f"DECAR on {enc['type']!r} is not ported (AudioNTT2020Task6 only)")
        self.nmb_prototypes = tuple(int(k) for k in pre.get("nmb_prototypes", [1024]))
        self.temperature = float(pre.get("temperature", 1.0))
        self.freeze_niters = int(pre.get("freeze_prototypes_niters", 300))
        self.kmeans_iters = int(pre.get("kmeans_iters", 10))
        self.feat_dim = int(pre.get("feat_dim", 128))
        self.net = DecarNet(
            n_mels=int(pre["input"]["n_mels"]), d=int(enc.get("output_dim", 512)), feat_dim=self.feat_dim,
            nmb_prototypes=self.nmb_prototypes, compute_dtype=DTYPES[str(enc.get("compute_dtype") or "bfloat16")],
            dropout_rate=float(enc["dropout"]) if enc.get("dropout") is not None else 0.3,
        )

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.net.encoder.compute_dtype

    def step_loss(self, v1: torch.Tensor, v2: torch.Tensor, targets: Sequence[torch.Tensor],
                  generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss, view 1's embeddings). View 1's pass moves the BatchNorm
        running statistics and gives the bank its embeddings, without
        gradient; view 2's pass, on the statistics view 1 left, gives the
        scores: the mean over heads of ``decar_ce`` against ``targets[h]``
        (models_delores.py:101-122's forward contract)."""
        with torch.no_grad():
            emb, _ = self.net(v1, generator)
        _, scores = self.net(v2, generator)
        loss = sum(decar_ce(s, t, self.temperature) for s, t in zip(scores, targets)) / len(scores)
        return loss, emb

    @torch.no_grad()
    def set_prototypes(self, centroids: Sequence[torch.Tensor]) -> None:
        """Copy the k-means centroids into the prototype weights (utils.py:320)."""
        for p, c in zip(self.net.prototypes(), centroids):
            p.weight.copy_(c)

    def freeze_prototype_grads(self, step: int) -> None:
        """Zero (not drop) the prototypes' gradients while step <
        freeze_prototypes_niters, as the JAX package does: the optimizer
        still sees them, so LARC's weight decay still reaches the momentum."""
        if step < self.freeze_niters:
            for p in self.net.prototypes():
                if p.weight.grad is None:
                    p.weight.grad = torch.zeros_like(p.weight)
                else:
                    p.weight.grad.zero_()

    def export_state_dict(self) -> dict[str, torch.Tensor]:
        """The AudioNTT in the reference layout (JAX's ``encoder_variables``)."""
        return self.net.encoder.state_dict()
