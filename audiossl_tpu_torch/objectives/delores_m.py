"""DeLoRes-M: MoCo-v2 InfoNCE + per-layer Barlow decorrelation (port of
``audiossl_tpu.objectives.delores_m``).

Reference behaviour (src/upstream/delores_m/upstream_expert.py): query and
key AudioNTT encoders with layer taps, max+mean pooling and a Linear(d ->
contrastive_dim) head (``EncoderM``); the key encoder moved by the EMA
m·k + (1 − m)·q with m = 0.999 before the key pass, on the parameters only;
a 65536-key queue and InfoNCE at τ 0.07 against the queue as it was before
this step's keys are enqueued; and three Barlow projectors ``p1``–``p3`` on
the 2048 / 1024 / 512-d taps, each run on the query taps, then on the
stop-gradient key taps, so each projector's BatchNorm statistics move twice
a step, in that order.

The key pass runs in training mode under ``torch.no_grad()``: its BatchNorm
uses batch statistics and updates the key encoder's own running statistics
(JAX's ``batch_stats_k``), and block 1 runs the fused forward kernel with no
backward. The key encoder, the queue and its pointer are part of the
state_dict, so a checkpoint carries the whole MoCo state.

Across processes (parallel/dist.py), as in JAX under the ``data`` axis: the
queue takes the all-gathered keys of every process, in rank order; every
BatchNorm, the key tower's included, is SyncBN; the taps' Barlow losses sum
their cross-correlations over the group. ``pretrain.shuffle_bn`` (a
compatibility mode) also shuffles the key batch across processes by one
agreed permutation (rank 0's draw, broadcast; JAX's ``pmax`` of key bits)
before the key pass and unshuffles the embedding and the three taps after
it (the reference forgets the taps). With one process it changes nothing.

``info_nce`` and ``queue_update`` are shared with SLICER and SS-MAST;
``MocoObjective`` holds what DeLoRes-M and SLICER share (the key encoder
copy with its BatchNorm buffers, the EMA, the queue).
"""
from __future__ import annotations

from fractions import Fraction
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6, max_mean_pool
from audiossl_tpu_torch.models.heads import MLPProjector, barlow_loss
from audiossl_tpu_torch.objectives.api import Objective, register, sub_state_dict
from audiossl_tpu_torch.objectives.delores_s import DTYPES
from audiossl_tpu_torch.ops.stats import l2_normalize
from audiossl_tpu_torch.parallel import dist

# the taps' widths at 64 mels, which the JAX objectives hard-code
# (delores_m.py:147, unfused.py:86)
TAP_DIMS = (2048, 1024, 512)


def info_nce(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor, temperature: float) -> torch.Tensor:
    """Cross-entropy over [positive | queue negatives] logits with label 0;
    q, k [B, d], queue [d, N]; f32 products with TF32 off."""
    with no_tf32():
        l_pos = (q * k).sum(1, keepdim=True)
        l_neg = torch.matmul(q, queue)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return (torch.logsumexp(logits, dim=1) - logits[:, 0]).mean()


def queue_update(queue: torch.Tensor, ptr: torch.Tensor, keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write keys [B, d] into a copy of queue [d, N] at columns ptr .. ptr + B
    (dequeue-and-enqueue) -> (queue', (ptr + B) % N); across processes the
    keys are every process's, all-gathered in rank order (JAX
    delores_m.py:115-117), so B is the global batch. ``ptr`` stays a device
    tensor, so nothing waits for the card. The copy keeps the old queue intact
    for the backward of a loss that used it."""
    keys = dist.all_gather(keys)
    b, n = keys.shape[0], queue.shape[1]
    if n % b:
        # the reference asserts this too (upstream_expert.py:166)
        raise ValueError(f"num_negatives={n} must be divisible by the global batch {b} "
                         "(MoCo queue simplicity assert)")
    cols = ptr + torch.arange(b, device=queue.device)
    return queue.index_copy(1, cols, keys.T.to(queue.dtype)), (ptr + b) % n


def agreed_permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """A permutation of the group's n clips that every process holds: rank
    0's draw from its generator, broadcast (JAX agrees on one key by ``pmax``
    of the key bits)."""
    dev = generator.device
    perm = torch.randperm(n, generator=generator, device=dev) if dist.dp_rank() == 0 else \
        torch.empty(n, dtype=torch.long, device=dev)
    return dist.broadcast_from(perm)


def batch_shuffle(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """This process's share of the gathered batch permuted by ``perm``
    (MoCo shuffle-BN; JAX delores_m.py:92-105)."""
    return dist.all_gather(x)[perm.view(dist.dp_world(), -1)[dist.dp_rank()]]


def batch_unshuffle(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The inverse of ``batch_shuffle``: this process's own clips back."""
    return dist.all_gather(x)[torch.argsort(perm).view(dist.dp_world(), -1)[dist.dp_rank()]]


def parse_scale(scale: Any) -> float:
    """``loss_scale`` as a number or an "a/b" fraction string (the reference
    YAML writes "1/32"), without eval()."""
    if isinstance(scale, str):
        try:
            return float(Fraction(scale.strip()))
        except (ValueError, ZeroDivisionError) as e:
            raise ValueError(f"loss_scale must be a number or 'a/b' fraction, got {scale!r}") from e
    return float(scale)


def audiontt_kwargs(pre: dict[str, Any], name: str) -> dict[str, Any]:
    """AudioNTT's arguments from ``pretrain``: its mel count, the config's
    compute dtype (bf16 by default) and dropout (0.3 by default)."""
    enc = pre["base_encoder"]
    if str(enc.get("type", "AudioNTT2020Task6")) != "AudioNTT2020Task6":
        raise NotImplementedError(f"{name} on {enc['type']!r} is not ported (AudioNTT2020Task6 only)")
    return dict(
        n_mels=int(pre["input"]["n_mels"]), d=int(enc["output_dim"]),
        compute_dtype=DTYPES[str(enc.get("compute_dtype") or "bfloat16")],
        dropout_rate=float(enc["dropout"]) if enc.get("dropout") is not None else 0.3,
    )


def tapped_audiontt_kwargs(pre: dict[str, Any], name: str) -> dict[str, Any]:
    """``audiontt_kwargs`` for an objective with heads on AudioNTT's taps
    (DeLoRes-M, UnFuSeD): 64 mels only, since the JAX objectives fix the
    taps' widths at those of AudioNTT at 64 mels."""
    kw = audiontt_kwargs(pre, name)
    if kw["n_mels"] != 64:
        raise ValueError(
            f"{name} needs input.n_mels = 64, got {kw['n_mels']}: the JAX objective fixes its tap widths at "
            f"{TAP_DIMS}, the taps of AudioNTT at 64 mels"
        )
    return kw


class EncoderM(nn.Module):
    """DELORES_M's encoder (upstream_encoder.py:4-36): AudioNTT with taps ->
    max+mean pool -> f32 Linear(d -> contrastive_dim). -> (q, tap1, tap2, tap3)."""

    def __init__(self, contrastive_dim: int, **audiontt):
        super().__init__()
        self.encoder = AudioNTT2020Task6(return_all_layers=True, **audiontt)
        self.fc = nn.Linear(self.encoder.d, contrastive_dim)

    def forward(self, v: torch.Tensor, generator: torch.Generator | None = None):
        l1, l2, l3, x = self.encoder(v, generator)
        with no_tf32():
            q = F.linear(max_mean_pool(x), self.fc.weight, self.fc.bias)
        return q, l1, l2, l3


class MocoObjective(Objective):
    """A query encoder ``encoder``, its EMA copy ``encoder_k`` (no gradient,
    its own BatchNorm running statistics) and the key queue. Under
    ``run.fsdp`` the queue is sharded as SS-MAST's is: read whole where the
    logits use it, each enqueue writing the whole queue before this rank
    keeps its piece."""

    encoder: nn.Module
    encoder_k: nn.Module
    fsdp_buffers = ("queue",)

    def _init_moco(self, pre: dict[str, Any], emb_dim: int) -> None:
        self.emb_dim = emb_dim
        self.num_negatives = int(pre.get("num_negatives", 65536))
        self.momentum = float(pre.get("encoder_momentum", 0.999))
        self.temperature = float(pre.get("softmax_temperature", 0.07))
        self.shuffle_bn = bool(pre.get("shuffle_bn", False))  # acted on across processes (_key_pass)
        self.encoder_k.requires_grad_(False)
        self.register_buffer("queue", torch.zeros(emb_dim, self.num_negatives))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long))

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.encoder.encoder.compute_dtype

    @torch.no_grad()
    def init_state_(self, generator: torch.Generator) -> None:
        """The key encoder as a copy of the query encoder, its parameters and
        its BatchNorm buffers; the queue as normalised normal columns; the
        pointer at 0."""
        for pk, p in zip(self.encoder_k.parameters(), self.encoder.parameters()):
            pk.copy_(p)
        for bk, b in zip(self.encoder_k.buffers(), self.encoder.buffers()):
            bk.copy_(b)
        queue = torch.randn(self.emb_dim, self.num_negatives, generator=generator, device=generator.device)
        self.queue.copy_(queue / queue.norm(dim=0, keepdim=True))
        self.queue_ptr.zero_()

    @torch.no_grad()
    def _ema_(self) -> None:
        """key = m * key + (1 - m) * query on the parameters, in place."""
        pk = list(self.encoder_k.parameters())
        torch._foreach_mul_(pk, self.momentum)
        torch._foreach_add_(pk, list(self.encoder.parameters()), alpha=1.0 - self.momentum)

    def _key_pass(self, v: torch.Tensor, generator: torch.Generator | None) -> tuple:
        """The key encoder's outputs for ``v`` under ``no_grad``; with
        ``shuffle_bn`` across processes, on a batch shuffled by an agreed
        permutation and every output unshuffled."""
        with torch.no_grad():
            if not (self.shuffle_bn and dist.data_active()):
                return self.encoder_k(v, generator)
            perm = agreed_permutation(v.shape[0] * dist.dp_world(), generator)
            return tuple(batch_unshuffle(o, perm) for o in self.encoder_k(batch_shuffle(v, perm), generator))

    def _enqueue(self, keys: torch.Tensor) -> None:
        # new tensors: the backward of a loss that read the old queue keeps it
        queue, self.queue_ptr = queue_update(self._whole("queue"), self.queue_ptr, keys)
        self.queue = self._mine("queue", queue)

    def export_state_dict(self, sd: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """The query AudioNTT in the reference layout (JAX's
        ``encoder_variables``), which serving and the probe load unchanged;
        from this module or from its (dense) state_dict ``sd``."""
        return self.encoder.encoder.state_dict() if sd is None else sub_state_dict(sd, "encoder.encoder.")


@register("delores_m")
class DeloresM(MocoObjective):
    fsdp_units = ("encoder", "encoder_k", "p1", "p2", "p3")

    def __init__(self, config: dict[str, Any]):
        super().__init__()
        pre = config["pretrain"]
        kw = tapped_audiontt_kwargs(pre, "DeLoRes-M")
        emb = int(pre.get("contrastive_dim", 128))
        self.encoder = EncoderM(emb, **kw)
        self.encoder_k = EncoderM(emb, **kw)
        self._init_moco(pre, emb)
        self.lambdas = [float(v) for v in pre.get("lambda_barlow", [5e-5] * 3)]
        self.scale_loss = parse_scale(pre.get("loss_scale", "1/32"))
        # 2048 -> 2048 whatever projection_dim says, as JAX builds them (delores_m.py:159-161)
        for i, tap in enumerate(TAP_DIMS, 1):
            self.add_module(f"p{i}", MLPProjector(tap, 2048, 2048, compute_dtype=kw["compute_dtype"]))

    def loss(self, v1: torch.Tensor, v2: torch.Tensor, generator: torch.Generator | None = None,
             labels: torch.Tensor | None = None) -> torch.Tensor:
        """InfoNCE of v1's queries against v2's keys and the queue, plus the
        taps' Barlow losses; advances the key encoder, queue and pointer."""
        q, *q_taps = self.encoder(v1, generator)
        q = l2_normalize(q, dim=1)
        self._ema_()
        k, *k_taps = self._key_pass(v2, generator)
        k = l2_normalize(k, dim=1)
        nce = info_nce(q, k, self._whole("queue"), self.temperature)
        barlow = 0.0
        for i, (tq, tk) in enumerate(zip(q_taps, k_taps), 1):
            proj = getattr(self, f"p{i}")
            barlow = barlow + barlow_loss(proj(tq), proj(tk), self.lambdas[i - 1], self.scale_loss)
        self._enqueue(k)
        return nce + barlow
