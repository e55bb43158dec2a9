"""Training steps from the same weights, inputs and random draws as the
program's, each rebuilt from its definition: SS-MAST (MoCo v3-style InfoNCE
over a 65536-key queue with a momentum key encoder, Zhu and Omar,
arXiv:2211.01515, on MAST's waveform mixup, Kaldi fbank, SpecMask and
dataset normalisation), the downstream fine-tune (log-mel, encoder, linear
head, cross-entropy), and Adam / AdamW (Kingma and Ba; Loshchilov and Hutter)
as PyTorch defines them.

The batch runs in blocks of rows (``block``) so that a float32 step at the
timed batch fits beside nothing else: each block's share of the loss is
back-propagated on its own and the gradients summed, which is the whole
batch's gradient because every loss here is a mean of per-row terms.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import frontend as ref_frontend
from portbench.reference.encoders import mast as ref_mast
from portbench.reference.models import encoder_forward, linear, sub
from portbench.reference.precision import Precision

MIXUP_BETA = 10


def adam_update_(params: dict, grads: dict, state: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True) -> None:
    """One Adam (``decoupled=False``) or AdamW step in place, as torch.optim defines them."""
    b1, b2 = betas
    state["t"] = t = state.get("t", 0) + 1
    for name, p in params.items():
        g = grads[name]
        if weight_decay and decoupled:
            p.mul_(1.0 - lr * weight_decay)
        elif weight_decay:
            g = g + weight_decay * p
        m = state.setdefault(("m", name), torch.zeros_like(p))
        v = state.setdefault(("v", name), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + eps * eps)


# ---------------------------------------------------------------- SS-MAST


class SSMastDraws:
    """The draws of one SS-MAST step, made by the same calls on a generator
    set to the program's state at the step's start: the waveform mixup's
    gate, partner and Beta(10, 10) weight; each view's SpecMask spans
    (frequency, then time); two drop-path U(0, 1) per block whose rate is
    above 0, for the query pass over 2B rows, then for the key pass."""

    def __init__(self, gen: torch.Generator, b: int, n_mels: int, n_frames: int, mixup_rate: float,
                 freq_param: int, time_param: int, n_drop_blocks: int):
        dev = gen.device
        self.gate = torch.rand(b, generator=gen, device=dev) < mixup_rate
        self.partner = torch.randint(0, b, (b,), generator=gen, device=dev)
        e = -torch.log1p(-torch.rand((b, 2 * MIXUP_BETA), generator=gen, device=dev, dtype=torch.float64))
        x = e[:, :MIXUP_BETA].sum(1)
        self.lam = (x / (x + e[:, MIXUP_BETA:].sum(1))).float()
        self.masks = []
        for _ in range(2):
            spans = []
            for size, param in ((n_mels, freq_param), (n_frames, time_param)):
                width = torch.randint(0, param + 1, (b,), generator=gen, device=dev)
                hi = (size - width).clamp_min(0)
                start = torch.minimum((torch.rand(b, generator=gen, device=dev) * (hi + 1)).long(), hi)
                spans.append((start, width))
            self.masks.append(spans)
        self.query = [torch.rand(2 * b, generator=gen, device=dev) for _ in range(2 * n_drop_blocks)]
        self.key = [torch.rand(2 * b, generator=gen, device=dev) for _ in range(2 * n_drop_blocks)]


def ssmast_views(waves: torch.Tensor, d: SSMastDraws, cfg: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """waves [B, L] -> two views [B, 1, F, T]: mean-centred waves mixed with
    a batch partner where the gate is set (and centred again), the Kaldi
    fbank padded to ``target_length``, then per view the SpecMask spans
    filled with 0 and (x - mean) / (2 std)."""
    w = waves.float() - waves.float().mean(-1, keepdim=True)
    lam = d.lam[:, None]
    mixed = lam * w + (1.0 - lam) * w[d.partner]
    mixed = mixed - mixed.mean(-1, keepdim=True)
    w = torch.where(d.gate[:, None], mixed, w)
    x = ref_frontend.kaldi_fbank(w, cfg["n_mels"], cfg["sample_rate"], cfg["target_length"])[:, None]
    views = []
    for (fs, fw), (ts, tw) in d.masks:
        f_idx = torch.arange(x.shape[-2], device=x.device)
        t_idx = torch.arange(x.shape[-1], device=x.device)
        fm = (f_idx >= fs[:, None]) & (f_idx < (fs + fw)[:, None])
        tm = (t_idx >= ts[:, None]) & (t_idx < (ts + tw)[:, None])
        v = x.masked_fill(fm[:, None, :, None], 0.0).masked_fill(tm[:, None, None, :], 0.0)
        views.append((v - cfg["norm_mean"]) / (cfg["norm_std_mult"] * cfg["norm_std"]))
    return views[0], views[1]


def cosine_momentum(step: int, base: float, total_epochs: int, steps_per_epoch: int, device) -> torch.Tensor:
    """1 - (1 + cos(pi e / E)) / 2 * (1 - base) at epoch e = step // steps_per_epoch + 1, in f32."""
    e = torch.tensor(float(step // steps_per_epoch + 1), device=device)
    return 1.0 - 0.5 * (1.0 + torch.cos(math.pi * e / total_epochs)) * (1.0 - base)


def info_nce_rows(q, k, queue, tau: float) -> torch.Tensor:
    """Per-row cross-entropy of [q.k | q queue] / tau against label 0."""
    logits = torch.cat([(q * k).sum(1, keepdim=True), q @ queue], dim=1) / tau
    return torch.logsumexp(logits, dim=1) - logits[:, 0]


def ssmast_reference(p0: dict, queue0: torch.Tensor, batches: list[torch.Tensor], gen_states: list[torch.Tensor],
                     cfg: dict, arch: dict, prec: Precision, block: int = 32, half_batch: bool = False) -> dict:
    """Follow the program's first len(batches) SS-MAST steps (batched views:
    both EMA applications first, one query pass over concat(v1, v2), one
    key pass over concat(v2, v1), InfoNCE against the queue and the queue
    after the first keys, the queue advanced by both sets of keys, AdamW).
    ``half_batch`` plants a fault: the loss is the mean over the first half
    of each set of rows only. Returns the losses, each leaf's first
    gradient norm and its change after the steps, the queue after them and
    each key-encoder leaf's change after them."""
    dev = queue0.device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    pk = {k: v.detach().clone() for k, v in p0.items()}
    queue, ptr = queue0.clone(), 0
    n_drop = ref_mast.drop_path_blocks(arch)
    opt_state: dict = {}
    losses, grad1 = [], None
    with prec.products():
        for step, (waves, gs) in enumerate(zip(batches, gen_states)):
            gen = torch.Generator(dev)
            gen.set_state(gs)
            b = waves.shape[0]
            d = SSMastDraws(gen, b, cfg["n_mels"], cfg["target_length"], cfg["wave_mixup"], cfg["freq_param"],
                            cfg["time_param"], n_drop)
            with torch.no_grad():
                v1, v2 = ssmast_views(waves, d, cfg)
                m = cosine_momentum(step, cfg["momentum_base"], cfg["momentum_epochs"], cfg["steps_per_epoch"], dev)
                for _ in range(2):
                    for k in pk:
                        pk[k] = pk[k] * m + p[k].detach() * (1.0 - m)
                x_key = torch.cat([v2, v1])
                keys = torch.cat([
                    l2_normalize(_mast_head(x_key[i:i + block], pk, arch, prec, [u[i:i + block] for u in d.key]))
                    for i in range(0, 2 * b, block)])
            n_q = queue.shape[1]
            queue1 = queue.clone()
            queue1[:, (ptr + torch.arange(b, device=dev)) % n_q] = keys[:b].T
            x_q = torch.cat([v1, v2])
            total = 0.0
            n_used = b // 2 if half_batch else b
            for i in range(0, 2 * b, block):
                rows = torch.arange(i, min(i + block, 2 * b), device=dev)
                used = (rows % b) < n_used
                if not bool(used.any()):
                    continue
                q = l2_normalize(_mast_head(x_q[i:i + block], p, arch, prec, [u[i:i + block] for u in d.query]))
                ql = torch.where((rows < b)[:, None], q @ queue, q @ queue1)
                logits = torch.cat([(q * keys[i:i + block]).sum(1, keepdim=True), ql], 1) / cfg["temperature"]
                rows_loss = torch.logsumexp(logits, 1) - logits[:, 0]
                loss = (rows_loss * used).sum() / n_used
                loss.backward()
                total += float(loss.detach())
            queue = queue1.clone()
            queue[:, (ptr + b + torch.arange(b, device=dev)) % n_q] = keys[b:].T
            ptr = (ptr + 2 * b) % n_q
            grads = {k: v.grad for k, v in p.items()}
            if grad1 is None:
                grad1 = {k: float(g.double().norm()) for k, g in grads.items()}
            with torch.no_grad():
                adam_update_({k: v.data for k, v in p.items()}, grads, opt_state, cfg["lr"], weight_decay=cfg["weight_decay"])
            for v in p.values():
                v.grad = None
            losses.append(total)
    change = {k: float((p[k].detach() - p0[k]).double().norm()) for k in p}
    key_change = {k: float((pk[k] - p0[k]).double().norm()) for k in pk}
    return {"losses": losses, "grad1": grad1, "change": change, "queue": queue, "key_change": key_change}


def _mast_head(x, p: dict, arch: dict, prec: Precision, draws) -> torch.Tensor:
    z = encoder_forward("MAST", x, sub(p, "mast."), arch, prec, draws)
    return linear(z, p["mlp_fc1.weight"], p["mlp_fc1.bias"], prec)


# ---------------------------------------------------------------- the downstream fine-tune


def finetune_reference(p0: dict, batches: list[tuple[torch.Tensor, torch.Tensor]], encoder: str, arch: dict,
                       n_mels: int, lr: float, prec: Precision, block: int = 8, half_batch: bool = False) -> dict:
    """Follow the program's first len(batches) fine-tune steps: log-mel,
    encoder, linear head ``final``, mean cross-entropy, Adam."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    enc = {k[len("encoder."):]: v for k, v in p.items() if k.startswith("encoder.")}
    opt_state: dict = {}
    losses, grad1 = [], None
    with prec.products():
        for waves, labels in batches:
            b = waves.shape[0]
            n_used = b // 2 if half_batch else b
            total = 0.0
            for i in range(0, n_used, block):
                j = min(i + block, n_used)
                with torch.no_grad():
                    x = ref_frontend.log_mel(waves[i:j], n_mels)[:, None]
                h = encoder_forward(encoder, x, enc, arch, prec)
                logits = linear(h, p["final.weight"], p["final.bias"], prec)
                loss = F.cross_entropy(logits, labels[i:j].long(), reduction="sum") / n_used
                loss.backward()
                total += float(loss.detach())
            grads = {k: v.grad for k, v in p.items()}
            if grad1 is None:
                grad1 = {k: float(g.double().norm()) for k, g in grads.items()}
            with torch.no_grad():
                adam_update_({k: v.data for k, v in p.items()}, grads, opt_state, lr, decoupled=False)
            for v in p.values():
                v.grad = None
            losses.append(total)
    change = {k: float((p[k].detach() - p0[k]).double().norm()) for k in p}
    return {"losses": losses, "grad1": grad1, "change": change}
