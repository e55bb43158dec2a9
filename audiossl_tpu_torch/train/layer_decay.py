"""Layer-wise LR decay and no-weight-decay groups for MViT under AdamW (port
of ``audiossl_tpu.train.layer_decay``).

The reference's transformer optimizer policy
(extras/mast_new/mast/mvit/models/optimizer.py:12-231): per-block learning
rate decay lr * decay^(depth + 1 - layer), and no weight decay for biases,
norm scales and the positional / relative-position / cls parameters
(MViT.no_weight_decay, mvit_model.py:243-250).

The JAX package finds a parameter's layer with the regex ``block(\\d+)`` on
its flax path (``mast/mvit/block3/...``). The port's names are torch's
(``mast.blocks.3....``), so the rule is restated on them, to give each
parameter the (scale, decay) that JAX gives the flax leaf it converts from:
block i -> layer i + 1, the patch embedding -> 0, anything else (the head
and its norm) -> depth + 1. ``depth`` is the variant's nominal depth
(``finetune_mast.MVIT_DEPTH``), not a count of the blocks.

``AdamWLayerDecay`` is optax's chain of the JAX module, in this order:
clip by the global norm (optax's rule: g * max / |g| only where |g| >= max;
not ``torch.nn.utils.clip_grad_norm_``, which divides by |g| + 1e-6),
Adam (eps 1e-8, moments bias-corrected by 1 - b^t in f32, as optax
does), + wd * p where the decay mask says, times the layer scale, times -lr.

Under ``run.fsdp`` (``shards``, parallel/fsdp.py) the parameters are this
rank's pieces: the groups, the moments and the update act on them piece by
piece, and the clip's global norm is the data axis's sum of the pieces'
squared norms plus the whole leaves' once (``Shards.grad_norm``), the norm
of the logically whole gradient that optax's clip reads under GSPMD.
"""
from __future__ import annotations

import re
from typing import Iterable

import torch

_NO_DECAY_TOKENS = ("pos_embed", "rel_pos_h", "rel_pos_w", "cls_token", "bias")
_BLOCK = re.compile(r"(?:^|\.)blocks\.(\d+)\.")


def block_index(name: str, depth: int) -> int:
    """The layer of the parameter ``name``: block i -> i + 1, the patch
    embedding (or an absolute position table) -> 0, else depth + 1."""
    m = _BLOCK.search(name)
    if m:
        return int(m.group(1)) + 1
    if "patch_embed" in name or "pos_embed" in name:
        return 0
    return depth + 1


def layer_scale(name: str, depth: int, decay: float) -> float:
    """decay^(depth + 1 - layer) of the parameter ``name``."""
    return decay ** (depth + 1 - block_index(name, depth))


def decays(name: str, p: torch.Tensor) -> bool:
    """True where weight decay applies: 2-D and larger tensors outside the
    no-decay names (LayerNorm weights, JAX's ``scale``, are 1-D)."""
    if any(tok in name.lower() for tok in _NO_DECAY_TOKENS):
        return False
    return p.dim() >= 2


def layer_decay_mask(named_params: Iterable[tuple[str, torch.Tensor]], depth: int, decay: float) -> dict[str, float]:
    """{name: its LR multiplier}."""
    return {n: layer_scale(n, depth, decay) for n, _ in named_params}


def weight_decay_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """{name: whether weight decay applies}."""
    return {n: decays(n, p) for n, p in named_params}


class AdamWLayerDecay(torch.optim.Optimizer):
    """AdamW with the layer-decay scales and the decay mask as parameter
    groups (one per (scale, decay) pair), and optax's global-norm clip over
    all of them. The learning rate is constant."""

    def __init__(self, named_params: Iterable[tuple[str, torch.Tensor]], lr: float, depth: int,
                 layer_decay: float = 1.0, weight_decay: float = 0.05, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, clip_grad_norm: float | None = 1.0, shards=None):
        groups: dict[tuple[float, bool], list[torch.Tensor]] = {}
        for n, p in named_params:
            if p.requires_grad:
                groups.setdefault((layer_scale(n, depth, layer_decay), decays(n, p)), []).append(p)
        param_groups = [{"params": ps, "layer_scale": s, "weight_decay": weight_decay if d else 0.0}
                        for (s, d), ps in sorted(groups.items(), key=lambda kv: (kv[0][0], kv[0][1]))]
        super().__init__(param_groups, dict(lr=lr, betas=(b1, b2), eps=eps))
        self.clip_grad_norm = clip_grad_norm
        self.shards = shards

    @torch.no_grad()
    def clip_(self) -> torch.Tensor:
        """Scale every gradient by max / |g| where the global norm |g| is at
        least max (optax.clip_by_global_norm); returns |g|."""
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        grads = [p.grad for p in params]
        if self.shards is not None:
            norm = self.shards.grad_norm(params)
        else:
            # the sum of squares over one concatenation, as optax.global_norm sums its leaves'
            # (torch.linalg.vector_norm and _foreach_norm of a 2.4M-element f32 tensor on the
            # CPU stray by 2e-5 relative); on the card a few launches, not one per tensor
            norm = torch.cat([g.float().flatten() for g in grads]).square().sum().sqrt()
        if self.clip_grad_norm:
            m = float(self.clip_grad_norm)
            torch._foreach_mul_(grads, torch.where(norm < m, torch.ones_like(norm), m / norm))
        return norm

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a gradient, all groups at once
        (multi-tensor ``_foreach`` ops: a few dozen launches whatever the
        number of groups), in optax's order of operations."""
        self.clip_()
        params, scales, decayed, lrs = [], [], [], set()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    params.append(p)
                    scales.append(group["layer_scale"])
                    decayed.append(group["weight_decay"])
            lrs.add(group["lr"])
        if not params:
            return None
        (b1, b2), eps = self.defaults["betas"], self.defaults["eps"]
        if len(lrs) != 1:
            raise ValueError(f"AdamWLayerDecay takes one learning rate for every group, got {sorted(lrs)}")
        for p in params:
            st = self.state[p]
            if not st:
                st["step"] = 0
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["step"] += 1
        count = self.state[params[0]]["step"]
        grads = [p.grad for p in params]
        mus = [self.state[p]["exp_avg"] for p in params]
        nus = [self.state[p]["exp_avg_sq"] for p in params]
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu (optax's update_moment order)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        # the bias corrections 1 - b^count in f32, as optax takes them (at b2 = 0.999
        # f32 cancellation moves 1 - b2 by 1.3e-5 relative from its exact value)
        bc1, bc2 = (float(1.0 - torch.tensor(b, dtype=torch.float32) ** count) for b in (b1, b2))
        mu_hat = torch._foreach_div(mus, bc1)
        nu_hat = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, eps)
        upd = torch._foreach_div(mu_hat, nu_hat)
        idx = [i for i, w in enumerate(decayed) if w]  # + wd * p where the mask says
        if idx:
            torch._foreach_add_([upd[i] for i in idx],
                                torch._foreach_mul([params[i] for i in idx], [decayed[i] for i in idx]))
        torch._foreach_mul_(upd, scales)
        torch._foreach_mul_(upd, -lrs.pop())
        torch._foreach_add_(params, upd)
        return None


def adamw_layer_decay(named_params: Iterable[tuple[str, torch.Tensor]], lr: float, depth: int,
                      layer_decay: float = 1.0, weight_decay: float = 0.05, b1: float = 0.9, b2: float = 0.999,
                      clip_grad_norm: float | None = 1.0, shards=None) -> AdamWLayerDecay:
    """AdamW with masked weight decay, per-layer LR scaling and the
    reference's CLIP_GRAD_L2NORM (configs/MVITv2_B.yaml SOLVER block);
    ``shards``: the parameters' fsdp layout, if they are pieces."""
    return AdamWLayerDecay(named_params, lr, depth, layer_decay, weight_decay, b1, b2, 1e-8, clip_grad_norm, shards)
