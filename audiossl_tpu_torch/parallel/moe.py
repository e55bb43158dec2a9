"""Expert parallelism: a Switch top-1 MoE FFN over an expert group (port of
``audiossl_tpu.parallel.moe``).

A drop-in for a transformer FFN: each token goes to the expert its router
ranks first, and the experts' weights are split over the group's ranks.
As in JAX (the GShard formulation), dispatch and combine are products with
a one-hot slot tensor, and the only communication is a pair of
``dist.all_to_all`` calls: the expert dim split out to its ranks, the
source ranks' slots joined, and the results back the same way. Each
(source rank, expert) pair owns ``capacity`` slots, and a token past a full
expert is dropped (its output is zero). The products are plain torch, as
JAX computes them outside any Pallas kernel.

Gradients. The router is replicated; the experts are sharded. Every rank
computes one loss: its tokens' terms plus the aux loss, which every rank
holds whole. The aux statistics' group sum is ``dist.sum_replicated``, so
the aux loss counts once: a rank's router gradient is its own share, and
the router's gradient is the group's sum of them (``dist.all_reduce_sum``
with no gradient, e.g. ``sum_router_grad_``), which equals JAX's
``jax.grad`` through ``moe_apply``. Each rank's expert gradients are whole
for its experts (the all-to-all's backward brings every source's
cotangent). ``dist.calls`` counts "ep_all_to_all" (two forward; two
backward where the tokens take a gradient, else one) and "ep_aux".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from audiossl_tpu_torch.parallel import dist


def _trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape)
    return torch.nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04, generator=generator)


def init_moe_params(d: int, hidden: int, n_experts: int, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The router [d, E] and every expert's FFN (w1 [E, d, h], b1 [E, h], w2
    [E, h, d], b2 [E, d]), f32 on the CPU, drawn from ``generator`` (flax's
    truncated normal, std 0.02; zero biases), so a seed gives the same
    weights at any world size. ``expert_shard`` takes a rank's part."""
    return {"router": _trunc_normal((d, n_experts), generator),
            "w1": _trunc_normal((n_experts, d, hidden), generator), "b1": torch.zeros(n_experts, hidden),
            "w2": _trunc_normal((n_experts, hidden, d), generator), "b2": torch.zeros(n_experts, d)}


def expert_shard(params: dict[str, torch.Tensor], group=None) -> dict[str, torch.Tensor]:
    """This rank's part of whole parameters: the router whole, the experts
    E / n of them (JAX's P(expert) on their leading dim), as views."""
    n, r = dist.world(group), dist.rank(group)
    e = params["router"].shape[1]
    if e % n:
        raise ValueError(f"{e} experts not divisible by {n} devices")
    k = e // n
    return {key: (v if key == "router" else v[r * k:(r + 1) * k]) for key, v in params.items()}


def moe_ffn(params_local: dict[str, torch.Tensor], x_local: torch.Tensor, capacity: int,
            group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Tokens [n, d] of this rank -> ([n, d], aux loss).

    ``params_local``: the router [d, E] and this rank's E / group-size
    experts; ``capacity``: slots per (source rank, expert). The aux loss is
    Switch's E * sum_i f_i * P_i over the group's whole batch."""
    w, n = dist.world(group), x_local.shape[0]
    e = params_local["router"].shape[1]
    if e % w:
        raise ValueError(f"{e} experts not divisible by {w} devices")
    probs = torch.softmax(x_local @ params_local["router"], dim=-1)  # [n, E]
    gate, expert = probs.max(dim=-1)
    onehot = F.one_hot(expert, e).to(x_local.dtype)
    pos = torch.cumsum(onehot, dim=0) - onehot  # the slot within (this rank, expert)
    keep = torch.where(pos < capacity, onehot, 0.0)
    slot = (pos.long()[..., None] == torch.arange(capacity, device=x_local.device)).to(x_local.dtype)
    slot = slot * keep[..., None]  # [n, E, C]: a one-hot dispatch, zero past capacity
    dispatched = torch.einsum("nd,nec->ecd", x_local, slot)  # [E, C, d]
    xa = dist.all_to_all(dispatched, 0, 1, group, "ep_all_to_all")  # [E / w, w * C, d]
    h = F.gelu(torch.einsum("esd,edh->esh", xa, params_local["w1"]) + params_local["b1"][:, None, :])
    y = torch.einsum("esh,ehd->esd", h, params_local["w2"]) + params_local["b2"][:, None, :]
    yb = dist.all_to_all(y, 1, 0, group, "ep_all_to_all")  # [E, C, d], back on the source rank
    out = torch.einsum("ecd,nec->nd", yb, slot * gate[:, None, None])
    # the aux statistics over the group's batch in one sum: tokens and probs by expert, the token count
    stats = torch.cat([onehot.sum(0), probs.sum(0), x_local.new_full((1,), n)])
    stats = dist.sum_replicated(stats, group, "ep_aux")
    frac, pbar = stats[:e] / stats[-1], stats[e:2 * e] / stats[-1]
    return out, e * torch.sum(frac * pbar)


def moe_apply(params: dict[str, torch.Tensor], x_local: torch.Tensor, capacity: int,
              group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` on this rank's part of whole parameters (as JAX's
    ``moe_apply`` takes them): its experts are views, so their gradients
    land in this rank's rows of the whole tensors."""
    return moe_ffn(expert_shard(params, group), x_local, capacity, group)


def sum_router_grad_(router: torch.Tensor, group=None) -> None:
    """The router's gradient summed over the group (each rank holds its
    share of the one loss's), in place."""
    if router.grad is not None and dist.world(group) > 1:
        router.grad = dist.all_reduce_sum(router.grad.detach(), "ep_router_grad", group)
