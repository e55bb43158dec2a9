"""Collectives of the data-parallel step (the role of ``audiossl_tpu.parallel.mesh``).

The JAX package runs every trainer under ``shard_map`` over one ``data``
mesh axis and calls XLA collectives inside the step: ``pmean`` of the
gradients and metrics, ``psum`` / ``pmean`` of BatchNorm moments and the
Barlow cross-correlation, ``all_gather`` of MoCo keys, and an agreed key
(``pmax`` of key bits) for shuffle-BN's permutation. The port runs one
process per card and calls ``torch.distributed`` at the same places:

* ``world()`` / ``rank()``: the process group's size and this process's
  rank, 1 and 0 with no group, where every helper is the identity (no
  collective, the same launches and bits as a run that never imports this);
* ``all_reduce_sum`` / ``all_reduce_mean``: autograd-aware; the backward
  all-reduces the cotangents as a sum, as ``psum``'s transpose does, so a
  loss of an all-reduced statistic followed by the mean of the gradients
  gives the one-process gradient of the whole batch (a plain
  ``dist.all_reduce`` inside a loss gives 1/world of it);
* ``all_gather``: concatenation along dim 0 in rank order (``tiled=True``),
  no gradient;
* ``broadcast_from``: rank ``src``'s tensor on every rank (the agreed draw
  of shuffle-BN and DECAR's centroid initialisation);
* ``all_reduce_grads_``: the mean of every parameter's gradient over the
  group through one flat buffer (JAX's ``pmean(grads)``);
* ``share``: this process's rows of a batch every process read, for the
  trainers the JAX package runs on one host (probe, DECAR, DeepCluster).

``calls`` counts the collectives by kind; ``chip_smoke.py`` resets and reads
it. The collectives run on the tensors' own device: NCCL for CUDA tensors,
gloo for CPU ones (gloo also takes CUDA tensors for these three operations,
which the two-rank checks on one card use).
"""
from __future__ import annotations

import collections

import numpy as np
import torch
import torch.distributed as tdist

calls: collections.Counter = collections.Counter()


def active() -> bool:
    """True when a process group of more than one process is up."""
    return tdist.is_available() and tdist.is_initialized() and tdist.get_world_size() > 1


def world() -> int:
    return tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def share(x):
    """This process's contiguous rows of a global batch (a numpy array or a
    tensor): JAX's ``P(DATA_AXIS)`` split of a batch the whole group reads,
    a ragged tail parted as ``np.array_split`` parts it."""
    if not active():
        return x
    n, w, r = len(x), world(), rank()
    bounds = np.cumsum([0] + [n // w + (i < n % w) for i in range(w)])
    return x[bounds[r]:bounds[r + 1]]


def rank_seed(seed: int) -> int:
    """This process's generator seed: ``seed`` on rank 0 (so one process
    draws what it always drew), a SeedSequence of (seed, rank) elsewhere;
    the port's ``fold_in(key, axis_index)``."""
    r = rank()
    return seed if r == 0 else int(np.random.SeedSequence([seed, r]).generate_state(1)[0])


def _sum_(x: torch.Tensor, kind: str) -> torch.Tensor:
    calls[kind] += 1
    tdist.all_reduce(x, op=tdist.ReduceOp.SUM)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return _sum_(x.detach().clone().contiguous(), kind)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.detach().clone().contiguous(), ctx.kind), None


def all_reduce_sum(x: torch.Tensor, kind: str = "all_reduce") -> torch.Tensor:
    """psum: the sum over the group, with a summed backward; ``kind`` names
    the call in ``calls`` (forward and backward each count one)."""
    if not active():
        return x
    return _AllReduceSum.apply(x, kind)


def all_reduce_mean(x: torch.Tensor, kind: str = "all_reduce") -> torch.Tensor:
    """pmean: the mean over the group, with a summed backward over world."""
    if not active():
        return x
    return _AllReduceSum.apply(x, kind) / world()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """all_gather(tiled=True): [world * B, ...] in rank order, no gradient."""
    if not active():
        return x
    calls["all_gather"] += 1
    parts = [torch.empty_like(x) for _ in range(world())]
    tdist.all_gather(parts, x.detach().contiguous())
    return torch.cat(parts)


def broadcast_from(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (a new tensor), no gradient."""
    if not active():
        return x
    calls["broadcast"] += 1
    out = x.detach().clone().contiguous()
    tdist.broadcast(out, src)
    return out


def gather_objects(obj) -> list:
    """Every process's picklable ``obj`` in rank order; [obj] with no group."""
    if not active():
        return [obj]
    calls["all_gather_object"] += 1
    out = [None] * world()
    tdist.all_gather_object(out, obj)
    return out


def all_reduce_grads_(params) -> None:
    """``p.grad`` = the group's mean of it for each parameter that trains, in
    one all-reduce of a flat f32 buffer; a parameter the loss did not reach
    counts as a zero gradient (JAX's gradient tree holds zeros there)."""
    if not active():
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    _sum_(flat, "all_reduce_grads")
    flat /= world()
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[off : off + n].view_as(g).to(g.dtype)
        off += n
