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
  trainers the JAX package runs on one host (probe, DECAR, DeepCluster);
* ``reduce_scatter_mean``: rank r's slice r of the data axis's mean of a
  flat buffer (JAX's ``psum_scatter(tiled=True) / n``), and
  ``all_gather_flat``: every rank's flat buffer joined in rank order into
  one (``all_gather(tiled=True)``): the two collectives of the sharded
  training state (parallel/fsdp.py, train/zero.py), each counted under the
  kind its caller names.

Tensor parallelism (JAX's ``model`` mesh axis, parallel/tp.py) lays the
group out as a dp x tp grid: ``set_tp(tp)`` puts rank r at data index
r // tp and model index r % tp, as ``make_dp_tp_mesh`` reshapes its
devices, and makes the two kinds of subgroup: ``data_group()`` (the ranks
of one model index, the ``data`` axis) and ``model_group()`` (the ranks of
one data index, the ``model`` axis). Every helper above is a ``data``-axis
collective: it runs over the data group and counts ``dp_world()`` /
``dp_rank()``, so the ranks of one model group read the same clips, draw
the same numbers (``rank_seed``) and average only their own shard's
gradients. With tp = 1 (``set_tp(1)``, the default) the data group is the
whole world and every call is what it was. ``world()`` / ``rank()`` stay the
process group's (rank 0 writes the files).

``calls`` counts the collectives by kind; ``chip_smoke.py`` resets and reads
it. The collectives run on the tensors' own device: NCCL for CUDA tensors,
gloo for CPU ones (gloo also takes CUDA tensors for these operations,
``reduce_scatter_tensor`` and ``all_gather_into_tensor`` included, which the
two-rank checks on one card use).
"""
from __future__ import annotations

import collections

import numpy as np
import torch
import torch.distributed as tdist

calls: collections.Counter = collections.Counter()

_tp = 1  # the model axis's size; set_tp lays out the grid
_grids: dict = {}  # (tp, the world group) -> (this rank's data group, its model group)


def active() -> bool:
    """True when a process group of more than one process is up."""
    return tdist.is_available() and tdist.is_initialized() and tdist.get_world_size() > 1


def world() -> int:
    return tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def set_tp(tp: int) -> None:
    """Lay the group out as a (world // tp) x tp grid, JAX's ('data', 'model')
    mesh: rank r at data index r // tp, model index r % tp. A collective the
    first time a tp > 1 is set on a group (every rank makes every subgroup,
    in one order); tp = 1 is the plain data-parallel layout. Raises JAX's
    ValueError when the world does not divide by tp."""
    global _tp
    tp, w = max(1, int(tp)), world()
    if w % tp:
        raise ValueError(f"{w} devices not divisible by tp={tp}")
    key = (tp, tdist.group.WORLD if active() else None)
    if tp > 1 and key not in _grids:
        r = rank()
        data = model = None
        for m in range(tp):
            g = tdist.new_group([d * tp + m for d in range(w // tp)])
            data = g if r % tp == m else data
        for d in range(w // tp):
            g = tdist.new_group(list(range(d * tp, (d + 1) * tp)))
            model = g if r // tp == d else model
        _grids[key] = (data, model)
    _tp = tp


def _grid() -> tuple:
    return _grids[(_tp, tdist.group.WORLD)] if _tp > 1 else (None, None)


def tp_world() -> int:
    """The model axis's size (1 without tensor parallelism)."""
    return _tp


def tp_rank() -> int:
    return rank() % _tp


def dp_world() -> int:
    """The data axis's size: the number of model replicas."""
    return world() // _tp


def dp_rank() -> int:
    return rank() // _tp


def data_group():
    """The ranks of this process's model index (None: the whole world)."""
    return _grid()[0]


def model_group():
    """The ranks of this process's data index, which hold one model's shards."""
    return _grid()[1]


def data_active() -> bool:
    """True when the data axis has more than one process."""
    return dp_world() > 1


def share(x):
    """This process's contiguous rows of a global batch (a numpy array or a
    tensor): JAX's ``P(DATA_AXIS)`` split of a batch the whole data axis
    reads, a ragged tail parted as ``np.array_split`` parts it."""
    if not data_active():
        return x
    n, w, r = len(x), dp_world(), dp_rank()
    bounds = np.cumsum([0] + [n // w + (i < n % w) for i in range(w)])
    return x[bounds[r]:bounds[r + 1]]


def rank_seed(seed: int) -> int:
    """This process's generator seed: ``seed`` at data index 0 (so one
    process draws what it always drew), a SeedSequence of (seed, data index)
    elsewhere; the port's ``fold_in(key, axis_index)``. The ranks of one
    model group share it, so they draw alike."""
    r = dp_rank()
    return seed if r == 0 else int(np.random.SeedSequence([seed, r]).generate_state(1)[0])


def _sum_(x: torch.Tensor, kind: str, group=None) -> torch.Tensor:
    calls[kind] += 1
    tdist.all_reduce(x, op=tdist.ReduceOp.SUM, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return _sum_(x.detach().clone().contiguous(), kind, data_group())

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.detach().clone().contiguous(), ctx.kind, data_group()), None


def all_reduce_sum(x: torch.Tensor, kind: str = "all_reduce") -> torch.Tensor:
    """psum over the data axis, with a summed backward; ``kind`` names the
    call in ``calls`` (forward and backward each count one)."""
    if not data_active():
        return x
    return _AllReduceSum.apply(x, kind)


def all_reduce_mean(x: torch.Tensor, kind: str = "all_reduce") -> torch.Tensor:
    """pmean over the data axis, with a summed backward over its size."""
    if not data_active():
        return x
    return _AllReduceSum.apply(x, kind) / dp_world()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """all_gather(tiled=True) over the data axis: [dp_world * B, ...] in
    rank order, no gradient."""
    if not data_active():
        return x
    calls["all_gather"] += 1
    parts = [torch.empty_like(x) for _ in range(dp_world())]
    tdist.all_gather(parts, x.detach().contiguous(), group=data_group())
    return torch.cat(parts)


def broadcast_from(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """The ``x`` of data index ``src`` on every rank of the data axis (a new
    tensor), no gradient."""
    if not data_active():
        return x
    calls["broadcast"] += 1
    out = x.detach().clone().contiguous()
    tdist.broadcast(out, src * _tp + tp_rank(), group=data_group())
    return out


def gather_objects(obj) -> list:
    """Every data index's picklable ``obj`` in order; [obj] with one."""
    if not data_active():
        return [obj]
    calls["all_gather_object"] += 1
    out = [None] * dp_world()
    tdist.all_gather_object(out, obj, group=data_group())
    return out


def barrier() -> None:
    """Every process of the group waits for the others (none without one)."""
    if active():
        tdist.barrier()


def all_reduce_grads_(params) -> None:
    """``p.grad`` = the data axis's mean of it for each parameter that
    trains, in one all-reduce of a flat f32 buffer; a parameter the loss did
    not reach counts as a zero gradient (JAX's gradient tree holds zeros
    there). Under tensor parallelism each rank averages its own shards with
    the same shards of the other replicas, never across the model axis."""
    if not data_active():
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    _sum_(flat, "all_reduce_grads", data_group())
    flat /= dp_world()
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[off : off + n].view_as(g).to(g.dtype)
        off += n


def reduce_scatter_mean(flat: torch.Tensor, kind: str = "reduce_scatter") -> torch.Tensor:
    """Slice ``dp_rank()`` of the data axis's mean of ``flat`` [n * k] (n
    the data axis's size): [k], JAX's ``psum_scatter(flat, tiled=True) / n``;
    no gradient. ``flat`` itself with one process."""
    if not data_active():
        return flat
    n = dp_world()
    if flat.numel() % n:
        raise ValueError(f"a reduce-scatter over {n} ranks needs a multiple of {n} elements, got {flat.numel()}")
    calls[kind] += 1
    out = torch.empty(flat.numel() // n, dtype=flat.dtype, device=flat.device)
    tdist.reduce_scatter_tensor(out, flat.detach().contiguous(), op=tdist.ReduceOp.SUM, group=data_group())
    return out.div_(n)


def all_gather_flat(flat: torch.Tensor, kind: str = "all_gather_flat") -> torch.Tensor:
    """Every data index's ``flat`` [k] joined in rank order: [n * k], JAX's
    ``all_gather(flat, tiled=True)``; no gradient. ``flat`` itself with one
    process."""
    if not data_active():
        return flat
    calls[kind] += 1
    out = torch.empty(flat.numel() * dp_world(), dtype=flat.dtype, device=flat.device)
    tdist.all_gather_into_tensor(out, flat.detach().reshape(-1).contiguous(), group=data_group())
    return out
