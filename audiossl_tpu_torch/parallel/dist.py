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
  no gradient; ``gather_rows`` the same with a gradient, for a loss that
  every rank computes alike on the whole batch (JAX's GSPMD step, where
  the batch is one array);
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

The inner axes of the JAX package's library modules (``pipe``,
``expert``, the sequence-parallel ``data`` axis of parallel/ring.py) take
explicit groups: ``inner_grid(n)`` lays the world out as (world / n) x n
as ``set_tp`` does and returns this rank's (outer, inner) groups, and the
helpers below take such a group (None: the whole world, as in
``torch.distributed``; with no process group, one rank and the identity):

* ``ppermute``: JAX's ``lax.ppermute`` (pairs of group ranks, zeros where
  no pair arrives), autograd-aware, its backward the inverted pairs;
* ``all_to_all``: ``lax.all_to_all(..., tiled=True)``, its backward the
  inverse all-to-all;
* ``all_reduce_sum(x, kind, group)``: the psum above over any group;
* ``sum_replicated``: a psum whose result every rank then uses alike in
  one loss (JAX's psum into an unmapped ``shard_map`` output): the backward
  passes the cotangent as it is, so each rank's part gets the one loss's
  cotangent (a summed backward would give it the group's size times that).

``calls`` counts the collectives by kind; ``chip_smoke.py`` resets and reads
it. The collectives run on the tensors' own device: NCCL for CUDA tensors,
gloo for CPU ones. Gloo takes CUDA tensors for the collectives
(``all_reduce``, ``reduce_scatter_tensor``, ``all_gather_into_tensor``,
``all_to_all_single``, which the two-rank checks on one card use) but not
for point-to-point: its send of a CUDA tensor fails ("writev: Bad
address"; torch 2.11 on an H100). ``ppermute`` on a gloo group therefore
stages a CUDA tensor through host memory, chosen from the group's backend
and the tensor's device (in ``exchange``), and counts each copy under
``calls["host_staging_copy"]``.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
import torch.distributed as tdist

calls: collections.Counter = collections.Counter()

_tp = 1  # the model axis's size; set_tp lays out the grid
_grids: dict = {}  # (n, the world group) -> (this rank's outer group, its inner group)


def active() -> bool:
    """True when a process group of more than one process is up."""
    return tdist.is_available() and tdist.is_initialized() and tdist.get_world_size() > 1


def world(group=None) -> int:
    """The size of ``group`` (None: the world); 1 with no process group."""
    return tdist.get_world_size(group) if tdist.is_available() and tdist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group`` (None: the world); 0 with no process group."""
    return tdist.get_rank(group) if tdist.is_available() and tdist.is_initialized() else 0


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
    if tp > 1:
        inner_grid(tp)
    _tp = tp


def inner_grid(n: int) -> tuple:
    """Lay the group out as (world // n) x n, rank r at outer index r // n and
    inner index r % n (``set_tp``'s layout, ``make_dp_tp_mesh``'s), and
    return this rank's (outer, inner) groups: the world // n ranks of its
    inner index and the n ranks of its outer index. The pipe, expert and
    sequence axes are the inner one, the data axis the outer. A collective
    the first time an n is asked for on a group (every rank makes every
    subgroup, in one order); with no process group, (None, None). Raises
    JAX's ValueError when the world does not divide by n."""
    n, w = max(1, int(n)), world()
    if w % n:
        raise ValueError(f"{w} devices not divisible by {n}")
    if not active():
        return None, None
    key = (n, tdist.group.WORLD)
    if key not in _grids:
        r = rank()
        outer = inner = None
        for i in range(n):
            g = tdist.new_group([o * n + i for o in range(w // n)])
            outer = g if r % n == i else outer
        for o in range(w // n):
            g = tdist.new_group(list(range(o * n, (o + 1) * n)))
            inner = g if r // n == o else inner
        _grids[key] = (outer, inner)
    return _grids[key]


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
    def forward(ctx, x, kind, group, summed):
        ctx.kind, ctx.group, ctx.summed = kind, group, summed
        return _sum_(x.detach().clone().contiguous(), kind, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _sum_(g.detach().clone().contiguous(), ctx.kind, ctx.group)
        return g, None, None, None


_DATA = object()  # all_reduce_sum's default group: the data axis


def all_reduce_sum(x: torch.Tensor, kind: str = "all_reduce", group=_DATA) -> torch.Tensor:
    """psum over the data axis (or over ``group``), with a summed backward;
    ``kind`` names the call in ``calls`` (forward and backward each count
    one)."""
    if group is _DATA:
        if not data_active():
            return x
        group = data_group()
    elif world(group) == 1:
        return x
    return _AllReduceSum.apply(x, kind, group, True)


def sum_replicated(x: torch.Tensor, group, kind: str = "all_reduce") -> torch.Tensor:
    """psum over ``group`` of a value that every rank then uses alike in one
    loss, every rank computing that loss: the backward hands each rank's
    part the loss's cotangent as it is (JAX's psum into an unmapped
    ``shard_map`` output), where ``all_reduce_sum`` would hand it the sum of
    the group's, the group's size times it. The forward counts one call."""
    if world(group) == 1:
        return x
    return _AllReduceSum.apply(x, kind, group, False)


def all_reduce_mean(x: torch.Tensor, kind: str = "all_reduce") -> torch.Tensor:
    """pmean over the data axis, with a summed backward over its size."""
    if not data_active():
        return x
    return _AllReduceSum.apply(x, kind, data_group(), True) / dp_world()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """all_gather(tiled=True) over the data axis: [dp_world * B, ...] in
    rank order, no gradient."""
    if not data_active():
        return x
    calls["all_gather"] += 1
    parts = [torch.empty_like(x) for _ in range(dp_world())]
    tdist.all_gather(parts, x.detach().contiguous(), group=data_group())
    return torch.cat(parts)


def gather_rows(x: torch.Tensor, kind: str = "all_gather_rows") -> torch.Tensor:
    """all_gather(tiled=True) over the data axis with a gradient: this rank's
    rows at their offset in zeros, all-reduced as a sum, so the backward
    sums the cotangents. Every rank computing one loss alike from the
    result, and the gradients then averaged over the ranks, each rank's rows
    get that loss's gradient, as under JAX's GSPMD step."""
    if not data_active():
        return x
    b, n, r = x.shape[0], dp_world(), dp_rank()
    zeros = lambda k: x.new_zeros((k * b, *x.shape[1:]))  # noqa: E731
    return all_reduce_sum(torch.cat([zeros(r), x, zeros(n - 1 - r)]), kind)


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


# ---------------------------------------------------------------- point-to-point and all-to-all over a group

def _check_perm(perm, n: int) -> tuple:
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts) or not all(0 <= r < n for r in srcs + dsts):
        raise ValueError(f"ppermute pairs must name distinct sources and destinations among {n} ranks, got {perm}")
    return perm


def exchange(send: torch.Tensor | None, like: torch.Tensor, perm, group, kind: str) -> torch.Tensor | None:
    """One step of a permutation, no gradient: for each pair (src, dst) of
    group ranks, src sends ``send`` and dst receives a tensor shaped as
    ``like``. Returns what this rank received, or None where no pair sends
    to it. Every rank of the group calls it with the same pairs, in the
    same order as its other calls; a rank in no pair returns at once."""
    me = rank(group)
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    if dst is None and src is None:
        return None
    calls[kind] += 1
    if dst == me:  # a pair onto itself, with nothing else to move
        return send.detach().clone()
    # gloo's send of a CUDA tensor fails (chip_smoke.py's gloo probe): stage it through the host
    staged = like.is_cuda and tdist.get_backend(group) == "gloo"
    ops, buf = [], None
    if dst is not None:
        out = send.detach().contiguous()
        if staged:
            out = out.cpu()
            calls["host_staging_copy"] += 1
        peer = dst if group is None else tdist.get_global_rank(group, dst)
        ops.append(tdist.P2POp(tdist.isend, out, peer, group))
    if src is not None:
        buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)
        peer = src if group is None else tdist.get_global_rank(group, src)
        ops.append(tdist.P2POp(tdist.irecv, buf, peer, group))
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    if buf is not None and staged:
        buf = buf.to(like.device)
        calls["host_staging_copy"] += 1
    return buf


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group, kind):
        ctx.perm, ctx.group, ctx.kind = perm, group, kind
        got = exchange(x, x, perm, group, kind)
        return torch.zeros_like(x) if got is None else got

    @staticmethod
    def backward(ctx, g):
        got = exchange(g, g, tuple((d, s) for s, d in ctx.perm), ctx.group, ctx.kind)
        return (torch.zeros_like(g) if got is None else got), None, None, None


def ppermute(x: torch.Tensor, perm, group=None, kind: str = "ppermute") -> torch.Tensor:
    """JAX's ``lax.ppermute`` over ``group``: for each pair (src, dst) of
    group ranks, dst gets src's ``x``; a rank no pair sends to gets zeros.
    Autograd-aware: the backward sends the cotangent along the inverted
    pairs (JAX's transpose). Every rank of the group calls it with the same
    pairs and in the same order, forward and backward; so each call's output
    must reach the loss on every rank that calls it, or that rank's backward
    never sends what its peers wait for. Each direction counts one call in
    ``calls[kind]`` on a rank that sends or receives."""
    perm = _check_perm(perm, world(group))
    if world(group) == 1:
        return x if perm else torch.zeros_like(x)
    return _PPermute.apply(x, perm, group, kind)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group, kind: str) -> torch.Tensor:
    n = world(group)
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % n:
        raise ValueError(f"an all-to-all over {n} ranks splits dim {split_dim} of {tuple(x.shape)} evenly")
    calls[kind] += 1
    chunks = x.movedim(split_dim, 0)
    chunks = chunks.reshape(n, chunks.shape[0] // n, *chunks.shape[1:]).contiguous()
    got = torch.empty_like(chunks)  # [n, ...]: chunk i from group rank i
    tdist.all_to_all_single(got, chunks, group=group)
    got = got.movedim(1, split_dim + 1)  # each chunk back in x's layout, the source rank in front
    return torch.cat(got.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, kind):
        ctx.dims, ctx.group, ctx.kind = (split_dim, concat_dim), group, kind
        return _all_to_all(x.detach(), split_dim, concat_dim, group, kind)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group, ctx.kind), None, None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group=None, kind: str = "all_to_all") -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`` over
    ``group``: ``x`` cut into n equal chunks along ``split_dim``, chunk i
    sent to group rank i, the n chunks received joined along
    ``concat_dim`` in rank order. The backward is the inverse all-to-all
    (split along ``concat_dim``, join along ``split_dim``). Gloo takes CUDA
    tensors for ``all_to_all_single``, so nothing is staged. Each direction
    counts one call in ``calls[kind]``."""
    if world(group) == 1:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group, kind)
