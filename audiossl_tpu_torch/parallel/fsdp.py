"""Fully sharded training state over the data axis (port of
``audiossl_tpu.parallel.fsdp``, ``run.fsdp``).

The JAX package shards the whole ``TrainState`` with GSPMD
(``tree_shardings``): every leaf of at least ``min_size`` elements is split
over the ``data`` mesh axis on its largest dimension that the axis size n
divides (``fsdp_spec``), and XLA all-gathers each weight where it is used
and reduce-scatters its gradient, so that parameters, gradients, the Adam
moments, the EMA key tower and the MoCo queue are 1/n per device between
steps. PyTorch has no partitioner; the port writes the same layout out on
``dist.py``'s two collectives:

* ``shard_`` cuts every parameter (and the buffers its caller names) of a
  module tree to this rank's piece, in place, with JAX's spec: the spec is
  taken on the JAX leaf's shape (a Linear weight is the transpose of flax's
  Dense kernel, a conv weight OIHW against flax's HWIO; ``jax_axes``), so
  that rank r's pieces are JAX's addressable shard r of every leaf after the
  flax -> torch conversion. Build the optimizer after it: its moments are
  then shard-sized, and an elementwise update runs shard by shard;
* the ``units`` (module paths under the root, ``*`` matching one name:
  SS-MAST's two towers and each of their MViT blocks, the fine-tune's
  classifier and its blocks) gather their sharded parameters before each
  forward and put the pieces back after it (forward hooks), each parameter
  by the innermost unit that holds it: one ``all_gather_flat`` of the
  unit's pieces ("fsdp_gather"), so the models run unchanged on whole
  weights. Its backward reduce-scatters the whole gradients as the data
  axis's mean in one flat buffer ("fsdp_reduce_scatter"), so ``.grad``
  lands on each piece already reduced (JAX's ``with_sharding_constraint``
  of the gradients to the parameter layout). A unit's backward runs when
  the unit's own backward is done, so with a unit a block, one block's whole
  gradients are live at a time, and under ``no_grad`` (the EMA key tower,
  the eval) one block's whole weights. A unit run twice in a step
  (sequential views, gradient accumulation) gathers twice and reduces each
  backward: the sum of the means is the mean of the sums, exact up to the
  order of the additions;
* the leaves that stay whole (under ``DEFAULT_MIN_SIZE``, or with no
  dimension n divides) take the usual all-reduce of their gradients
  (``grads_to_all_reduce``), and a global-norm clip counts them once
  (``global_sq_norm``);
* ``dense_state_dict`` and ``dense_optimizer_state`` make the dense layout
  checkpoints hold from every rank's pieces (one gather of every piece); a
  resume cuts the dense state for this rank with ``spec``
  (``convert.shard_state_dict``, ``tp.map_optimizer_state``).

What the autograd graph saves of the gathered weights (in bf16 the cast
copies) lives from a unit's forward to its backward, as the XLA program
keeps it. Under ``remat`` (JAX keeps ``jax.checkpoint`` under fsdp,
audiossl_tpu/parallel/fsdp.py:31-33) a rematerialised unit saves none of
it: ``torch.utils.checkpoint`` calls the unit again in the backward, so its
hooks gather the whole weights a second time for the recompute
("fsdp_gather" counts both) and put the pieces back after it, and the
gradients still leave through the first forward's gather, reduce-scattered
once. With one process every collective is the identity: the pieces are
the whole tensors.
"""
from __future__ import annotations

import math
from fnmatch import fnmatchcase
from typing import Iterable, Sequence

import torch
from torch import nn

from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel.tp import piece

# below this many elements a leaf stays whole (JAX fsdp.py:53)
DEFAULT_MIN_SIZE = 2**12


def fsdp_spec(shape: Sequence[int], n: int, min_size: int = DEFAULT_MIN_SIZE) -> int | None:
    """JAX's ``fsdp_spec``: the dimension of ``shape`` to split n ways (the
    strictly largest one that n divides, the first on ties), or None for a
    leaf that stays whole (under ``min_size`` elements, or no dimension n
    divides)."""
    if math.prod(shape) < min_size:
        return None
    best = None
    for d, s in enumerate(shape):
        if s % n == 0 and (best is None or s > shape[best]):
            best = d
    return best


def jax_axes(module: nn.Module, name: str, t: torch.Tensor) -> tuple[int, ...]:
    """The tensor's dimensions in the order of the JAX leaf it converts
    from: a Linear weight [out, in] is flax's kernel [in, out]; a conv
    weight (O, I, kt, kf) in the port's time-major MViT is flax's HWIO
    (kt, kf, I, O); anything else keeps its order."""
    if name == "weight" and isinstance(module, nn.Linear):
        return (1, 0)
    if name == "weight" and isinstance(module, nn.Conv2d):
        return (2, 3, 1, 0)
    return tuple(range(t.dim()))


def tensor_dims(root: nn.Module, n: int, buffers: Iterable[str] = ()) -> dict[str, int | None]:
    """State-dict key -> the dimension of the port's tensor that is split n
    ways (None: whole), for every parameter of ``root`` and the root's
    buffers named in ``buffers``; JAX's spec taken on the JAX leaf's shape."""
    dims: dict[str, int | None] = {}
    for mname, m in root.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            axes = jax_axes(m, pname, p)
            d = fsdp_spec([p.shape[a] for a in axes], n)
            dims[f"{mname}.{pname}" if mname else pname] = None if d is None else axes[d]
    for b in buffers:
        t = getattr(root, b)
        dims[b] = fsdp_spec(t.shape, n)
    return dims


def gather_pieces(pieces: Sequence[torch.Tensor], dims: Sequence[int]) -> list[torch.Tensor]:
    """The whole tensors from every rank's pieces: one ``all_gather_flat``
    of this rank's pieces, each whole tensor the rank-ordered pieces joined
    on its dimension; no gradient."""
    if not pieces:
        return []
    n = dist.dp_world()
    flat = torch.cat([p.detach().reshape(-1) for p in pieces])
    rows = dist.all_gather_flat(flat, "fsdp_gather").view(n, -1)
    out, off = [], 0
    for p, d in zip(pieces, dims):
        k = p.numel()
        out.append(torch.cat([rows[j, off:off + k].view(p.shape) for j in range(n)], dim=d))
        off += k
    return out


def scatter_grads(grads: Sequence[torch.Tensor], dims: Sequence[int]) -> list[torch.Tensor]:
    """This rank's piece of the data axis's mean of each whole gradient:
    one ``reduce_scatter_mean`` of a flat buffer whose slice j holds every
    gradient's piece j."""
    n = dist.dp_world()
    parts = [g.chunk(n, dim=d) for g, d in zip(grads, dims)]
    flat = torch.cat([pt[j].reshape(-1) for j in range(n) for pt in parts])
    mine = dist.reduce_scatter_mean(flat, "fsdp_reduce_scatter")
    out, off = [], 0
    for pt in parts:
        k = pt[0].numel()
        out.append(mine[off:off + k].view(pt[0].shape))
        off += k
    return out


class _Gather(torch.autograd.Function):
    """Forward: whole weights from the pieces; backward: each piece's share
    of the data axis's mean gradient."""

    @staticmethod
    def forward(ctx, dims, *pieces):
        ctx.dims = dims
        whole = gather_pieces(pieces, dims)
        ctx.like = [(w.shape, w.dtype, w.device) for w in whole]
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=t, device=dv) if g is None else g for g, (s, t, dv) in zip(grads, ctx.like)]
        return (None, *scatter_grads(grads, ctx.dims))


def global_sq_norm(sharded: Sequence[torch.Tensor], whole: Sequence[torch.Tensor]) -> torch.Tensor:
    """The squared global norm of a gradient held as this rank's pieces of
    the sharded leaves and the whole replicated leaves: the pieces' sums of
    squares summed over the data axis, the replicated leaves' counted once
    (optax ``global_norm`` of the logically whole tree). f32."""
    def sq(ts):
        return torch.cat([t.float().flatten() for t in ts]).square().sum() if ts else None

    s, w = sq(sharded), sq(whole)
    if s is not None:
        s = dist.all_reduce_sum(s, "fsdp_norm")
    parts = [t for t in (s, w) if t is not None]
    return parts[0] if len(parts) == 1 else parts[0] + parts[1]


def _matches(name: str, pattern: str) -> bool:
    """``name`` (a dotted module path, "" the root) against ``pattern``,
    name by name (``*`` matches one name)."""
    if not pattern:
        return not name
    parts, want = name.split(".") if name else [], pattern.split(".")
    return len(parts) == len(want) and all(fnmatchcase(a, b) for a, b in zip(parts, want))


class Shards:
    """The fsdp layout of one module tree (``shard_``'s result): each key's
    dimension, the units' hooks, and the conversions to the dense layout."""

    def __init__(self, root: nn.Module, units: Sequence[str], buffers: Sequence[str] = ()):
        self.root = root
        self.n, self.rank = dist.dp_world(), dist.dp_rank()
        self.dims = tensor_dims(root, self.n, buffers)
        self.buffers = tuple(buffers)
        owners = {}
        for mname, m in root.named_modules():
            for pname, _ in m.named_parameters(recurse=False):
                owners[f"{mname}.{pname}" if mname else pname] = (m, pname)
        with torch.no_grad():
            for key, d in self.dims.items():
                if d is None:
                    continue
                t = getattr(root, key) if key in self.buffers else getattr(*owners[key])
                t.data = piece(t.data, (d, 1), self.rank, self.n)
        sharded = [k for k, d in self.dims.items() if d is not None and k not in self.buffers]
        self._sharded_ids = {id(getattr(*owners[k])) for k in sharded}
        gathering = [(name, m) for name, m in root.named_modules() if any(_matches(name, u) for u in units)]
        self._entries: dict[int, list] = {id(m): [] for _, m in gathering}
        left = []
        for key in sharded:  # each piece gathered by the innermost unit that holds it
            held = [(name, m) for name, m in gathering if not name or key.startswith(name + ".")]
            if not held:
                left.append(key)
                continue
            self._entries[id(max(held, key=lambda nm: len(nm[0]))[1])].append((*owners[key], self.dims[key]))
        if left:
            raise ValueError(f"sharded parameters outside every gathering unit: {left[:4]}")
        for _, m in gathering:
            if self._entries[id(m)]:
                m.register_forward_pre_hook(self._install)
                m.register_forward_hook(self._restore, always_call=True)
        self._saved: dict[int, list] = {}

    # ---------------------------------------------------------------- forwards on whole weights

    def _install(self, unit, args):
        entries = self._entries[id(unit)]
        pieces = [m._parameters[name] for m, name, _ in entries]
        whole = _Gather.apply(tuple(d for _, _, d in entries), *pieces)
        self._saved[id(unit)] = pieces
        for (m, name, _), w in zip(entries, whole):
            m._parameters[name] = w

    def _restore(self, unit, args, output):
        for (m, name, _), p in zip(self._entries[id(unit)], self._saved.pop(id(unit))):
            m._parameters[name] = p

    # ---------------------------------------------------------------- gradients

    def grads_to_all_reduce(self, params: Iterable[torch.Tensor]) -> list[torch.Tensor]:
        """The parameters whose gradients a step still all-reduces: the ones
        that stay whole (the pieces' came reduce-scattered out of the gather)."""
        return [p for p in params if id(p) not in self._sharded_ids]

    def grad_norm(self, params: Iterable[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients of ``params`` (pieces and whole
        leaves), as one process's norm of the whole gradient."""
        params = [p for p in params if p.grad is not None]
        whole = self.grads_to_all_reduce(params)
        return global_sq_norm([p.grad for p in params if id(p) in self._sharded_ids], [p.grad for p in whole]).sqrt()

    # ---------------------------------------------------------------- sharded buffers

    def whole(self, name: str) -> torch.Tensor:
        """The whole buffer ``name`` of the root (a gather when it is sharded)."""
        t, d = getattr(self.root, name), self.dims[name]
        return t if d is None else gather_pieces([t], [d])[0]

    def mine(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole value of buffer ``name``."""
        d = self.dims[name]
        return whole if d is None else piece(whole, (d, 1), self.rank, self.n)

    # ---------------------------------------------------------------- the dense layout

    def spec(self, key: str) -> tuple[int, int] | None:
        """The key's spec for ``convert.shard_state_dict`` / ``tp.piece``."""
        d = self.dims.get(key)
        return None if d is None else (d, 1)

    def dense_state_dict(self, sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The whole state_dict from every rank's pieces of ``sd`` (a
        collective: one gather of every piece)."""
        keys = [k for k in sd if self.spec(k) is not None]
        whole = dict(zip(keys, gather_pieces([sd[k] for k in keys], [self.dims[k] for k in keys])))
        return {k: whole.get(k, v) for k, v in sd.items()}

    def dense_optimizer_state(self, opt_sd: dict, names: list[str]) -> dict:
        """An optimizer's state_dict with every per-parameter tensor of a
        sharded parameter made whole (one gather); ``names`` are its
        parameters' names in its order."""
        slots = [(i, k) for i, st in opt_sd["state"].items() for k, v in st.items()
                 if torch.is_tensor(v) and v.dim() > 0 and self.spec(names[i]) is not None]
        whole = gather_pieces([opt_sd["state"][i][k] for i, k in slots], [self.dims[names[i]] for i, _ in slots])
        state = {i: dict(st) for i, st in opt_sd["state"].items()}
        for (i, k), w in zip(slots, whole):
            state[i][k] = w
        return {**opt_sd, "state": state}


def shard_(root: nn.Module, units: Sequence[str] = ("",), buffers: Sequence[str] = ()) -> Shards:
    """Cut ``root``'s parameters (and its ``buffers``) to this rank's pieces
    over the data axis, in place, and gather them around each forward of
    the modules ``units`` names (paths under ``root``, "" the root itself,
    ``*`` one name). Returns the layout."""
    return Shards(root, units, buffers)
