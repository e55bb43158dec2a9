"""Tensor-parallel building blocks over the model axis (port of
``audiossl_tpu.parallel.tp``).

The JAX package shards its encoders with GSPMD: ``jax.jit`` with the
weights' PartitionSpecs, and XLA's partitioner inserts the collectives.
PyTorch has no partitioner, so the port writes the Megatron form out: the
model axis is ``dist.model_group()`` (parallel/dist.py's dp x tp grid), each
rank holds its shard of a weight as an ordinary parameter, and four pairs
of conjugate autograd Functions carry the activations between the
replicated and the sharded layout:

* ``copy_to_model``: identity forward, all-reduce-sum backward; it goes in
  front of a column-parallel layer, whose input is replicated but whose
  rank sees only its own columns' share of the input's gradient;
* ``reduce_from_model``: all-reduce-sum forward, identity backward; it goes
  after a row-parallel layer, whose partial products sum to the replicated
  output (a summed backward here would scale every replicated gradient by
  tp);
* ``gather_from_model``: all-gather along the last dim forward, this rank's
  slice backward: MViT's qkv, whose output columns are gathered so that
  the pooling and the attention run replicated;
* ``scatter_to_model``: this rank's slice forward, all-gather backward: the
  input of MViT's row-parallel ``attn.proj``, sliced out of the replicated
  attention output.

``column_parallel``, ``row_parallel`` and ``tp_mlp`` are the JAX module's
functions on these, with weights in torch's Linear layout ([out, in]):
the sharded AST and MViT layers run through them. A module's ``tp``
(set by ``shard_ast_`` / ``shard_mvit_``) selects its sharded forward;
``sharded`` checks it against the model group, so one decision holds for
the module and the collectives. A weight's sharding is a spec (dim,
groups), or None for a replicated one: ``piece`` cuts a rank's piece,
``gather`` joins the pieces, ``shard_parameters_`` shards a module in place
and ``gather_from_ranks`` rebuilds a whole tensor across the model axis.
With tp = 1 every function is the identity on its input, with no
collective. ``dist.calls`` counts each collective by kind ("tp_copy",
"tp_reduce", "tp_gather", "tp_scatter"; forward and backward each count
one).
"""
from __future__ import annotations

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from audiossl_tpu_torch.parallel import dist


def _all_reduce(x: torch.Tensor, kind: str) -> torch.Tensor:
    dist.calls[kind] += 1
    out = x.detach().clone().contiguous()
    tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=dist.model_group())
    return out


def _all_gather_last(x: torch.Tensor, kind: str) -> torch.Tensor:
    dist.calls[kind] += 1
    parts = [torch.empty_like(x) for _ in range(dist.tp_world())]
    tdist.all_gather(parts, x.detach().contiguous(), group=dist.model_group())
    return torch.cat(parts, dim=-1)


def _own_slice(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1] // dist.tp_world()
    return x[..., dist.tp_rank() * n:(dist.tp_rank() + 1) * n].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "tp_copy")


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_gather_last(x, "tp_gather")

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _own_slice(x)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, "tp_scatter")


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient summed over the model axis."""
    return _Copy.apply(x) if dist.tp_world() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model axis; the gradient passed through as it is."""
    return dist.sum_replicated(x, dist.model_group(), "tp_reduce") if dist.tp_world() > 1 else x


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The model axis's last-dim pieces joined in rank order; backward keeps
    this rank's piece of the (replicated) gradient."""
    return _Gather.apply(x) if dist.tp_world() > 1 else x


def scatter_to_model(x: torch.Tensor) -> torch.Tensor:
    """This rank's last-dim piece of a replicated tensor; backward joins the
    pieces' gradients into the whole one."""
    return _Scatter.apply(x) if dist.tp_world() > 1 else x


def sharded(tp: int) -> bool:
    """Whether a module sharded ``tp`` ways runs its sharded forward: it
    must be run by a model group of that size."""
    if tp != 1 and tp != dist.tp_world():
        raise RuntimeError(f"a module sharded {tp} ways runs in a model group of {dist.tp_world()}")
    return tp > 1


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor, b_shard: torch.Tensor | None = None) -> torch.Tensor:
    """[..., D] x [F/M, D] -> [..., F/M]: the output stays sharded over the
    model axis; ``x`` is cast to the weight's dtype after the copy, so the
    gradient is summed in x's."""
    return F.linear(copy_to_model(x).to(w_shard.dtype), w_shard, b_shard)


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """[..., D/M] x [F, D/M] -> the sum over the model axis, [..., F]
    replicated; the bias is added once, after the sum."""
    y = reduce_from_model(F.linear(x_shard.to(w_shard.dtype), w_shard))
    return y if b is None else y + b


def tp_mlp(x: torch.Tensor, w1_shard: torch.Tensor, w2_shard: torch.Tensor, b1_shard: torch.Tensor | None = None,
           b2: torch.Tensor | None = None, act=torch.relu) -> torch.Tensor:
    """Column -> ``act`` -> row (JAX's: ReLU, no biases): one all-reduce
    forward and one backward."""
    return row_parallel(act(column_parallel(x, w1_shard, b1_shard)), w2_shard, b2)


def piece(w: torch.Tensor, spec: tuple[int, int], rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s piece of ``w`` under ``spec`` = (dim, groups): dim
    ``dim`` split n ways; with ``groups`` > 1 that dim is ``groups`` equal
    blocks (AST's q, k, v rows) and the piece is the rank's part of each
    block, joined."""
    dim, groups = spec
    blocks = w.chunk(groups, dim=dim)
    return torch.cat([b.chunk(n, dim=dim)[rank] for b in blocks], dim=dim).contiguous()


def gather(shards: list[torch.Tensor], spec: tuple[int, int]) -> torch.Tensor:
    """The inverse of ``piece``: the whole tensor from every rank's piece,
    in rank order."""
    dim, groups = spec
    parts = [s.chunk(groups, dim=dim) for s in shards]
    return torch.cat([p[g] for g in range(groups) for p in parts], dim=dim).contiguous()


def shard_parameters_(module: torch.nn.Module, specs: dict, rank: int, n: int) -> None:
    """Replace each parameter that ``specs`` names (state-dict keys -> spec,
    None: replicated) by rank ``rank``'s piece, in place; build the
    optimizer after this, so that its moments are shard-sized."""
    for name, p in module.named_parameters():
        if specs.get(name) is not None:
            p.data = piece(p.data, specs[name], rank, n)


def gather_from_ranks(x: torch.Tensor, spec: tuple[int, int] | None) -> torch.Tensor:
    """The whole tensor from this model group's pieces of it (a collective
    over the model axis; a replicated tensor comes back as it is)."""
    if spec is None or dist.tp_world() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.tp_world())]
    tdist.all_gather(parts, x.detach().contiguous(), group=dist.model_group())
    return gather(parts, spec)


def dense_state_dict(sd: dict, spec_of) -> dict:
    """The whole state_dict from this model group's shards of ``sd``
    (``spec_of``: key -> spec or None); a collective over the model axis,
    one all-gather for each sharded tensor, in ``sd``'s key order."""
    return {k: gather_from_ranks(v, spec_of(k)) for k, v in sd.items()}


def map_optimizer_state(opt_sd: dict, names: list[str], fn) -> dict:
    """An optimizer's state_dict with ``fn(tensor, parameter name)`` applied
    to each per-parameter tensor of the parameter's shape (AdamW's moments;
    ``step`` counters stay): ``names`` are the names of the optimizer's
    parameters in its order."""
    state = {i: {k: fn(v, names[i]) if torch.is_tensor(v) and v.dim() > 0 else v for k, v in st.items()}
             for i, st in opt_sd["state"].items()}
    return {**opt_sd, "state": state}
