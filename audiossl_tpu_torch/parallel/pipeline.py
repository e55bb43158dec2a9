"""GPipe pipeline parallelism over a pipe group (port of
``audiossl_tpu.parallel.pipeline``).

JAX shards a stack of identical blocks over a ``pipe`` mesh axis: the
stacked parameters carry a leading [n_stages] axis sharded over it, and
``pipeline_forward`` runs inside ``shard_map`` as one ``lax.scan`` over
fill + steady + drain ticks, one ``ppermute`` a tick moving activations
downstream, the last stage's buffer psummed so the output is replicated;
``jax.grad`` through the scan runs the reverse ring. The port runs one
process per stage:

* ``stack_stage_params``: this rank's stage, an ``nn.Sequential`` of its
  blocks, built (or loaded) on this rank only;
* ``vit_block``: JAX's pre-LN ViT block (fused qkv, LayerNorm eps 1e-6,
  exact GELU) is the port's ``models.ast.ViTBlock``: the same math, its
  attention through ``ops.attention.fused_rel_attention`` with no bias (the
  Hopper kernels on CUDA, bf16 operands unless ``attention_dtype`` says
  otherwise; their plain versions on the CPU), where JAX's block computes a
  plain softmax;
* ``pipeline_forward(stage_fn, params, x_mb, group)``: GPipe over M
  microbatches and S stages. Stage s works at ticks s ... s + M - 1 (the
  ticks that carry a microbatch: JAX also computes on zeros during fill and
  drain, results it never records, so outputs and gradients are the same),
  stage 0 ingests microbatch t, one ``dist.exchange`` a tick moves the
  activations downstream, the last stage records microbatch t - (S - 1), and
  ``dist.sum_replicated`` makes the output whole on every rank. So a rank
  launches a stage's kernels M times forward (and M times backward).

Gradients. The schedule is one ``autograd.Function`` whose backward runs
the reverse schedule itself: every rank walks the ticks backwards, receives
its outputs' cotangent from downstream (the last stage: the output's), runs
its stage's backward (``torch.autograd.grad``) and sends its inputs'
cotangent upstream, so each rank makes its sends and receives in one tick
order, forward and backward, and no rank waits on a backward that autograd
did not schedule. Grad mode alone picks this Function (the same on every
rank): a rank whose stage is frozen and whose input needs no gradient
still walks the reverse ticks and passes the cotangents upstream. Every rank computes the same loss from the replicated
output and calls backward on it; the output collective's backward passes
that loss's cotangent as it is (a summed backward would give every stage S
times its gradient). Each rank then holds its own stage's gradients; the
input's gradient lives on stage 0 (zeros elsewhere: sum it over the group
for the whole). ``torch.utils.checkpoint`` on the stage is the counterpart
of ``jax.checkpoint`` (the stage's activations are recomputed in its
backward). ``dist.calls`` counts "pp_permute" (each rank's ticks that send
or receive, forward and backward) and "pp_output".
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from audiossl_tpu_torch.models.ast import ViTBlock
from audiossl_tpu_torch.parallel import dist


def vit_block(dim: int, num_heads: int, mlp_ratio: float = 4.0,
              attention_dtype: torch.dtype | None = None) -> ViTBlock:
    """JAX's ``vit_block`` as a module (``models.convert.vit_block_from_jax``
    loads its parameters)."""
    return ViTBlock(dim, num_heads, mlp_ratio, 0.0, attention_dtype)


def stage_range(depth: int, n_stages: int, stage: int) -> range:
    """The blocks of ``stage``: depth // n_stages of them, in order. Raises
    JAX's ValueError when the stages do not divide the depth."""
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    per = depth // n_stages
    return range(stage * per, (stage + 1) * per)


def stack_stage_params(make_block: Callable[[int], nn.Module], depth: int, group=None) -> nn.Sequential:
    """This rank's stage of a ``depth``-block stack over ``group`` (JAX's
    stacked parameters, sharded over the pipe axis): ``make_block(i)`` for
    its blocks i only."""
    n, s = dist.world(group), dist.rank(group)
    return nn.Sequential(*(make_block(i) for i in stage_range(depth, n, s)))


def _shift(t: int, n_stages: int, n_micro: int) -> list[tuple[int, int]]:
    """Tick t's pairs: stage i sends downstream when it worked at t."""
    return [(i, i + 1) for i in range(n_stages - 1) if 0 <= t - i < n_micro]


def _run_forward(stage_fn, x_mb: torch.Tensor, group, keep: bool):
    """The forward schedule on this rank: the last stage's buffer [M, mb,
    ...] (zeros elsewhere) and, with ``keep``, each worked tick's (input
    leaf, output) for the backward."""
    n, s, m = dist.world(group), dist.rank(group), x_mb.shape[0]
    out = torch.zeros_like(x_mb)
    saved, act = [], None
    for t in range(m + n - 1):
        y = None
        if 0 <= t - s < m:
            a = x_mb[t] if s == 0 else act
            if keep:
                a = a.detach().requires_grad_()
            with torch.enable_grad() if keep else torch.no_grad():
                y = stage_fn(a)
            if keep:
                saved.append((a, y))
            if s == n - 1:
                out[t - s] = y.detach()
        act = dist.exchange(y, x_mb[0], _shift(t, n, m), group, "pp_permute")
    return out, saved


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, anchor, x_mb, *params):
        ctx.group, ctx.params, ctx.shape, ctx.x_dtype = group, params, x_mb.shape, x_mb.dtype
        out, ctx.saved = _run_forward(stage_fn, x_mb, group, keep=True)
        return out

    @staticmethod
    def backward(ctx, g_out):
        group, saved = ctx.group, ctx.saved
        n, s, m = dist.world(group), dist.rank(group), ctx.shape[0]
        params = ctx.params
        dx = torch.zeros(ctx.shape, dtype=ctx.x_dtype, device=g_out.device) if ctx.needs_input_grad[3] else None
        dparams: list[torch.Tensor | None] = [None] * len(params)
        da = None  # this stage's input cotangent of the tick after, sent upstream at this tick's step
        for t in reversed(range(m + n - 1)):
            pairs = [(j, i) for i, j in _shift(t, n, m)]
            dy = dist.exchange(da, g_out[0], pairs, group, "pp_permute")
            da = None
            if 0 <= t - s < m:
                a, y = saved.pop()
                if s == 0 and dx is None and not params:  # a frozen first stage: nothing to take
                    continue
                if s == n - 1:
                    dy = g_out[t - s]
                # the vector-Jacobian product as the gradient of sum(y * dy): the same
                # numbers as grad(y, ..., dy), without autograd.grad's shape check of
                # a given cotangent, whose first call imports sympy (~1 s a process,
                # paid in turn along the stages)
                with torch.enable_grad():
                    vjp = (y * dy).sum()
                grads = torch.autograd.grad(vjp, [a, *params], allow_unused=True)
                da = grads[0]
                for i, g in enumerate(grads[1:]):
                    if g is not None:
                        dparams[i] = g if dparams[i] is None else dparams[i] + g
                if s == 0 and dx is not None:
                    dx[t] = da
        return (None, None, None, dx, *dparams)


def pipeline_forward(stage_fn: Callable[[torch.Tensor], torch.Tensor], params: Sequence[torch.Tensor],
                     x_mb: torch.Tensor, group=None) -> torch.Tensor:
    """[M, mb, ...] microbatches (every rank passes them; stage 0 reads them)
    through the stages of ``group`` -> [M, mb, ...] on every rank.

    ``stage_fn``: this rank's stage, activation -> the same shape (a stage
    from ``stack_stage_params``, or a function of it such as
    ``torch.utils.checkpoint``); ``params``: the tensors it reads that take
    gradients (its parameters). With grad mode on, the schedule is
    differentiable on every rank, whatever its own stage or ``x_mb``
    requires (a frozen stage still passes the cotangents upstream), and
    every rank must call backward on the same loss; under
    ``torch.no_grad()`` it keeps nothing for a backward. The choice is grad
    mode's alone, so the ranks agree on it."""
    params = [p for p in params if p.requires_grad]
    if torch.is_grad_enabled():
        # the anchor makes the output require grad on a rank whose stage and
        # input need none, so that its backward runs the reverse schedule too
        anchor = x_mb.new_empty(0).requires_grad_()
        out = _GPipe.apply(stage_fn, group, anchor, x_mb, *params)
    else:
        out, _ = _run_forward(stage_fn, x_mb, group, keep=False)
    return output_sum(out, group)


def output_sum(buffer: torch.Tensor, group) -> torch.Tensor:
    """The last stage's buffer made whole on every rank (JAX's psum of it to
    an unmapped output); its backward hands the stage the one loss's
    cotangent."""
    return dist.sum_replicated(buffer, group, "pp_output")
