"""Tensor-parallel MViT / MAST: Megatron weight sharding of the MViTv2
blocks (port of ``audiossl_tpu.parallel.tp_mvit``).

Per MultiScale block, as JAX's ``_block_spec`` lays the flax tree out:

* the fused ``attn.qkv`` (torch [3·dim_out, dim]) is column-parallel: tp
  contiguous pieces of its output rows, exactly JAX's split of the kernel's
  columns, so rank t's shard is JAX's addressable shard t leaf for leaf.
  MViT packs its columns (3, heads, head_dim)-major and its first stage has
  one head, so the output is all-gathered to [B, N, 3·dim_out] and the
  pooling convs, the rel-pos bias and the attention middle run replicated,
  where JAX's partitioner leaves them: every rank launches the attention
  kernels on all heads;
* ``attn.proj`` is row-parallel: each rank takes its dim_out / tp columns of
  the (replicated) attention output, then one all-reduce;
* ``mlp.fc1`` / ``mlp.fc2`` are the column / row pair, one all-reduce;
* the pooling convs, the rel-pos tables, the norms, the block's dim-change
  ``proj``, the patch embedding and SS-MAST's head stay replicated.

``mvit_spec`` keys on state-dict names alone (any ``blocks.{i}`` under any
prefix), so one rule covers the query tower, the EMA key tower and the
AdamW moments (JAX's ``tp_state_shardings``); ``mvit_tp_specs`` maps a whole
state_dict and raises JAX's ValueErrors when dim_out or the MLP hidden
width do not divide by tp; ``shard_mvit_``
shards a module in place for this rank of the model axis and switches its
blocks to the tp forward (models/mvit.py).
"""
from __future__ import annotations

import re
from typing import Mapping

from torch import nn

from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel.tp import shard_parameters_

_BLOCK = re.compile(r"(^|\.)blocks\.\d+\.(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)\.(weight|bias)$")


def mvit_spec(key: str) -> tuple[int, int] | None:
    """The spec (dim, groups) of a state-dict key, by its name alone; None
    for a replicated tensor."""
    m = _BLOCK.search(key)
    if m is None or (m.group(2) in ("attn.proj", "mlp.fc2") and m.group(3) == "bias"):
        return None
    return (0, 1) if m.group(2) in ("attn.qkv", "mlp.fc1") else (1, 1)


def mvit_tp_specs(sd: Mapping, tp: int) -> dict[str, tuple[int, int] | None]:
    """Key -> spec for a whole (unsharded) state_dict, with JAX's checks."""
    for key, v in sd.items():
        m = _BLOCK.search(key)
        if m and m.group(2) == "attn.qkv" and (v.shape[0] // 3) % tp:
            raise ValueError(f"tensor parallelism needs the attention dim_out divisible by the model axis: "
                             f"{v.shape[0] // 3} vs tp={tp} (at {key})")
        if m and m.group(2) == "mlp.fc1" and v.shape[0] % tp:
            raise ValueError(f"tensor parallelism needs the MLP hidden dim divisible by the model axis: "
                             f"{v.shape[0]} vs tp={tp} (at {key})")
    return {key: mvit_spec(key) for key in sd}


def shard_mvit_(module: nn.Module) -> None:
    """Shard every MViT inside ``module`` (an objective holding a query and a
    key tower, a MASTWithHead, a trunk) in place for this rank's place on
    the model axis."""
    from audiossl_tpu_torch.models.mvit import Mlp, MultiScaleAttention

    tp = dist.tp_world()
    shard_parameters_(module, mvit_tp_specs(module.state_dict(), tp), dist.tp_rank(), tp)
    for m in module.modules():
        if isinstance(m, (MultiScaleAttention, Mlp)):
            m.tp = tp
