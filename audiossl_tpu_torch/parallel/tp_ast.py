"""Tensor-parallel AST: Megatron head sharding of the ViT encoder (port of
``audiossl_tpu.parallel.tp_ast``).

Per ViT block, as JAX's ``_block_spec`` lays the flax tree out:

* the attention's q, k and v are head-sharded (column-parallel): the port's
  AST keeps timm's one fused ``attn.qkv`` Linear [3D, D] whose rows run
  (q, k, v) x heads x head_dim, so rank t holds the q, k and v rows of heads
  [t·H/tp, (t+1)·H/tp): three blocks, spec (0, 3), not one contiguous slice.
  Each rank runs its H/tp heads end to end through the attention kernels;
* ``attn.proj`` is row-parallel (its input columns, spec (1, 1)), then one
  all-reduce rejoins the residual stream;
* ``mlp.fc1`` is column-parallel (rows, spec (0, 1)), ``mlp.fc2``
  row-parallel (columns), one all-reduce;
* the patch embedding, the cls / dist tokens, the positional embedding and
  every LayerNorm stay replicated, as do the biases after an all-reduce.

``ast_spec`` gives an AST state-dict key's spec by its name (the
encoder's own keys, or under a prefix such as a DownstreamModel's
``encoder.``); ``ast_tp_specs`` maps a whole state_dict and raises JAX's
ValueErrors when the heads or the MLP hidden width do not divide by tp;
``shard_ast_`` shards an encoder in place for this rank of the model
axis (parallel/dist.py) and switches its blocks to the tp forward
(models/ast.py). The JAX package runs the same layout through GSPMD with its
Pallas attention off (GSPMD cannot partition it); the port keeps the
attention kernels on, each rank on its own heads.
"""
from __future__ import annotations

import re
from typing import Mapping

from torch import nn

from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel.tp import shard_parameters_

_BLOCK = re.compile(r"(^|\.)blocks\.\d+\.(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)\.(weight|bias)$")


def ast_spec(key: str) -> tuple[int, int] | None:
    """The spec (dim, groups) of a state-dict key, by its name alone; None
    for a replicated tensor."""
    m = _BLOCK.search(key)
    if m is None or (m.group(2) in ("attn.proj", "mlp.fc2") and m.group(3) == "bias"):
        return None
    return {"attn.qkv": (0, 3), "mlp.fc1": (0, 1)}.get(m.group(2), (1, 1))


def ast_tp_specs(sd: Mapping, tp: int, num_heads: int) -> dict[str, tuple[int, int] | None]:
    """Key -> spec for a whole (unsharded) state_dict, with JAX's checks."""
    for key, v in sd.items():
        m = _BLOCK.search(key)
        if m and m.group(2) == "attn.qkv" and num_heads % tp:
            raise ValueError(f"tensor parallelism needs num_heads divisible by the model axis: {num_heads} "
                             f"heads vs tp={tp} (at {key})")
        if m and m.group(2) == "mlp.fc1" and v.shape[0] % tp:
            raise ValueError(f"tensor parallelism needs the MLP hidden dim divisible by the model axis: "
                             f"{v.shape[0]} vs tp={tp} (at {key})")
    return {key: ast_spec(key) for key in sd}


def shard_ast_(encoder: nn.Module) -> None:
    """Shard an ``ASTEncoder`` in place for this rank's place on the model
    axis (``dist.tp_rank()`` of ``dist.tp_world()``)."""
    from audiossl_tpu_torch.models.ast import Attention, Mlp

    tp = dist.tp_world()
    shard_parameters_(encoder, ast_tp_specs(encoder.state_dict(), tp, encoder.cfg.num_heads), dist.tp_rank(), tp)
    for m in encoder.modules():
        if isinstance(m, (Attention, Mlp)):
            m.tp = tp
