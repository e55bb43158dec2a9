"""Pipeline-parallel AST: the encoder's depth over a pipe group (port of
``audiossl_tpu.parallel.pipeline_ast``).

The JAX module runs ``ASTEncoder``'s flax parameters as pure functions: the
patchify / cls / dist / positional prologue, the ``block{i}`` parameters
grouped into per-stage stacks through ``pipelined_apply``, and the final
LayerNorm / token-mean epilogue. The port's stage is a slice of the port's
own ``models.ast.ASTEncoder.blocks`` (its ``ViTBlock``, JAX's ``ast_block``
twin), and the prologue and epilogue are the encoder's own ``embed`` and
``pool``; so an AST checkpoint (``models.convert.ast_from_flax``) serves
pipelined without any change of weights. In eval mode
``pipelined_ast_forward`` equals the one-process ``ASTEncoder`` on the same
weights. On CUDA every block's attention runs the no-bias attention kernel
(bf16 operands unless the encoder's ``attention_dtype`` says otherwise):
M microbatches through a stage of depth / S blocks launch it
M * depth / S times a rank.
"""
from __future__ import annotations

import torch
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.models.ast import ASTEncoder
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel.pipeline import pipeline_forward, stage_range


def ast_prologue(encoder: ASTEncoder, x: torch.Tensor) -> torch.Tensor:
    """[B, 1, F, T] log-fbank -> [B, N + 2, D] tokens."""
    with no_tf32():
        return encoder.embed(x)


def ast_epilogue(encoder: ASTEncoder, x: torch.Tensor) -> torch.Tensor:
    """[B, N + 2, D] -> [B, D]: the final LayerNorm and (cls + dist) / 2."""
    return encoder.pool(x)


def ast_stage_stack(encoder: ASTEncoder, n_stages: int, stage: int) -> nn.Sequential:
    """Stage ``stage`` of ``n_stages``: its slice of ``encoder.blocks``.
    Raises ValueError when the stages do not divide the depth."""
    return nn.Sequential(*(encoder.blocks[i] for i in stage_range(len(encoder.blocks), n_stages, stage)))


def pipelined_ast_forward(encoder: ASTEncoder, x: torch.Tensor, n_micro: int, group=None) -> torch.Tensor:
    """[B, 1, F, T] -> [B, D] == ``encoder(x)`` in eval mode, the blocks run
    as ``group``'s stages (every rank passes the whole batch and gets the
    whole output). Raises ValueError, before any collective, when the
    stages do not divide the depth or ``n_micro`` does not divide B."""
    n = dist.world(group)
    stage = ast_stage_stack(encoder, n, dist.rank(group))
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro {n_micro}")
    tokens = ast_prologue(encoder, x)
    b = tokens.shape[0]
    x_mb = tokens.reshape(n_micro, b // n_micro, *tokens.shape[1:])
    with no_tf32():
        out = pipeline_forward(stage, list(stage.parameters()), x_mb, group)
    return ast_epilogue(encoder, out.reshape(b, *tokens.shape[1:]))
