"""Gradient accumulation: trade steps for activation memory (port of
``audiossl_tpu.train.accum``).

Split the batch into A microbatches, run forward and backward per
microbatch (the activations of one microbatch live at a time), average the
gradients, and apply ONE optimizer update.

Where this is *exact* (microbatched grads == full-batch grads up to fp
summation order):

* per-sample-decomposable mean losses — supervised BCE/CE (the MAST
  fine-tuner), MoCo-style InfoNCE whose negatives come from the *queue*
  rather than the batch — through LayerNorm models (MViT/AST).

Where it is NOT exact, and therefore not offered:

* batch-coupled losses — Barlow cross-correlation (DeLoRes-S/M taps,
  c = z1ᵀz2/B couples every sample), SLICER's cluster loss over the
  batch assignment matrix, BatchNorm batch statistics (AudioNTT): a
  microbatch estimate of those statistics changes the objective, which
  is exactly the shuffle-BN class of bug the reference fights. Those
  trainers are lightweight (AudioNTT fits B=1024 easily), so the lever
  is not needed there.

Augmentation draws (mixup partners, SpecMask) happen per microbatch:
same distribution as the reference's per-dataloader-batch draws, but
mixup partners are drawn within the microbatch — disable the augs for
bitwise parity checks.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def split_batch(batch: Any, accum: int) -> list[Any]:
    """``batch`` (a tensor, or a tuple / list / dict of them, each with the
    batch as its leading dim) -> A microbatches of contiguous slices. Raises
    JAX's ValueError for a batch that A does not divide."""
    if isinstance(batch, torch.Tensor):
        b = batch.shape[0]
        if b % accum:
            raise ValueError(f"per-chip batch {b} not divisible by grad_accum_steps {accum}")
        return list(batch.split(b // accum))
    if isinstance(batch, dict):
        parts = {k: split_batch(v, accum) for k, v in batch.items()}
        return [{k: v[j] for k, v in parts.items()} for j in range(accum)]
    parts = [split_batch(v, accum) for v in batch]
    return [type(batch)(p[j] for p in parts) for j in range(accum)]


def grads_of(loss: torch.Tensor, params: list[torch.Tensor]) -> list[torch.Tensor]:
    """d loss / d params, zeros for a parameter the loss does not reach."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def microbatched_value_and_grad(
    loss_fn: Callable[[Any, int], torch.Tensor],
    accum: int,
) -> Callable[[Sequence[torch.Tensor], Any], tuple[torch.Tensor, list[torch.Tensor]]]:
    """value_and_grad over A sequential microbatches, averaged.

    ``loss_fn(microbatch, j) -> scalar`` must be a mean-reduced,
    per-sample-decomposable loss of the parameters; ``j`` is the
    microbatch's index, so each microbatch takes its own draws (in order,
    from the caller's generator). Returns ``fn(params, batch) -> (loss,
    grads)``, the microbatch averages, the loss detached and the gradients in
    each parameter's dtype. With ``accum == 1`` this is exactly one forward
    and one backward. Gradients accumulate in f32 whatever the parameter
    dtype, each as g / A, so A-long sums do not lose mantissa.
    """
    if accum < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")

    def fn(params: Sequence[torch.Tensor], batch: Any) -> tuple[torch.Tensor, list[torch.Tensor]]:
        params = list(params)
        if accum == 1:
            loss = loss_fn(batch, 0)
            return loss.detach(), grads_of(loss, params)
        micro = split_batch(batch, accum)
        acc_loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
        for j, mb in enumerate(micro):
            loss = loss_fn(mb, j)
            grads = grads_of(loss, params)
            torch._foreach_add_(acc, [g.float() / accum for g in grads])
            acc_loss += loss.detach().float() / accum
        return acc_loss, [g.to(p.dtype) for g, p in zip(acc, params)]

    return fn


def set_grads(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
    """``p.grad = g`` for each pair (what ``loss.backward()`` would leave on
    freshly zeroed parameters)."""
    for p, g in zip(params, grads):
        p.grad = g
