"""Optimizers and LR schedules on ``torch.optim`` (port of ``audiossl_tpu.train.optim``).

The JAX package rebuilds torch's optimizers in optax; here they are torch's
own: ``sgd_torch`` is ``torch.optim.SGD`` with coupled weight decay (optax
``add_decayed_weights`` before ``trace``, whose first step, like torch's
momentum buffer, is the gradient itself), ``adam_torch`` is ``Adam``
(coupled decay), ``adamw_torch`` is ``AdamW`` (decoupled). A schedule is a
function of the update count, applied through ``LambdaLR``.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def sgd_torch(params: Iterable, lr: float, momentum: float = 0.9, weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


def adam_torch(params: Iterable, lr: float, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def adamw_torch(params: Iterable, lr: float, weight_decay: float = 1e-4, b1: float = 0.9, b2: float = 0.999) -> torch.optim.Optimizer:
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=weight_decay)


def warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int, end_lr_factor: float = 0.001) -> Schedule:
    """Linear 0 -> base over the warmup, then cosine from base to base *
    end_lr_factor (extras multi_proc.py:45-58)."""

    def sched(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        q = 0.5 * (1.0 + math.cos(math.pi * (step - warmup_steps) / max(total_steps - warmup_steps, 1)))
        return base_lr * q + base_lr * end_lr_factor * (1.0 - q)

    return sched


def build_optimizer(
    name: str, params: Iterable, lr: float | Schedule, **kw
) -> tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR | None]:
    """(optimizer, scheduler or None). ``lr`` is a rate or a schedule of the
    update count; step the scheduler once after each ``optimizer.step()``."""
    base = lr(0) if callable(lr) else lr
    name = name.lower()
    if name == "sgd":
        opt = sgd_torch(params, base, kw.get("momentum", 0.9), kw.get("weight_decay", 1e-4))
    elif name == "adam":
        opt = adam_torch(params, base, kw.get("weight_decay", 0.0))
    elif name == "adamw":
        opt = adamw_torch(params, base, kw.get("weight_decay", 1e-4))
    elif name in ("lars", "larc"):
        raise NotImplementedError(f"{name} is not ported yet: it belongs to the DECAR slice (ROADMAP.md Queue 1, item 14)")
    else:
        raise KeyError(f"unknown optimizer {name!r}")
    if not callable(lr):
        return opt, None
    for group in opt.param_groups:  # LambdaLR scales this rate by its factor
        group["lr"] = group["initial_lr"] = 1.0
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr)
