"""Optimizers and LR schedules on ``torch.optim`` (port of ``audiossl_tpu.train.optim``).

The JAX package rebuilds torch's optimizers in optax; here they are torch's
own: ``sgd_torch`` is ``torch.optim.SGD`` with coupled weight decay (optax
``add_decayed_weights`` before ``trace``, whose first step, like torch's
momentum buffer, is the gradient itself), ``adam_torch`` is ``Adam``
(coupled decay), ``adamw_torch`` is ``AdamW`` (decoupled). ``Lars`` and
``Larc`` are written here as ``torch.optim.Optimizer``s with the JAX
package's semantics (its optax transforms, train/optim.py:45-127). A
schedule is a function of the update count, applied through ``LambdaLR``.
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


class Lars(torch.optim.Optimizer):
    """LARS of extras/delores-s (multi_proc.py:4-43 + main.py:81-93): a
    parameter of more than one dimension takes coupled weight decay and the
    trust ratio eta * |p| / |g + wd * p| (1 where either norm is 0); 1-D
    parameters (biases, norm scales) take neither. Then mu = momentum * mu +
    update, and p -= lr * scale * mu with scale ``weights_lr_scale`` (0.2)
    or, for 1-D parameters, ``biases_lr_scale`` (0.0048).

    The JAX package's optax ``lars`` adds lr * scale * mu instead (its
    update is negated twice, ROADMAP.md Queue 3); the port descends, as the
    reference does."""

    def __init__(self, params: Iterable, lr: float, weight_decay: float = 1e-6, momentum: float = 0.9,
                 eta: float = 0.001, weight_decay_filter: bool = True, lars_adaptation_filter: bool = True,
                 weights_lr_scale: float = 0.2, biases_lr_scale: float = 0.0048):
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay, momentum=momentum, eta=eta, weight_decay_filter=weight_decay_filter,
            lars_adaptation_filter=lars_adaptation_filter, weights_lr_scale=weights_lr_scale,
            biases_lr_scale=biases_lr_scale))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for g in self.param_groups:
            for p in g["params"]:
                if p.grad is None:
                    continue
                one_d = p.ndim == 1
                dp = p.grad
                if not (g["weight_decay_filter"] and one_d):
                    dp = dp + g["weight_decay"] * p
                if not (g["lars_adaptation_filter"] and one_d):
                    p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(dp)
                    one = torch.ones_like(p_norm)
                    dp = dp * torch.where(p_norm > 0, torch.where(u_norm > 0, g["eta"] * p_norm / u_norm, one), one)
                state = self.state[p]
                mu = state.get("mu")
                state["mu"] = mu = dp.clone() if mu is None else mu.mul_(g["momentum"]).add_(dp)
                scale = g["biases_lr_scale"] if one_d else g["weights_lr_scale"]
                p.add_(mu, alpha=-g["lr"] * scale)
        return loss


class Larc(torch.optim.Optimizer):
    """apex ``LARC`` around SGD with coupled weight decay, as the JAX
    package's optax ``larc`` (decar-v2/main.py:93-111): per parameter the
    adaptive rate trust * |p| / (|g| + wd * |p| + eps), divided by the
    step's rate and capped at 1 with ``clip``, scales g + wd * p (scale 1
    where |p| or |g| is 0, so a zero gradient still carries its decay);
    then the momentum trace and p -= lr * trace. The first trace is the
    first update, as torch's SGD and optax's ``trace`` both start."""

    def __init__(self, params: Iterable, lr: float, momentum: float = 0.9, weight_decay: float = 1e-6,
                 trust_coefficient: float = 0.001, clip: bool = True, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      trust_coefficient=trust_coefficient, clip=clip, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for g in self.param_groups:
            wd, lr = g["weight_decay"], g["lr"]
            for p in g["params"]:
                if p.grad is None:
                    continue
                p_norm, g_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(p.grad)
                scale = g["trust_coefficient"] * p_norm / (g_norm + p_norm * wd + g["eps"])
                if g["clip"]:
                    scale = torch.clamp(scale / max(lr, 1e-12), max=1.0)
                scale = torch.where((p_norm > 0) & (g_norm > 0), scale, torch.ones_like(scale))
                d = scale * (p.grad + wd * p)
                state = self.state[p]
                buf = state.get("momentum_buffer")
                state["momentum_buffer"] = buf = d.clone() if buf is None else buf.mul_(g["momentum"]).add_(d)
                p.add_(buf, alpha=-lr)
        return loss


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
    elif name == "lars":
        opt = Lars(params, base, **kw)
    elif name == "larc":
        opt = Larc(params, base, **kw)
    else:
        raise KeyError(f"unknown optimizer {name!r}")
    if not callable(lr):
        return opt, None
    for group in opt.param_groups:  # LambdaLR scales this rate by its factor
        group["lr"] = group["initial_lr"] = 1.0
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr)
