"""Profiling and failure detection (port of ``audiossl_tpu.utils.profiling``).

The reference's observability surface: a trace capture (``torch.profiler``,
where the JAX package takes ``jax.profiler``), a device timer (CUDA events
on a CUDA tensor, as the reference's gpu_timer, extras/mast_new/mast/utils.py:60-75;
the wall clock otherwise), FLOP and parameter counts (fvcore's,
mvit/utils/misc.py:48-166: here ``torch.utils.flop_counter``) and the
NaN-loss guard (check_nan_losses, mvit/utils/misc.py:21-28).
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str = "runs/torch_trace"):
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the card
    when one is present) into ``<log_dir>/trace.json`` (chrome://tracing or
    Perfetto); yields the profiler, whose ``key_averages()`` tabulates it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def device_timer(name: str = "block", sync_value: torch.Tensor | None = None):
    """Time a region into ``out["seconds"]``. With a CUDA ``sync_value``: CUDA
    events on the current stream around the block (the device's time, the
    host's gaps included); otherwise the wall clock."""
    out: dict = {"name": name}
    cuda = sync_value is not None and sync_value.is_cuda
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        if cuda:
            end.record()
            end.synchronize()
            out["seconds"] = start.elapsed_time(end) / 1e3
        else:
            out["seconds"] = time.perf_counter() - t0


def check_nan_loss(loss: float, step: int | None = None) -> None:
    """Stop at once on a NaN or infinite loss."""
    if not np.isfinite(loss):
        raise FloatingPointError(f"loss became {loss} at step {step}; stopping training")


def params_count(params) -> int:
    """Elements of a module's parameters, a state dict or a list of tensors."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    elif isinstance(params, dict):
        params = list(params.values())
    return sum(int(np.prod(tuple(p.shape))) for p in params)


def flops_estimate(fn, *args) -> float | None:
    """Floating-point operations of one call of ``fn(*args)`` as
    ``torch.utils.flop_counter`` counts them (a matmul of [m, k] x [k, n]
    counts 2 m k n); None when the count fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:
        return None
