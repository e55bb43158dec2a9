"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the output check, the result line."""
from __future__ import annotations

import gc
import importlib
import math
import time

import torch

from portbench.harness import report, spec, trace
from portbench.harness.common import power_limit


def reader(metric: dict):
    """The metric's reader: ``metrics/<name before the first dot>.py``."""
    return importlib.import_module(f"portbench.metrics.{metric['name'].split('.', 1)[0]}")


def per_layer_value(metric: dict, ctx: dict) -> float | None:
    """The metric's reader on the run's readings; None where it finds nothing to read."""
    return reader(metric).read(ctx)


def run(workload: str, seed: int, seconds: float, traced: bool, t_start: float) -> int:
    cell = spec.load_cell(workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        report.note(f"this cell needs {cell.chips} CUDA device(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    return run_cell(cell, seed, seconds, traced, t_start, torch.device("cuda", 0))


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, t_start: float, device: torch.device) -> int:
    """The run after the look for the card (the tests drive it on the CPU)."""
    cuda = device.type == "cuda"
    loop_cls = importlib.import_module(f"portbench.loops.{cell.loop}").Loop
    loop = loop_cls(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    win = loop.window(seconds)
    ctx = {"window": win}
    if traced:
        if hasattr(loop, "back_to_back"):
            ctx["back_to_back"] = loop.back_to_back()
        ctx["trace"], ctx["spans"], ctx["trace_window_s"] = trace.profiled_window(
            loop.profiled, [reader(m) for m in cell.per_layer])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = loop.checks()
    bad = report.forbidden_modules()
    if bad:
        report.note(f"modules of JAX or of the JAX package were loaded: {bad}: no result")
        return 3
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks) and win["failed"] == 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        tr = ctx["trace"]
        metrics = {}
        for m in cell.per_layer:
            v = per_layer_value(m, ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=tr["busy_s"], window_s=ctx["trace_window_s"])
        breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        report.note(f"traced window: {ctx['trace_window_s']} s, device busy {tr['busy_s']} s, "
                    f"{tr['device_events']} device events ({tr['unplaced_device_events']} without a launch record); "
                    f"layer device s {tr['span_s']}; calls {dict(ctx['spans'].calls)}; "
                    f"least s {dict(ctx['spans'].bound)}")
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    for line in win["lines"] + ctx.get("back_to_back", {}).get("lines", []):
        report.note(line)
    phases = {k: round(v - t_start, 3) for k, v in getattr(loop, "phases", {}).items()}
    report.note(f"set-up phases (s from the process start): {phases}")
    report.note(f"setup_s {setup_s}; memory_peak_bytes {peak}; card {device_info['kind']}; "
                f"power limit {power_limit() if cuda else None}")
    for line in getattr(loop, "notes", []):
        report.note(line)
    for name, value, limit in checks:
        report.note(f"check {name} {value} limit {limit}")
    print(report.result_line(correct, win["attempted"], win["failed"], metrics, device_info, checks, breakdown),
          flush=True)
    return 0
