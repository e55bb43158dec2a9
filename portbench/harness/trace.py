"""The traced window: spans around the port's entry points, the profiler's
trace, and what is read from it.

``Spans`` wraps the port's entry functions that the cell's per-layer
metric readers declare (``WRAPS`` under the reader's ``LAYER``) in
``record_function`` ranges named ``portbench.<layer>`` and keeps each call's
least time from its arguments. The device time of a layer is that of every
kernel, copy and fill launched inside its ranges, so a later kernel that
takes over the work is counted the same. ``read_trace`` reduces the profiler's chrome trace to the union
of the device's busy intervals, the device time of each layer, the
operations that took most time and the longest idle gaps by what the host
was doing.
"""
from __future__ import annotations

import bisect
import collections
import importlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "portbench."


class Spans:
    """Install with ``with Spans(readers) as spans:``, ``readers`` being the
    cell's per-layer metric modules; ``spans.bound[layer]`` is the sum of
    the least times of the calls made meanwhile."""

    def __init__(self, readers=()):
        self.readers = list(readers)
        self.bound: dict[str, float] = collections.defaultdict(float)
        self.calls: dict[str, int] = collections.defaultdict(int)
        self._saved: list[tuple[object, str, object]] = []

    def _wrap(self, module, name: str, layer: str, bound_of) -> None:
        orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            self.bound[layer] += bound_of(*args, **kwargs)
            self.calls[layer] += 1
            with torch.profiler.record_function(PREFIX + layer):
                return orig(*args, **kwargs)

        if hasattr(orig, "launches"):
            wrapper.launches = orig.launches
        self._saved.append((module, name, orig))
        setattr(module, name, wrapper)

    def __enter__(self) -> "Spans":
        seen = set()
        for reader in self.readers:
            for module_name, name, bound_of in getattr(reader, "WRAPS", ()):
                if (module_name, name) not in seen:
                    seen.add((module_name, name))
                    self._wrap(importlib.import_module(module_name), name, reader.LAYER, bound_of)
        return self

    def __exit__(self, *exc) -> None:
        for module, name, orig in reversed(self._saved):
            wrapper = getattr(module, name)
            if hasattr(orig, "launches"):
                orig.launches = wrapper.launches
            setattr(module, name, orig)
        self._saved.clear()


def profiled_window(work, readers=()) -> tuple[dict, "Spans", float]:
    """Run ``work()`` under the profiler with the spans of ``readers`` installed; returns
    (the reduced trace, the spans, the window's seconds on the host clock,
    from a synchronize to a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with Spans(readers) as spans, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return read_trace(events), spans, window_s


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _gaps(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    gaps, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def read_trace(events: list[dict]) -> dict:
    """{busy_s, span_s: {layer: device seconds}, unattributed: {layer: kernels
    that could not be placed}, device_ops, idle_gaps} of a chrome trace
    (timestamps in microseconds)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev]
    busy_us = union_length(intervals)
    # the ranges of each layer, by host thread
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
            spans[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"][len(PREFIX):]))
    for v in spans.values():
        v.sort()
    starts = {tid: [s[0] for s in v] for tid, v in spans.items()}

    def layer_at(tid, ts):
        """The layer whose range holds ``ts`` on ``tid`` (the ranges of the
        layers never overlap), or None."""
        v = spans.get(tid)
        i = bisect.bisect_right(starts[tid], ts) - 1 if v else -1
        return v[i][2] if i >= 0 and v[i][0] <= ts <= v[i][1] else None

    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in (e.get("args") or {}):
            launch[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    span_us = collections.defaultdict(float)
    unplaced = 0
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        if corr not in launch:
            unplaced += 1
            continue
        layer = layer_at(*launch[corr])
        if layer is not None:
            span_us[layer] += float(e.get("dur", 0))
    by_name = collections.defaultdict(float)
    for e in dev:
        by_name[str(e.get("name"))] += float(e.get("dur", 0)) / 1e6
    # label each idle gap by the outermost host op running at its middle
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), str(e.get("name")))
                  for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")
                  and not str(e.get("name")).startswith("ProfilerStep"))
    idle = collections.defaultdict(float)
    active, j = [], 0
    for s, e in sorted(_gaps(intervals), key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        label = max(active, key=lambda h: h[1] - h[0])[2] if active else "host: no op recorded"
        idle[label] += (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy_us / 1e6, "span_s": {k: v / 1e6 for k, v in span_us.items()},
            "unplaced_device_events": unplaced, "device_events": len(dev),
            "device_ops": top(by_name), "idle_gaps": top(idle)}
