"""Online embedding, open loop: requests of a few clips arrive at a fixed
rate and one caller serves them in order through ``ServingEncoder`` (with
the mix's ``bucket``), each answer back on the host as numpy.

Every seed gets the same requests and the same gaps between arrivals, in
another order: one order of the mix (its ``order_seed``) of sizes cycling
through ``sizes`` and of the exponential's quantiles at the mix's rate as
gaps (a Poisson process's gaps, its bursts kept), rotated to a start that
the seed draws. A request's latency runs from the time it was due to its
answer on the host, so a slow call makes every request queued behind it
late. Set-up serves each request size
once; the window's first request is served with the stages' taps on; the
check compares a seeded sample of the window's answers, the largest
requests among them, and the stages with the reference.
"""
from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from portbench.loops.serve_common import Served
from portbench.loops.train_common import sync
from portbench.harness import common, report


def schedule(rate: float, seconds: float, sizes: list[int], order_seed: int,
             seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(due times in s from the window's start, request sizes)."""
    n = max(1, int(round(rate * seconds)))
    order = np.random.default_rng(order_seed)
    gaps = order.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    sizes = order.permutation(np.resize(np.asarray(sizes), n))
    start = int(np.random.default_rng(common.stream_seed(seed, "arrivals")).integers(n))
    gaps, sizes = np.roll(gaps, start), np.roll(sizes, start)
    return np.cumsum(gaps) - gaps[0], sizes


class Loop:
    kind = "serve"

    def __init__(self, cell, seed: int, device: torch.device):
        tr = cell.traffic
        self.cell, self.seed = cell, seed
        self.phases = {"imported": time.perf_counter()}
        self.served = Served(cell, seed, device, {"bucket": int(tr["bucket"])})
        self.phases["built"] = time.perf_counter()
        self.sizes = [int(s) for s in tr["sizes"]]
        self.rng = np.random.default_rng(common.stream_seed(seed, "offsets"))
        for size in sorted(self.sizes):  # every shape the window sends
            self.served.encoder(self.served.pool[:size])
        sync(device)

    def request(self, size: int) -> np.ndarray:
        off = int(self.rng.integers(0, len(self.served.pool) - size + 1))
        return self.served.pool[off: off + size]

    def window(self, seconds: float) -> dict:
        tr = self.cell.traffic
        due, sizes = schedule(float(tr["rate_per_s"]), seconds, self.sizes, int(tr["order_seed"]), self.seed)
        lat, wait, late, failed = [], [], [], 0
        self.answers = []
        t0 = time.perf_counter()
        for i, (d, size) in enumerate(zip(due, sizes)):
            waves = self.request(int(size))
            now = time.perf_counter() - t0
            if now < d:
                time.sleep(d - now)
            start = time.perf_counter() - t0
            if now < d:
                late.append(start - d)  # the generator's own lateness: the server was idle
            try:
                out = (self.served.tapped if i == 0 else self.served.encoder)(waves)
            except Exception as e:  # a failed request counts as missing every limit
                failed += 1
                lat.append(math.inf)
                report.note(f"request of {size} clips failed: {type(e).__name__}: {e}")
                continue
            end = time.perf_counter() - t0
            lat.append(end - d)
            wait.append(start - d)
            self.answers.append((waves, out))
        span = time.perf_counter() - t0
        self.last_waits = wait
        n = len(due)
        p95 = 1e3 * percentile(lat, 95)
        clips = int(sum(sizes))
        return {
            "metrics": {"serve_p95_ms": p95}, "attempted": n, "failed": failed,
            "queue_wait_ms": 1e3 * statistics.fmean(wait),
            "lines": [f"serve_p95_ms {p95} over {n} requests ({clips} clips, {failed} failed) at "
                      f"{tr['rate_per_s']} requests/s; median {1e3 * statistics.median(lat)} ms; mean queue wait "
                      f"{1e3 * statistics.fmean(wait)} ms; generator late by {1e3 * statistics.fmean(late or [0.0])} ms "
                      f"on average over {len(late)} requests that found the server idle; last answer at {span} s "
                      f"of a {float(due[-1])} s schedule"]}

    def profiled(self) -> None:
        for size in self.sizes * int(self.cell.traffic["profiled_rounds"]):
            self.served.encoder(self.request(size))

    def back_to_back(self) -> dict:
        """Rounds of one request of each size served back to back, without
        the profiler: the model FLOPs of their clips and their seconds, from
        a synchronize to the last answer on the host."""
        rounds = int(self.cell.traffic["back_to_back_rounds"])
        sync(self.served.device)
        t0 = time.perf_counter()
        for size in self.sizes * rounds:
            self.served.encoder(self.request(size))
        secs = time.perf_counter() - t0
        return {"flops": rounds * sum(self.sizes) * self.served.clip_flops, "seconds": secs,
                "lines": [f"back to back: {rounds} rounds of {self.sizes} clips in {secs} s"]}

    def release(self) -> None:
        del self.served.encoder

    def stage_source(self):
        return self.served.stage_source()

    def checks(self) -> list[tuple[str, float, float]]:
        k = int(self.cell.traffic["checked_requests"])
        rng = np.random.default_rng(common.stream_seed(self.seed, "sample"))
        biggest = max(range(len(self.answers)), key=lambda i: len(self.answers[i][1]))
        pick = sorted({biggest, *rng.choice(len(self.answers), min(k, len(self.answers)), replace=False).tolist()})
        waves = np.concatenate([self.answers[i][0] for i in pick])
        answers = np.concatenate([self.answers[i][1] for i in pick])
        self.checked = (waves, answers)
        return self.served.checks(waves, answers)


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile (a failed request's infinite latency counts)."""
    v = sorted(values)
    return float(v[max(0, math.ceil(q / 100 * len(v)) - 1)])
