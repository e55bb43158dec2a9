"""Offline embedding of a corpus, closed loop: one caller hands
``ServingEncoder`` (with the mix's ``fixed_batch``) one call of
``fixed_batch`` clips after another, each a different window of a seeded
host pool, and takes each answer back on the host as numpy. Set-up makes
one call; the window's first call runs with the stages' taps on; the check
compares a seeded sample of all the window's answered clips, and the
stages, with the reference."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.loops.serve_common import Served
from portbench.loops.train_common import sync
from portbench.harness import common


class Loop:
    kind = "embed"

    def __init__(self, cell, seed: int, device: torch.device):
        tr = cell.traffic
        self.cell, self.seed = cell, seed
        self.phases = {"imported": time.perf_counter()}
        self.batch = int(tr["fixed_batch"])
        self.served = Served(cell, seed, device, {"fixed_batch": self.batch})
        self.phases["built"] = time.perf_counter()
        self.stride = int(tr["call_stride"])
        self.n_offsets = (len(self.served.pool) - self.batch) // self.stride + 1
        self.calls = 0
        self.served.encoder(self.next_call())
        sync(device)

    def next_call(self) -> np.ndarray:
        off = (self.calls % self.n_offsets) * self.stride
        self.calls += 1
        return self.served.pool[off: off + self.batch]

    def window(self, seconds: float) -> dict:
        self.answers = []
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            waves = self.next_call()
            serve = self.served.tapped if n == 0 else self.served.encoder
            self.answers.append((waves, serve(waves)))  # waves: a view of the pool
            n += 1
        secs = time.perf_counter() - t0
        clips = n * self.batch
        return {"metrics": {"embed_clips_per_s": clips / secs}, "attempted": n, "failed": 0,
                "flops": clips * self.served.clip_flops, "seconds": secs,
                "lines": [f"embed_clips_per_s {clips / secs} over {n} calls of {self.batch} clips ({clips} clips) "
                          f"in {secs} s"]}

    def profiled(self) -> None:
        for _ in range(int(self.cell.traffic["profiled_calls"])):
            self.served.encoder(self.next_call())

    def release(self) -> None:
        del self.served.encoder

    def stage_source(self):
        return self.served.stage_source()

    def checks(self) -> list[tuple[str, float, float]]:
        n = len(self.answers) * self.batch
        rng = np.random.default_rng(common.stream_seed(self.seed, "sample"))
        pick = np.sort(rng.choice(n, min(int(self.cell.traffic["checked_clips"]), n), replace=False))
        self.checked = (np.stack([self.answers[i // self.batch][0][i % self.batch] for i in pick]),
                        np.stack([self.answers[i // self.batch][1][i % self.batch] for i in pick]))
        return self.served.checks(*self.checked)
