"""The knee of an open-loop serving cell, on the card: one set-up, then a
window at each rate, printing the latency and whether the backlog grew.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates <r> [<r> ...]

The backlog grew at a rate where the requests of the window's last quarter
waited longer than twice those of its first quarter and than one mean
service time. The knee is the highest rate tried below the first at which
it grew; the cell's mix then fixes its rate at about four fifths of it.
The benchmark's own runs never run this.
"""
import argparse
import json
import os
import statistics
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    from portbench.loops import serve_open
    from portbench.harness import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()
    cell = spec.load_cell(args.workload)
    loop = serve_open.Loop(cell, args.seed, torch.device("cuda", 0))
    service = {}
    for size in loop.sizes:  # each size's service time alone, back to back
        t0 = time.perf_counter()
        for _ in range(5):
            loop.served.encoder(loop.request(size))
        service[size] = (time.perf_counter() - t0) / 5
    mean_service = statistics.fmean(service[s] for s in loop.sizes)
    print(json.dumps({"service_s": service, "mean_service_s": mean_service,
                      "capacity_per_s": 1.0 / mean_service}), flush=True)
    for rate in args.rates:
        cell.traffic["rate_per_s"] = rate
        w = loop.window(args.seconds)
        waits = np.asarray(loop.last_waits)
        q = max(1, len(waits) // 4)
        first, last = float(waits[:q].mean()), float(waits[-q:].mean())
        grew = last > 2 * first and last > mean_service
        print(json.dumps({"rate_per_s": rate, "requests": w["attempted"], "serve_p95_ms": w["metrics"]["serve_p95_ms"],
                          "queue_wait_ms": w["queue_wait_ms"], "wait_first_quarter_ms": 1e3 * first,
                          "wait_last_quarter_ms": 1e3 * last, "backlog_grew": grew, "line": w["lines"][0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
