"""Run one cell of the port's benchmark on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with 2 and prints no result without the CUDA devices the cell asks
for, and with 3 if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="one cell of BENCHMARK.json on the card")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from portbench.harness import runner

    return runner.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
