"""The readings the output check's limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--faults <k>] [--seconds <s>]

For each seed: the cell's set-up (and, for a serving cell, a short window of
``--seconds`` at the cell's own load), then the program's numbers against
the reference. For the first ``--faults`` seeds also each control, the
reference at a precision one step below one that the configuration states
(``precision.controls``) put in the program's place, with its stage numbers
(the stage in the control's precision on the program's input of the
stage); for a training cell the planted fault of half the batch left out
(the mean taken over the rest), and where the objective keeps a queue and a
key encoder, those two left unchanged (read from the state itself). Prints
one JSON line per seed and reading. The benchmark's own runs never run this.
"""
import argparse
import gc
import importlib
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(cell, seed: int, with_faults: bool, seconds: float, device=None) -> list[dict]:
    import torch

    from portbench.harness import check
    from portbench.loops import train_common
    from portbench.reference.precision import Precision

    device = device or torch.device("cuda", 0)
    loop = importlib.import_module(f"portbench.loops.{cell.loop}").Loop(cell, seed, device)
    if loop.kind != "train":
        loop.window(seconds)
    loop.release()
    gc.collect()
    torch.cuda.empty_cache()
    numbers = {n: v for n, v, _ in loop.checks()}
    if loop.kind == "train":
        numbers.update(train_common.training_numbers(loop.prog, loop.ref))
    prec = cell.config["precision"]
    ref_prec, stage_prec = Precision(**prec["reference"]), Precision(**prec["stage"])
    taps, weights, prefix = loop.stage_source()

    def stages(control=None):
        return check.stage_numbers(cell.config.get("stages", []), taps, weights, prefix, cell.config["encoder"],
                                   stage_prec, control)

    out = [{"seed": seed, "reading": "program", **numbers, **stages(), "notes": getattr(loop, "notes", [])}]
    if not with_faults:
        return out

    for name, kw in prec["controls"].items():
        control = Precision(**kw)
        if loop.kind == "train":
            got = loop.reference(control)
            nums = train_common.training_numbers(got, loop.ref)
        else:
            waves = loop.checked[0]
            nums = {"emb_gap": check.row_gap(loop.served.reference(waves, control),
                                             loop.served.reference(waves, ref_prec))}
        out.append({"seed": seed, "reading": f"control {name}", **nums, **stages(control)})
    if loop.kind == "train":
        got = loop.reference(ref_prec, half_batch=True)
        out.append({"seed": seed, "reading": "half_batch", **train_common.training_numbers(got, loop.ref)})
        queue0 = loop.queue0() if hasattr(loop, "queue0") else None
        for name, nums in train_common.faults_of_state(loop.prog, loop.ref, queue0).items():
            out.append({"seed": seed, "reading": name, **nums})
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, default=3, help="seeds (the first ones) that also read the control and faults")
    p.add_argument("--seconds", type=float, default=5.0, help="a serving cell's short window")
    args = p.parse_args()
    from portbench.harness import spec

    cell = spec.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        for r in readings(cell, seed, i < args.faults, args.seconds):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
