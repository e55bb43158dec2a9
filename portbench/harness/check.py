"""The numbers the output check compares, each held to a limit.

* ``rel_gap``: the largest |program - reference| / |reference| over pairs
  of scalars (the steps' losses).
* ``leaf_gap``: for a training step's leaves, the largest gap between the
  program's norm of a leaf and the reference's, measured against the larger
  of that leaf's reference norm and the median leaf's (some gradients are
  all but zero). Leaves left out by ``keep`` are not compared.
* ``row_gap``: the largest relative L2 distance between the program's rows
  and the reference's (embeddings, queue columns, a stage's output rows),
  ||p - r|| / ||r|| per row.
* ``stage_numbers``: a stage's ``row_gap``, where the program's output of one
  stage of the encoder (``harness/taps.py``) is set against the reference's
  stage (``reference/stages/``) on the program's own input of that stage.
"""
from __future__ import annotations

import importlib
import math
import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's reference gradient: leaves that only round-off moves


def rel_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref, strict=True))


def leaf_gap(prog: dict[str, float], ref: dict[str, float], keep: set[str] | None = None) -> tuple[float, str]:
    """(worst gap, its leaf)."""
    if set(prog) != set(ref):
        raise KeyError(f"the leaves differ: {sorted(set(prog) ^ set(ref))[:6]}")
    med = statistics.median(ref.values())
    worst, leaf = 0.0, ""
    for name, r in ref.items():
        if keep is not None and name not in keep:
            continue
        gap = abs(prog[name] - r) / max(r, med, 1e-30)
        if gap > worst or not leaf:
            worst, leaf = gap, name
    return worst, leaf


def moved_leaves(ref_grad: dict[str, float]) -> set[str]:
    """Leaves whose reference gradient is not negligible (the rule that keeps
    round-off-only leaves out of the change compared)."""
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= NEGLIGIBLE_GRAD * med}


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog, ref = prog.double(), ref.double()
    return float(((prog - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max())


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    """One host read for all the leaves' L2 norms."""
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().double().norm() for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def stage_numbers(stages: list[dict], taps, weights: dict[str, torch.Tensor], prefix: str, encoder: str, ref_prec,
                  in_place_of_program=None) -> dict[str, float]:
    """Each stage's row_gap: the program's output (or, with
    ``in_place_of_program``, the reference's stage in that precision) against
    the reference's stage in ``ref_prec``, both on the program's input of the
    stage and the weights under ``prefix``; infinite where the pass did not
    reach the stage. ``compare_in`` rounds both to the type the next layer
    reads them in first."""
    from portbench.reference.models import encoder as encoder_module
    from portbench.reference.models import sub

    enc = encoder_module(encoder)
    out = {}
    for st in stages:
        pair = taps.pair(st)
        if pair is None:
            out[st["name"]] = math.inf
            continue
        x, y = pair
        mod = importlib.import_module(f"portbench.reference.stages.{st['stage']}")
        p = sub(weights, f"{prefix}{st['weights']}.")
        with torch.no_grad():
            with ref_prec.products():
                ref = mod.output(x, p, ref_prec, enc)
            if in_place_of_program is not None:
                with in_place_of_program.products():
                    y = mod.output(x, p, in_place_of_program, enc)
        if "compare_in" in st:
            dt = {"bf16": torch.bfloat16}[st["compare_in"]]
            ref, y = ref.to(dt), y.to(dt)
        out[st["name"]] = row_gap(y.to(ref.device), ref)
    return out


def stage_checks(cell, taps, weights: dict[str, torch.Tensor], prefix: str) -> list[tuple[str, float, float]]:
    """The configuration's stage numbers at its stated stage precision
    (``precision.stage``), each beside its limit (a stage with no limit is
    not compared)."""
    from portbench.reference.precision import Precision

    nums = stage_numbers(cell.config.get("stages", []), taps, weights, prefix, cell.config["encoder"],
                         Precision(**cell.config["precision"]["stage"]))
    return [(name, value, cell.limits[name]) for name, value in nums.items() if name in cell.limits]
