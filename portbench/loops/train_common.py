"""What the training loops share: the window of back-to-back steps and the
check of the first steps against the reference."""
from __future__ import annotations

import time

import torch

from portbench.harness import check


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_window(step, n_pool: int, start: int, seconds: float, device: torch.device) -> tuple[int, float, int]:
    """Steps over pool batches ``start``, ``start + 1``, ... (mod ``n_pool``)
    until ``seconds`` have passed on the host clock, then a synchronize:
    (steps, seconds from the first step to the synchronize, next batch)."""
    sync(device)
    t0 = time.perf_counter()
    n, i = 0, start
    while time.perf_counter() - t0 < seconds:
        step(i % n_pool)
        n, i = n + 1, i + 1
    sync(device)
    return n, time.perf_counter() - t0, i


def adam_first_grads(optimizer: torch.optim.Optimizer, names: dict, beta1: float) -> dict[str, float]:
    """Each leaf's first gradient norm as the optimizer got it, from its state
    after one step: exp_avg = (1 - beta1) g (nought where it kept no state)."""
    state = optimizer.state
    return check.leaf_norms({names[p]: state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in state[p]
                             else torch.zeros(()) for g in optimizer.param_groups for p in g["params"]})


def training_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """loss1_gap of the first step's loss, grad_gap of the first gradient by
    the worst leaf, change_gap of the parameters' change after the checked
    steps by the worst leaf that the reference's gradient moves; where the
    objective keeps a queue and a key encoder, queue_gap of the queue after
    the checked steps by the worst column and key_gap of the key encoder's
    change by the worst leaf, the same way."""
    moved = check.moved_leaves(ref["grad1"])
    out = {"loss1_gap": check.rel_gap(prog["losses"][:1], ref["losses"][:1]),
           "grad_gap": check.leaf_gap(prog["grad1"], ref["grad1"])[0],
           "change_gap": check.leaf_gap(prog["change"], ref["change"], moved)[0]}
    if "queue" in ref:
        out["queue_gap"] = check.row_gap(prog["queue"].T, ref["queue"].T.to(prog["queue"].device))
        out["key_gap"] = check.leaf_gap(prog["key_change"], ref["key_change"], moved)[0]
    return out


def training_checks(prog: dict, ref: dict, limits: dict) -> list[tuple[str, float, float]]:
    """The numbers that the cell's limits name, each beside its limit (a
    number with no upper reading has no limit and is not compared)."""
    return [(name, value, limits[name]) for name, value in training_numbers(prog, ref).items() if name in limits]


def faults_of_state(prog: dict, ref: dict, queue0) -> dict[str, dict[str, float]]:
    """The numbers of two faults that leave a state unchanged, read from the
    state itself: the queue never advanced (it stays ``queue0``) and the
    key encoder's EMA skipped (no key leaf moves)."""
    if "queue" not in ref:
        return {}
    frozen = dict(prog, queue=queue0)
    no_ema = dict(prog, key_change={k: 0.0 for k in prog["key_change"]})
    return {"frozen_queue": training_numbers(frozen, ref), "no_ema": training_numbers(no_ema, ref)}


def training_notes(prog: dict, ref: dict) -> list[str]:
    """What the check's numbers leave out: every step's loss gap, and the worst leaves."""
    grad_gap, grad_leaf = check.leaf_gap(prog["grad1"], ref["grad1"])
    change_gap, change_leaf = check.leaf_gap(prog["change"], ref["change"], check.moved_leaves(ref["grad1"]))
    steps = [check.rel_gap([p], [r]) for p, r in zip(prog["losses"], ref["losses"])]
    extra = []
    if "queue" in ref:
        _, key_leaf = check.leaf_gap(prog["key_change"], ref["key_change"], check.moved_leaves(ref["grad1"]))
        extra = [f"key_gap worst leaf {key_leaf}"]
    return [f"numbers {training_numbers(prog, ref)}", *extra,
            f"losses program {prog['losses']} reference {ref['losses']}; gap by step {steps}",
            f"grad_gap worst leaf {grad_leaf}; change_gap worst leaf {change_leaf}; "
            f"{len(ref['grad1']) - len(check.moved_leaves(ref['grad1']))} leaves left out of the change "
            f"(reference gradient under {check.NEGLIGIBLE_GRAD} of the median leaf's)"]
