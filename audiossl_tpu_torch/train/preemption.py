"""Graceful preemption: checkpoint and return on SIGTERM (port of
``audiossl_tpu.train.preemption``).

A cloud maintenance event or a spot reclaim delivers SIGTERM shortly before
the machine goes; a trainer turns it into one final checkpoint and a normal
return, so that ``--load_checkpoint`` resumes where it stopped. The
reference has no equivalent: its SLURM scripts requeue and lose the progress
since the last periodic save.

* ``PreemptionGuard`` installs a SIGTERM handler that only sets a flag
  (async-signal-safe; it never checkpoints inside the handler). Previous
  handlers are restored on exit. Signal handlers can only be installed from
  the main thread: off it the guard is a no-op that never fires, and logs a
  warning.
* ``should_stop()`` is the flag. Where ``torch.distributed`` is initialized
  it is the OR of every process's flag (one all-reduce), so all processes
  leave their step loops at the same step; the trainers call it at their
  ``log_every`` cadence, not every step.

The trainers (train/loop.py, train/decar_loop.py, train/deepcluster_loop.py,
train/finetune_mast.py) install a guard around their epoch loops; on a
positive ``should_stop()`` they flush the metrics, write the usual
checkpoint at the current step, log, and return normally.
"""
from __future__ import annotations

import logging
import signal
import threading

import torch

log = logging.getLogger("audiossl_tpu_torch.preemption")


class PreemptionGuard:
    """Context manager installing a deferred SIGTERM (by default) handler::

        with PreemptionGuard() as guard:
            for step in ...:
                ...
                if step % check_every == 0 and guard.should_stop():
                    save_checkpoint(...)
                    break
    """

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM,)):
        self._flag = False
        self._prev: dict[int, object] = {}
        self._signals = signals
        self._installed = False

    def _handler(self, signum, frame):  # noqa: ARG002 (signal API)
        self._flag = True

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        else:
            log.warning("PreemptionGuard off main thread: signals not hooked")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            self._installed = False

    @property
    def installed(self) -> bool:
        return self._installed

    def requested_locally(self) -> bool:
        """This process's flag only: no collective, safe at any cadence."""
        return self._flag

    def should_stop(self) -> bool:
        """True iff any process has been signalled: the flag in one process,
        its all-reduced max where torch.distributed is initialized."""
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return self._flag
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        flag = torch.tensor([int(self._flag)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed and not self._flag:
            log.info("preemption signalled in another process; stopping with it")
        return agreed
