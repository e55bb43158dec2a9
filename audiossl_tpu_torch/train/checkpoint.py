"""Full-state checkpoints and the encoder export (port of ``audiossl_tpu.train.checkpoint``).

Layout under ``<save_path>_chkp/``, as the JAX package's:

  state/<step>.pt    everything a resumed run needs: the objective's
                     state_dict (parameters, BatchNorm running stats, and
                     for SS-MAST the key encoder, queue, pointer and step),
                     optimizer and scheduler, the augmentation state (mixup
                     bank, fill, ptr, RunningNorm), the generator's state,
                     the loader's position, the step and the config
  encoder/<step>.pt  the objective's ``export_state_dict()`` in the reference
                     layout: AudioNTT for DeLoRes-S, which ``serve.export
                     --state_dict`` and ``build_embedder`` read; the MAST
                     trunk for SS-MAST (freq-major, as ``mast_to_torch``)
  config.yaml

Saves are asynchronous, as the JAX package's orbax ``AsyncCheckpointer``s
(one a kind): the only blocking part of a save is the copy of the state to
host memory; ``torch.save`` to a temporary name and the rename run on one
background writer a kind, so the state and the encoder write at once while
the loop goes on. A save of a kind first waits for that kind's previous
write, which bounds the queue at one write in flight a kind. A ``<step>.pt``
on disk is always complete (the rename comes last), and
``wait_until_finished`` blocks until every write is on disk: each trainer
calls it before it returns, and every load of this package (``load_checkpoint``,
the probe's, the embedder's, the feature extractor's and the pseudo-labeller's
reads of the newest encoder) and ``prune_checkpoints`` call it first. A write that failed raises
at the next save or wait. Under a process group only rank 0 writes.
"""
from __future__ import annotations

import concurrent.futures
import copy
import os
from typing import Any

import numpy as np
import torch
import yaml

KINDS = ("state", "encoder")
_WRITERS: dict[str, concurrent.futures.ThreadPoolExecutor] = {}
_PENDING: dict[str, concurrent.futures.Future] = {}


def _save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _host_copy(obj: Any) -> Any:
    """A copy of ``obj`` that the loop's later updates cannot reach: each
    tensor copied to host memory (a CPU tensor cloned), every other leaf
    copied."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    return copy.deepcopy(obj)


def _write_async(kind: str, obj: Any, path: str) -> None:
    """Hand ``obj`` (already a host copy) to ``kind``'s writer, after its
    previous write has finished."""
    _wait(kind)
    if kind not in _WRITERS:
        _WRITERS[kind] = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix=f"ckpt-{kind}")
    _PENDING[kind] = _WRITERS[kind].submit(_save, obj, path)


def _wait(kind: str) -> None:
    job = _PENDING.pop(kind, None)
    if job is not None:
        job.result()  # re-raises a failed write


def wait_until_finished() -> None:
    """Block until every write in flight is on disk (JAX's
    ``wait_until_finished``). Call before loading, timing or returning."""
    errors = []
    for kind in list(_PENDING):
        try:
            _wait(kind)
        except Exception as e:  # every writer drained before the first failure is raised
            errors.append(e)
    if errors:
        raise errors[0]


def save_checkpoint(
    ckpt_dir: str, step: int, state: dict[str, Any], encoder_state: dict[str, torch.Tensor],
    config: dict | None = None, keep_last: int | None = None, block: bool = False,
) -> None:
    """Copy ``state`` and ``encoder_state`` to host memory and write them in
    the background (``block``: and wait for both writes)."""
    _write_async("state", _host_copy(state), os.path.join(ckpt_dir, "state", f"{step}.pt"))
    _write_async("encoder", _host_copy(encoder_state), os.path.join(ckpt_dir, "encoder", f"{step}.pt"))
    if config is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(config, f)
    if block:
        wait_until_finished()
    if keep_last:
        # the step in flight still has its temporary name, so this prunes the
        # steps before it; at most keep_last + 1 steps of a kind are on disk
        # (JAX's bound, audiossl_tpu/train/checkpoint.py:80-84)
        _prune(ckpt_dir, keep_last)


def save_encoder_only(ckpt_dir: str, step: int, encoder_state: dict[str, torch.Tensor], block: bool = True) -> None:
    """An encoder-kind checkpoint alone, with no trainer state: what
    ``models.torch_import`` writes, so that converted reference weights
    enter the probe and serving paths as this package's own exports do."""
    _write_async("encoder", _host_copy(encoder_state), os.path.join(ckpt_dir, "encoder", f"{step}.pt"))
    if block:
        wait_until_finished()


def _steps(ckpt_dir: str, kind: str) -> list[int]:
    d = os.path.join(ckpt_dir, kind)
    if not os.path.isdir(d):
        return []
    return sorted(int(n[:-3]) for n in os.listdir(d) if n.endswith(".pt") and n[:-3].isdigit())


def _prune(ckpt_dir: str, keep_last: int) -> None:
    for kind in KINDS:
        for s in _steps(ckpt_dir, kind)[: -max(1, int(keep_last))]:
            os.remove(os.path.join(ckpt_dir, kind, f"{s}.pt"))


def prune_checkpoints(ckpt_dir: str, keep_last: int) -> None:
    """Keep the newest ``keep_last`` (at least 1) steps of each kind, once
    every write in flight is on disk."""
    wait_until_finished()
    _prune(ckpt_dir, keep_last)


def load_checkpoint(ckpt_dir: str) -> dict[str, Any]:
    """The newest saved state, on the CPU, once every write in flight is on
    disk."""
    wait_until_finished()
    steps = _steps(ckpt_dir, "state")
    if not steps:
        raise FileNotFoundError(f"no state checkpoints under {ckpt_dir}")
    # weights_only: the state holds tensors, numbers, strings and numpy's
    # generator state (plain dicts), nothing that needs unpickling of code
    return torch.load(os.path.join(ckpt_dir, "state", f"{steps[-1]}.pt"), map_location="cpu", weights_only=True)
