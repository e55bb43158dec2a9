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

Files are written with ``torch.save`` to a temporary name and renamed, so a
``<step>.pt`` on disk is always complete.
"""
from __future__ import annotations

import os
from typing import Any

import torch
import yaml

KINDS = ("state", "encoder")


def _save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_checkpoint(
    ckpt_dir: str, step: int, state: dict[str, Any], encoder_state: dict[str, torch.Tensor],
    config: dict | None = None, keep_last: int | None = None,
) -> None:
    _save(_cpu(state), os.path.join(ckpt_dir, "state", f"{step}.pt"))
    _save(_cpu(encoder_state), os.path.join(ckpt_dir, "encoder", f"{step}.pt"))
    if config is not None:
        with open(os.path.join(ckpt_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(config, f)
    if keep_last:
        prune_checkpoints(ckpt_dir, keep_last)


def _steps(ckpt_dir: str, kind: str) -> list[int]:
    d = os.path.join(ckpt_dir, kind)
    if not os.path.isdir(d):
        return []
    return sorted(int(n[:-3]) for n in os.listdir(d) if n.endswith(".pt") and n[:-3].isdigit())


def prune_checkpoints(ckpt_dir: str, keep_last: int) -> None:
    """Keep the newest ``keep_last`` (at least 1) steps of each kind."""
    for kind in KINDS:
        for s in _steps(ckpt_dir, kind)[: -max(1, int(keep_last))]:
            os.remove(os.path.join(ckpt_dir, kind, f"{s}.pt"))


def load_checkpoint(ckpt_dir: str) -> dict[str, Any]:
    """The newest saved state, on the CPU."""
    steps = _steps(ckpt_dir, "state")
    if not steps:
        raise FileNotFoundError(f"no state checkpoints under {ckpt_dir}")
    # weights_only: the state holds tensors, numbers, strings and numpy's
    # generator state (plain dicts), nothing that needs unpickling of code
    return torch.load(os.path.join(ckpt_dir, "state", f"{steps[-1]}.pt"), map_location="cpu", weights_only=True)
