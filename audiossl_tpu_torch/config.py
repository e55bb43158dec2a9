"""YAML config loading for the port; reads the same ``configs/*.yaml`` as
``audiossl_tpu.config`` (a copy, so the port needs nothing of the JAX
package).

Default config resolution mirrors train_upstream.py: per-method YAML at
configs/<upstream>.yaml unless a path is given.
"""
from __future__ import annotations

import logging
import os
from typing import Any

import yaml

log = logging.getLogger("audiossl_tpu_torch.config")

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

# every run.* key a trainer of the repo reads; run.* is a closed vocabulary,
# so an unknown key is most likely a typo and gets a warning on load
RUN_KEYS = frozenset({
    "batch_size", "epochs", "learning_rate", "lr", "lr_schedule", "final_lr",
    "optimizer", "optimizer_args", "weight_decay", "layer_decay",
    "clip_grad_norm", "grad_accum_steps", "num_dataloader_workers",
    "save_path", "world_size", "duration", "freeze", "log_every",
    "wire_dtype", "data_on_error", "keep_checkpoints", "zero_optimizer",
    "fsdp", "compilation_cache_dir",
})


def load_config(path: str | None = None, upstream: str | None = None) -> dict[str, Any]:
    if path is None:
        if upstream is None:
            raise ValueError("need a config path or an --upstream name")
        path = os.path.join(CONFIG_DIR, f"{upstream}.yaml")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    unknown = sorted(set((cfg or {}).get("run") or {}) - RUN_KEYS)
    if unknown:
        log.warning("unknown run.* config key(s) %s — no trainer reads them "
                    "(typo? known: %s)", unknown, sorted(RUN_KEYS))
    return cfg


def clip_samples(config: dict[str, Any], section: str = "pretrain") -> int:
    inp = config[section]["input"]
    return int(float(inp["length_wave"]) * int(inp["sampling_rate"]))
