"""Carry weights across: JAX/flax AudioNTT variables -> the port's state_dict.

The port's own copy of ``audiossl_tpu.models.torch_export.audiontt_to_torch``
(the port imports nothing of the JAX package). Conventions bridged:

* flax HWIO conv kernels, spatial (time, freq) -> torch OIHW, (freq, time):
  the JAX encoder runs time-major, the reference and the port freq-major;
* flax Dense [in, out] -> torch Linear [out, in];
* flax BatchNorm scale/bias + batch_stats mean/var -> BatchNorm2d
  weight/bias/running_mean/running_var.

Input is the encoder's variables as NumPy arrays (``{"params": ...,
"batch_stats": ...}`` with ``ConvBlock_{0,1,2}`` and ``Dense_{0,1}``), e.g.
``jax.tree.map(np.asarray, variables)``; output loads into
``models.audiontt.AudioNTT2020Task6`` with ``strict=True``.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # an owned, writable copy


def audiontt_from_flax(variables_numpy: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """AudioNTT2020Task6 flax variables -> reference-layout torch state_dict
    (``features_{1,2,3}.{0: Conv2d, 1: BatchNorm2d}``, ``fc.{0, 3}``)."""
    params = variables_numpy["params"]
    batch_stats = variables_numpy.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for i in range(3):
        blk, bs = params[f"ConvBlock_{i}"], batch_stats[f"ConvBlock_{i}"]
        t = f"features_{i + 1}"
        # HWIO (time, freq, in, out) -> OIHW (out, in, freq, time)
        sd[f"{t}.0.weight"] = _t(np.transpose(np.asarray(blk["Conv_0"]["kernel"]), (3, 2, 1, 0)))
        sd[f"{t}.0.bias"] = _t(blk["Conv_0"]["bias"])
        sd[f"{t}.1.weight"] = _t(blk["BatchNorm_0"]["scale"])
        sd[f"{t}.1.bias"] = _t(blk["BatchNorm_0"]["bias"])
        sd[f"{t}.1.running_mean"] = _t(bs["BatchNorm_0"]["mean"])
        sd[f"{t}.1.running_var"] = _t(bs["BatchNorm_0"]["var"])
        sd[f"{t}.1.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    for j, t in ((0, "fc.0"), (1, "fc.3")):
        dense = params[f"Dense_{j}"]
        sd[f"{t}.weight"] = _t(np.asarray(dense["kernel"]).T)
        sd[f"{t}.bias"] = _t(dense["bias"])
    return sd
