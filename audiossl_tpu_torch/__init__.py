"""audiossl_tpu_torch — the PyTorch / CUDA port of audiossl_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find. It imports torch, numpy, scipy and yaml, and
never jax, flax or anything of ``audiossl_tpu``: where it needs a host-side
helper from there (mel filterbank, WAV decode, config loading) it keeps its
own copy.

Every TPU kernel on a ported path becomes a kernel written by hand for
Hopper (``csrc/``, built at first use by ``kernels.py``). Each kernel has a
plain PyTorch version beside it; a wrapper takes the plain version only for
a tensor on the CPU, and on a CUDA tensor launches the kernel or raises.

Ported so far (the serving slice):
  config.py           YAML config loading
  data/wav.py         WAV decode / resample / write
  frontend/           log-mel: plain version + the Hopper log-mel kernel
  models/audiontt.py  AudioNTT2020Task6, eval path
  models/convert.py   flax variables -> reference state_dict
  downstream/model.py DownstreamModel (AudioNTT encoder)
  serve/export.py     waveform -> embedding serving, artifact, CLI
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default) raises when
    no CUDA device is present: the port never carries on silently on the
    CPU unless the caller asked for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (expected 'cuda' or 'cpu')")
    return dev
