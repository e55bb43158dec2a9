"""Seeds, seeded weights and waves on the card, and what the run reads of
the device."""
from __future__ import annotations

import hashlib
import subprocess

import torch

WEIGHT_STD = 0.02


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of random numbers of a run."""
    h = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(stream_seed(seed, stream))


def seeded_weights(shapes: dict[str, torch.Size], seed: int, device, stream: str = "weights") -> dict[str, torch.Tensor]:
    """f32 weights for ``shapes`` (name -> shape), from one normal draw on
    ``device``: LayerNorm scales (1-D ``*norm*.weight``) 1 + N(0, 0.02^2),
    everything else N(0, 0.02^2)."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, stream, device), device=device) * WEIGHT_STD
    out, i = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        t = flat[i:i + n].view(shape)
        if len(shape) == 1 and name.endswith(".weight") and "norm" in name.rsplit(".", 2)[-2]:
            t = t + 1.0
        out[name] = t
        i += n
    return out


def seeded_waves(shape: tuple[int, ...], seed: int, stream: str, device, std: float = 0.1) -> torch.Tensor:
    """f32 samples N(0, std^2) on ``device``."""
    return torch.randn(shape, generator=generator(seed, stream, device), device=device) * std


def load_weights_(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the module's parameters, every one of them."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"weights and parameters differ: {sorted(set(params) ^ set(weights))[:6]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
