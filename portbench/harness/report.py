"""The result line and the lines before it."""
from __future__ import annotations

import json
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "audiossl_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's, its kin's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, checks: list[tuple],
                breakdown: dict | None = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return json.dumps(out)
