"""Fixed-length window extraction on the host (a copy of
``audiossl_tpu.ops.windowing.extract_window_np``).

Reference semantics (``extract_window``, src/utils/utils.py:166-182): a wave
shorter than ``unit_length`` samples is zero-padded symmetrically (the extra
sample on the right); then a random crop of ``unit_length`` is taken.
"""
from __future__ import annotations

import numpy as np


def extract_window_np(wave: np.ndarray, unit_length: int, rng: np.random.Generator) -> np.ndarray:
    """[n] -> [unit_length]; draws the crop start from ``rng`` only when n > unit_length."""
    n = len(wave)
    if n < unit_length:
        adj = unit_length - n
        half = adj // 2
        wave = np.pad(wave, (half, adj - half))
        n = unit_length
    start = int(rng.integers(0, n - unit_length + 1)) if n > unit_length else 0
    return wave[start : start + unit_length]
