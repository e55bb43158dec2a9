"""Operations and bytes that the measured functions need, from their shapes,
and the card's published peaks.

Each count is of what the function needs, not of what one design spends:
every input read once, every output written once, products at 2 FLOP per
multiply-add, nothing recomputed. The peaks are one H100 SXM's dense rates at
700 W (NVIDIA's data sheet).
"""
from __future__ import annotations

import importlib
import math

import numpy as np

PEAK_BF16 = 989e12  # dense bf16 FLOP/s: the one peak of every mfu
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def attention_bound(kind: str, bh: int, lq: int, lk: int, d: int, kb: int, esize: int) -> float:
    """Least seconds of one attention function (``fwd``, ``dq`` or ``dkv``):
    each input read once, each output written once, the products it needs at
    the bf16 tensor rate (the forward q k^T and p v; dq + dbias: q k^T, dO
    v^T, ds k; dk + dv: q k^T, dO v^T, ds^T q, p^T dO). ``kb`` is the bias's
    width (0 without one). Frozen copy of chip_smoke.py:attention_bound."""
    q, kv, b = bh * lq * d, bh * lk * d, bh * lq * kb
    if kind == "fwd":
        nbytes, matmuls = esize * (2 * q + 2 * kv + b), 2
    elif kind == "dq":
        nbytes, matmuls = esize * (3 * q + 2 * kv + 2 * b) + 12 * bh * lq, 3
    elif kind == "dkv":
        nbytes, matmuls = esize * (2 * q + 4 * kv + b) + 12 * bh * lq, 4
    else:
        raise ValueError(f"no attention function {kind!r}")
    return max(nbytes / PEAK_BYTES, matmuls * 2.0 * bh * lq * lk * d / PEAK_BF16)


def logmel_flops(n_fft: int, n_mels: int, n_frames_total: int, mel_nnz: int) -> float:
    """f32 operations of the log-mel function: per frame the window multiply,
    a real n_fft-point FFT at 2.5 N log2 N, power and + eps over the n_fft/2 + 1
    bins, one multiply-add per nonzero filterbank entry, + eps and the log.
    Frozen copy of chip_smoke.py:logmel_flops."""
    n = n_fft
    return n_frames_total * (n + 2.5 * n * math.log2(n) + 4 * (n // 2 + 1) + 2 * mel_nnz + 2 * n_mels)


def rows_flops(rows: int, width: int, n_fft: int, n_mels: int, mel_nnz: int) -> float:
    """f32 operations of the Kaldi fbank's rows: window, FFT, power, mel
    product, log. Frozen copy of the count in chip_smoke.py:rows_times."""
    n_bins = n_fft // 2 + 1
    return rows * (width + 2.5 * n_fft * math.log2(n_fft) + 3 * n_bins + 2 * mel_nnz + 2 * n_mels)


def frontend_bound(kind: str, batch: int, samples: int, n_mels: int, n_frames: int, mel_nnz: int) -> float:
    """Least seconds of one frontend call on [batch, samples] f32 waves giving
    [batch, n_mels, n_frames] f32 features: the waves read once, the features
    written once, the function's f32 operations at the f32 rate."""
    nbytes = 4 * batch * (samples + n_mels * n_frames)
    if kind == "fbank":
        win, hop = 400, 160
        rows = batch * (1 + (samples - win) // hop)
        flops = rows_flops(rows, win, 512, n_mels, mel_nnz)
    else:
        flops = logmel_flops(1024, n_mels, batch * n_frames, mel_nnz)
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32)


# ---------------------------------------------------------------- model FLOPs


def encoder_flops(encoder: str, arch: dict, n_mels: int, n_frames: int) -> float:
    """Forward FLOPs of one clip of [n_mels, n_frames] through a
    configuration's encoder, by the count of its own module
    (``counts/<encoder in lower case>.py``'s ``clip_flops``)."""
    return importlib.import_module(f"portbench.counts.{encoder.lower()}").clip_flops(arch, n_mels, n_frames)


def linear_flops(rows: int, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def mel_nnz(banks: np.ndarray) -> int:
    return int(np.count_nonzero(banks))
