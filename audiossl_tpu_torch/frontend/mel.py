"""Mel filterbank + window construction (NumPy, built once per config).

A copy of ``audiossl_tpu.frontend.mel`` (the port imports nothing of the
JAX package). Replicates ``librosa.filters.mel(sr=16000, n_fft=1024,
n_mels=64, fmin=60, fmax=7800)`` of librosa 0.8.1: the Slaney mel scale
(htk=False) with Slaney area normalization, implemented from the published
formula. Also provides the HTK mel scale used by Kaldi-compatible fbank.
"""
from __future__ import annotations

import numpy as np


def hz_to_mel(f, htk: bool = False):
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney scale.
    f_sp = 200.0 / 3.0
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz(m, htk: bool = False):
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3.0
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sr: int = 16000,
    n_fft: int = 1024,
    n_mels: int = 64,
    fmin: float = 60.0,
    fmax: float = 7800.0,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_mels, 1 + n_fft // 2)``."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs, dtype=np.float64)

    # n_mels + 2 band edges, evenly spaced on the mel scale.
    mel_edges = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_edges = mel_to_hz(mel_edges, htk)

    fdiff = np.diff(hz_edges)
    ramps = hz_edges[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_edges[2 : n_mels + 2] - hz_edges[:n_mels])
        weights = weights * enorm[:, None]
    return weights.astype(dtype)


def hann_window(win_length: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', N, fftbins=True)``)."""
    n = np.arange(win_length, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)).astype(dtype)


def rdft_matrices(n_fft: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Real-input DFT as two dense matrices.

    Returns ``(C, S)`` with shapes ``(n_fft, n_fft//2 + 1)`` such that for a
    frame ``x``: ``Re(rfft(x)) = x @ C`` and ``Im(rfft(x)) = x @ S``.
    """
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)
