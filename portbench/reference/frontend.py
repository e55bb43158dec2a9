"""The two frontends, from their published definitions, in float32 (FFT by
``torch.fft.rfft``).

* ``kaldi_fbank``: ``torchaudio.compliance.kaldi.fbank`` as the MAST loader
  calls it (htk_compat, hanning window, dither 0, 25 ms frames every 10 ms,
  snip edges, DC removal, preemphasis 0.97, power spectrum on 512 points,
  HTK-mel triangles from 20 Hz to Nyquist, log(max(x, eps))), padded or cut
  to a frame count.
* ``log_mel``: librosa 0.8's ``melspectrogram`` as the LAPE frontend uses it
  (n_fft 1024, hop 160, periodic Hann, centred with reflect padding, power 2,
  Slaney mel from 60 to 7800 Hz with Slaney area norm), then
  log(mel + eps32) after adding eps64 to the power.
"""
from __future__ import annotations

import math

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)


def _htk_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def kaldi_banks(n_mels: int, n_fft: int, sr: int, low: float = 20.0) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] triangles on the HTK mel scale (Kaldi's
    MelBanks; the Nyquist bin gets no weight)."""
    mel_lo, mel_hi = _htk_mel(low), _htk_mel(sr / 2.0)
    delta = (mel_hi - mel_lo) / (n_mels + 1)
    mel_k = _htk_mel(sr / n_fft * np.arange(n_fft // 2 + 1))
    left = mel_lo + np.arange(n_mels)[:, None] * delta
    w = np.maximum(0.0, np.minimum((mel_k - left) / delta, (left + 2 * delta - mel_k) / delta))
    w[:, -1] = 0.0
    return w.astype(np.float32)


def kaldi_fbank(waves: torch.Tensor, n_mels: int = 128, sr: int = 16000, target_frames: int | None = None) -> torch.Tensor:
    """[B, L] -> [B, n_mels, T] (T = target_frames when given)."""
    win, hop = int(sr * 0.025), int(sr * 0.010)
    n_fft = 1 << (win - 1).bit_length()
    n = 1 + (waves.shape[-1] - win) // hop
    frames = waves.float()[:, : (n - 1) * hop + win].unfold(-1, win, hop)  # [B, n, win]
    frames = frames - frames.mean(-1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    i = torch.arange(win, dtype=torch.float64, device=waves.device)
    frames = frames * (0.5 - 0.5 * torch.cos(2 * math.pi * i / (win - 1))).float()
    power = torch.fft.rfft(frames, n=n_fft).abs().square()  # [B, n, n_fft/2 + 1]
    banks = torch.from_numpy(kaldi_banks(n_mels, n_fft, sr)).to(waves.device)
    with _no_tf32():
        fb = torch.log(torch.clamp_min(power @ banks.T, EPS32))  # [B, n, M]
    if target_frames is not None:
        fb = torch.nn.functional.pad(fb, (0, 0, 0, max(0, target_frames - n)))[:, :target_frames]
    return fb.transpose(1, 2)


def _slaney_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), lin)


def _slaney_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), m * (200.0 / 3))


def slaney_banks(n_mels: int, n_fft: int, sr: int, fmin: float = 60.0, fmax: float = 7800.0) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney'): [n_mels, n_fft // 2 + 1]."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = _slaney_hz(np.linspace(_slaney_mel(fmin), _slaney_mel(fmax), n_mels + 2))
    fdiff = np.diff(edges)
    ramps = edges[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (w * (2.0 / (edges[2:] - edges[:-2]))[:, None]).astype(np.float32)


def log_mel(waves: torch.Tensor, n_mels: int = 128, sr: int = 16000, n_fft: int = 1024, hop: int = 160) -> torch.Tensor:
    """[B, L] -> [B, n_mels, 1 + L // hop]."""
    x = torch.nn.functional.pad(waves.float()[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    i = torch.arange(n_fft, dtype=torch.float64, device=waves.device)
    frames = frames * (0.5 - 0.5 * torch.cos(2 * math.pi * i / n_fft)).float()
    power = torch.fft.rfft(frames).abs().square()
    banks = torch.from_numpy(slaney_banks(n_mels, n_fft, sr)).to(waves.device)
    with _no_tf32():
        mel = (power + EPS64) @ banks.T
    return torch.log(mel + EPS32).transpose(1, 2)


class _no_tf32:
    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.old
