"""Waveform -> log-mel spectrogram, the plain PyTorch version.

Numerically replicates the reference CPU frontend (``MelSpectrogramLibrosa``
+ ``extract_log_mel_spectrogram``, librosa 0.8.1), as
``audiossl_tpu.frontend.stft.log_mel`` does with its dense algorithm:

    X   = stft(wave, n_fft=1024, hop=160, window=periodic-hann,
               center=True, pad_mode='reflect')
    mel = mfb @ (|X|**2 + eps64)          # slaney mel, fmin=60, fmax=7800
    out = log(mel + eps32)

The real DFT is one f32 matmul against the window-folded DFT bank, the mel
projection a second one. This is the plain version of the Hopper log-mel
kernel (fused_stft.py): the CPU tests run it, and the chip smoke run holds
the kernel against it on the card. On CUDA, f32 matmuls must run in full f32
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default) to
keep the 1e-3 librosa contract.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from audiossl_tpu_torch.frontend import mel as melmod

# float64 eps added to the power-mel (np.finfo(float).eps in the reference),
# float32 eps added before the log (torch.finfo().eps in the reference).
EPS64 = float(np.finfo(np.float64).eps)
EPS32 = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class LogMelConfig:
    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int | None = None  # defaults to n_fft
    hop: int = 160
    n_mels: int = 64
    fmin: float = 60.0
    fmax: float = 7800.0
    center: bool = True  # librosa center=True reflect padding
    htk: bool = False
    norm: str | None = "slaney"
    power: float = 2.0

    @property
    def win(self) -> int:
        return self.win_length if self.win_length is not None else self.n_fft

    def num_frames(self, n_samples: int) -> int:
        padded = n_samples + (self.n_fft if self.center else 0)
        return 1 + (padded - self.n_fft) // self.hop


def padded_window(cfg: LogMelConfig) -> np.ndarray:
    """Periodic Hann of ``cfg.win`` samples, centred in ``n_fft`` (librosa
    pad_center), float64."""
    window = melmod.hann_window(cfg.win, dtype=np.float64)
    if cfg.win < cfg.n_fft:
        lpad = (cfg.n_fft - cfg.win) // 2
        window = np.pad(window, (lpad, cfg.n_fft - cfg.win - lpad))
    return window


def _constants(cfg: LogMelConfig) -> tuple[np.ndarray, np.ndarray]:
    """(dft_bank [n_fft, 2*n_bins], mel_T [n_bins, n_mels]), float32."""
    c, s = melmod.rdft_matrices(cfg.n_fft)
    # fold the analysis window into the DFT bank: frames @ (w[:, None] * [C|S])
    bank = padded_window(cfg).astype(np.float32)[:, None] * np.concatenate([c, s], axis=1)
    mfb_t = melmod.mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, cfg.htk, cfg.norm
    ).T
    return bank.astype(np.float32), np.ascontiguousarray(mfb_t, np.float32)


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: LogMelConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    bank, mfb_t = _constants(cfg)
    return torch.from_numpy(bank).to(device), torch.from_numpy(mfb_t).to(device)


def reflect_pad(wave: torch.Tensor, n_fft: int) -> torch.Tensor:
    """[..., n] -> [..., n + n_fft], librosa ``center=True`` reflect padding."""
    pad = n_fft // 2
    lead = wave.shape[:-1]
    flat = wave.reshape(-1, 1, wave.shape[-1])
    return F.pad(flat, (pad, pad), mode="reflect").reshape(*lead, -1)


def frame_signal(wave: torch.Tensor, n_fft: int, hop: int, center: bool) -> torch.Tensor:
    """[..., n] -> [..., n_frames, n_fft] overlapping frames (a strided view
    of the padded wave, no copy)."""
    if center:
        wave = reflect_pad(wave, n_fft)
    return wave.unfold(-1, n_fft, hop)


def log_mel(wave: torch.Tensor, cfg: LogMelConfig = LogMelConfig()) -> torch.Tensor:
    """[..., n_samples] float -> [..., n_mels, n_frames] log-mel (natural log)."""
    bank, mfb_t = _device_constants(cfg, wave.device)
    n_bins = cfg.n_fft // 2 + 1
    frames = frame_signal(wave.float(), cfg.n_fft, cfg.hop, cfg.center)
    spec = torch.matmul(frames, bank)
    power = spec[..., :n_bins].square() + spec[..., n_bins:].square()
    if cfg.power != 2.0:
        power = power.sqrt().pow(cfg.power)
    melspec = torch.matmul(power + EPS64, mfb_t)
    return torch.log(melspec + EPS32).transpose(-1, -2)
