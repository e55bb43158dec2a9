"""Kaldi-compatible log-mel fbank, the plain PyTorch version (port of
``audiossl_tpu.frontend.fbank``, the MAST frontend).

Replicates ``torchaudio.compliance.kaldi.fbank(htk_compat=True,
window_type='hanning', num_mel_bins=128, dither=0.0, frame_shift=10,
use_energy=False)`` as the MAST dataloader uses it
(extras/mast_new/mast/dataloader.py:131-132): snip-edges framing (25 ms /
10 ms), per-frame DC removal, preemphasis 0.97 (first sample replicated),
symmetric Hanning window, zero-pad to 512, power spectrum, HTK-scale
triangular mel banks (20 Hz to Nyquist, no area normalisation, Nyquist bin
zero-padded), then log(max(x, eps)).

The spectral part is the plain version of the dense-rows Hopper kernel
(``fused_stft.fused_rows_plain``): frame rows times the window-folded DFT
bank, power, mel product, log; f32 products with TF32 off. The waveform
mixup of the MAST loader takes its draws (gate, partner, lambda) as tensors.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from audiossl_tpu_torch.frontend import mel as melmod

EPS = float(np.finfo(np.float32).eps)  # torchaudio uses torch.finfo(float).eps
MIXUP_BETA = 10  # lambda ~ Beta(10, 10) (dataloader.py:117-127)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def kaldi_mel_banks(num_bins: int, n_fft: int, sr: int, low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """(num_bins, n_fft // 2) HTK-mel triangular banks, Kaldi formulation."""
    if high_freq <= 0:
        high_freq = sr / 2.0 + high_freq
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)
    mel_low, mel_high = mel(low_freq), mel(high_freq)
    delta = (mel_high - mel_low) / (num_bins + 1)
    fft_bin_width = sr / n_fft
    mel_k = mel(fft_bin_width * np.arange(n_fft // 2))  # [n_fft/2], excludes Nyquist
    left = mel_low + np.arange(num_bins)[:, None] * delta
    center = left + delta
    right = center + delta
    up = (mel_k[None, :] - left) / delta
    down = (right - mel_k[None, :]) / delta
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def hanning_sym(n: int) -> np.ndarray:
    """Kaldi 'hanning': symmetric Hann (denominator N - 1)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_mel_bins: int = 128
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0
    use_power: bool = True

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms * 1e-3)

    @property
    def shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms * 1e-3)

    @property
    def padded_window(self) -> int:
        return _next_pow2(self.window_size)

    def num_frames(self, n_samples: int) -> int:
        if n_samples < self.window_size:
            return 0
        return 1 + (n_samples - self.window_size) // self.shift


def fbank_constants(cfg: FbankConfig) -> tuple[np.ndarray, np.ndarray]:
    """(bank [window_size, 2 * n_bins], mel_t [n_bins, num_mel_bins]) f32:
    the symmetric Hanning window folded into the first ``window_size`` rows
    of the padded_window-point real DFT (the zero padding), and the Kaldi
    banks with the Nyquist column zero-padded, transposed."""
    ws, nfft = cfg.window_size, cfg.padded_window
    c, s = melmod.rdft_matrices(nfft)
    bank = hanning_sym(ws)[:, None] * np.concatenate([c, s], axis=1)[:ws]
    mfb = np.pad(kaldi_mel_banks(cfg.num_mel_bins, nfft, cfg.sample_rate, cfg.low_freq, cfg.high_freq), ((0, 0), (0, 1)))
    return bank.astype(np.float32), np.ascontiguousarray(mfb.T, np.float32)


@functools.lru_cache(maxsize=8)
def device_constants(cfg: FbankConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    bank, mel_t = fbank_constants(cfg)
    return torch.from_numpy(bank).to(device), torch.from_numpy(mel_t).to(device)


def frame_rows(wave: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """[..., n] -> [..., T, window_size] snip-edges frames after DC removal
    and preemphasis (the per-frame work ``kaldi_fbank_fused`` leaves outside
    its kernel, pallas_stft.py:551-558)."""
    n_frames = cfg.num_frames(wave.shape[-1])
    frames = wave.float()[..., : (n_frames - 1) * cfg.shift + cfg.window_size].unfold(-1, cfg.window_size, cfg.shift)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(-1, keepdim=True)
    if cfg.preemphasis:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * prev
    return frames


def fbank_from_frames(frames: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """[..., T, window_size] prepared frames -> [..., T, num_mel_bins]."""
    from audiossl_tpu_torch.frontend.fused_stft import fused_rows_plain

    if not cfg.use_power:
        raise NotImplementedError("use_power=False (magnitude fbank) is not ported")
    bank, mel_t = device_constants(cfg, frames.device)
    return fused_rows_plain(frames, bank, mel_t, "kaldi")


def kaldi_fbank(wave: torch.Tensor, cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """[..., n_samples] -> [..., n_frames, num_mel_bins] log-fbank (plain)."""
    return fbank_from_frames(frame_rows(wave, cfg), cfg)


def pad_or_trim_frames(fbank: torch.Tensor, target_length: int) -> torch.Tensor:
    """Zero-pad or cut the frame axis [..., T, M] to ``target_length``
    (dataloader.py:133-145)."""
    t = fbank.shape[-2]
    if t < target_length:
        return torch.nn.functional.pad(fbank, (0, 0, 0, target_length - t))
    return fbank[..., :target_length, :]


class WaveMixDraws(NamedTuple):
    """The random numbers of one batch's waveform mixup."""

    gate: torch.Tensor  # [B] bool: mix this clip
    partner: torch.Tensor  # [B] int64: the clip it mixes with
    lam: torch.Tensor  # [B] f32: its weight


def sample_wave_mixup(b: int, rate: float, generator: torch.Generator) -> WaveMixDraws:
    """The draws of ``batch_waveform_mixup`` from ``generator``, on its
    device: gate U(0, 1) < rate, a uniform partner, and lambda ~ Beta(10, 10)
    as X / (X + Y) with X, Y ~ Gamma(10), each a sum of 10 unit exponentials."""
    dev = generator.device
    gate = torch.rand(b, generator=generator, device=dev) < rate
    partner = torch.randint(0, b, (b,), generator=generator, device=dev)
    e = -torch.log1p(-torch.rand((b, 2 * MIXUP_BETA), generator=generator, device=dev, dtype=torch.float64))
    x = e[:, :MIXUP_BETA].sum(1)
    lam = (x / (x + e[:, MIXUP_BETA:].sum(1))).float()
    return WaveMixDraws(gate, partner, lam)


def waveform_mixup(w1: torch.Tensor, w2: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """MAST waveform-domain mixup at weight ``lam``, mean-centred
    (dataloader.py:117-127)."""
    mixed = lam * w1 + (1.0 - lam) * w2
    return mixed - mixed.mean(-1, keepdim=True)


def batch_waveform_mixup(waves: torch.Tensor, draws: WaveMixDraws) -> torch.Tensor:
    """Mean-centre every wave of [B, L], then mix clip i with clip
    ``partner[i]`` at ``lam[i]`` where ``gate[i]`` (dataloader.py:148-160).
    As in the JAX package the partner comes from the batch, not the dataset."""
    w = waves - waves.mean(-1, keepdim=True)
    mixed = waveform_mixup(w, w[draws.partner], draws.lam[:, None].to(w.dtype))
    return torch.where(draws.gate[:, None], mixed, w)
