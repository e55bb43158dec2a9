"""The fused log-mel kernel's wrapper: wave -> [B, n_mels, n_frames].

``log_mel_fused`` is the port of the TPU kernels
``audiossl_tpu/frontend/pallas_stft.py:log_mel_fused_ct2`` and
``log_mel_fused_ct``: one hand-written Hopper kernel (csrc/log_mel.cu) covers
the domains of both, i.e. every config with ``ct_eligible``. For a tensor on
the CPU it computes the plain version (stft.log_mel); for a CUDA tensor it
launches the kernel or raises.

The wrapper reflect-pads the wave (as the TPU ct2 wrapper does outside its
kernel), builds the host-side constants once per (config, device), and
hands the kernel the padded wave; the kernel frames, windows, transforms,
applies the filterbank and takes the log, writing the output directly.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from audiossl_tpu_torch import kernels
from audiossl_tpu_torch.frontend import mel as melmod
from audiossl_tpu_torch.frontend.stft import LogMelConfig, log_mel, padded_window, reflect_pad


def ct_eligible(cfg: LogMelConfig) -> bool:
    """Whether the Cooley-Tukey factorization supports ``cfg``: n_fft = 128*N2
    with N2 even (the TPU kernels' constraint, kept by the Hopper kernel)."""
    return cfg.n_fft % 256 == 0


def ct2_eligible(cfg: LogMelConfig) -> bool:
    """The TPU ct2 kernel's extra framing constraint (gcd(hop, 128) >= 16).
    The Hopper kernel frames any hop itself, so the port dispatches on
    :func:`ct_eligible` alone; this predicate only names which TPU kernel a
    config would have run."""
    return ct_eligible(cfg) and (
        cfg.hop % 128 == 0 or 128 // math.gcd(cfg.hop % 128, 128) <= 8
    )


def kernel_constants(cfg: LogMelConfig) -> tuple[np.ndarray, np.ndarray]:
    """(consts float32, mel_range int32 [n_mels, 2]) in csrc/log_mel.cu's layout:

    window [n_fft] | w2 [N2, R, 2] | tw [R, 128, 2] | w128 [128, 2] | fb [n_mels, n_bins]

    with W_M^q = (cos, -sin)(2 pi q / M) computed in float64, R = N2/2 + 1.
    ``mel_range[i]`` is the half-open range of filter i's nonzero bins.
    """
    n = cfg.n_fft
    n2 = n // 128
    r_max = n2 // 2 + 1

    def w(num: np.ndarray, den: int) -> np.ndarray:
        ang = 2.0 * np.pi * num / den
        return np.stack([np.cos(ang), -np.sin(ang)], axis=-1)

    w2 = w(np.outer(np.arange(n2), np.arange(r_max)), n2)  # [N2, R, 2]
    tw = w(np.outer(np.arange(r_max), np.arange(128)), n)  # [R, 128, 2]
    w128 = w(np.arange(128), 128)  # [128, 2]
    fb = melmod.mel_filterbank(cfg.sample_rate, n, cfg.n_mels, cfg.fmin, cfg.fmax, cfg.htk, cfg.norm)
    consts = np.concatenate(
        [padded_window(cfg).ravel(), w2.ravel(), tw.ravel(), w128.ravel(), fb.astype(np.float64).ravel()]
    ).astype(np.float32)
    mel_range = np.zeros((cfg.n_mels, 2), np.int32)
    for i, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if nz.size:
            mel_range[i] = (nz[0], nz[-1] + 1)
    return consts, mel_range


def design_flops(cfg: LogMelConfig, n_frames_total: int) -> int:
    """f32 operations this kernel's design does for ``n_frames_total`` frames
    (an FMA counts two): the radix-N2 stage with its window multiply and
    twiddle, the 128 complex multiply-adds of each of the n_fft/2 + 1 bins it
    computes, the power, and the filterbank over each mel's nonzero range
    plus the log's argument. This is what the design spends, not what the
    function needs: an FFT needs far fewer operations per bin."""
    n = cfg.n_fft
    n2, n_bins = n // 128, n // 2 + 1
    r_max = n2 // 2 + 1
    _, mel_range = kernel_constants(cfg)
    nnz = int((mel_range[:, 1] - mel_range[:, 0]).sum())
    radix = r_max * 128 * (n2 * (1 + 4) + 6)
    dft = n_bins * (128 * 8 + 3)
    mel = 3 * nnz + cfg.n_mels
    return n_frames_total * (radix + dft + mel)


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: LogMelConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    consts, mel_range = kernel_constants(cfg)
    return torch.from_numpy(consts).to(device), torch.from_numpy(mel_range).to(device)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = kernels.load("log_mel")
    lib.audiossl_log_mel.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.audiossl_log_mel.restype = ctypes.c_int
    return lib


def log_mel_fused(wave: torch.Tensor, cfg: LogMelConfig = LogMelConfig()) -> torch.Tensor:
    """[B, n_samples] (or [n_samples]) -> [B, n_mels, n_frames] log-mel.

    CPU tensor: the plain version. CUDA tensor: the Hopper kernel, or an
    error — never a silent fallback.
    """
    if wave.device.type == "cpu":
        return log_mel(wave, cfg)
    if wave.device.type != "cuda":
        raise ValueError(f"log_mel_fused takes a CPU or CUDA tensor, got {wave.device}")
    if not ct_eligible(cfg):
        raise ValueError(f"the log-mel kernel needs n_fft % 256 == 0, got n_fft={cfg.n_fft}")
    if cfg.power != 2.0:
        raise ValueError(f"the log-mel kernel computes the power spectrum (power=2), got {cfg.power}")
    if wave.dim() not in (1, 2):
        raise ValueError(f"expected [B, n] or [n] waves, got shape {tuple(wave.shape)}")
    squeeze = wave.dim() == 1
    wave = wave.reshape(-1, wave.shape[-1]).float()
    padded = (reflect_pad(wave, cfg.n_fft) if cfg.center else wave).contiguous()
    b, n = padded.shape
    if n < cfg.n_fft:
        raise ValueError(f"{n} samples after padding is shorter than n_fft={cfg.n_fft}")
    n_frames = 1 + (n - cfg.n_fft) // cfg.hop
    out = torch.empty((b, cfg.n_mels, n_frames), dtype=torch.float32, device=padded.device)
    if b:
        consts, mel_range = _device_constants(cfg, padded.device)
        with torch.cuda.device(padded.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib().audiossl_log_mel(
                padded.data_ptr(), b, n, n_frames, cfg.n_fft, cfg.hop, cfg.n_mels,
                consts.data_ptr(), mel_range.data_ptr(), out.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
        log_mel_fused.launches += 1
    return out[0] if squeeze else out


log_mel_fused.launches = 0  # kernel launches; the chip smoke run resets and reads it
