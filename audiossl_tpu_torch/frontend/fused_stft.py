"""The spectrogram kernels' wrappers.

``log_mel_fused`` (wave -> [B, n_mels, n_frames]) is the port of the TPU kernels
``audiossl_tpu/frontend/pallas_stft.py:log_mel_fused_ct2`` and
``log_mel_fused_ct``: one hand-written Hopper source (csrc/log_mel.cu) covers
the domains of both, i.e. every config with ``ct_eligible``, in two designs
(``log_mel_design``): a shared-memory FFT behind in-kernel framing where
n_fft is a power of two (every config of the repo), the Cooley-Tukey
128-point DFT for the other widths (768). For a tensor on the CPU it
computes the plain version (stft.log_mel); for a CUDA tensor it launches
the kernel or raises.

The wrapper reflect-pads the wave (as the TPU ct2 wrapper does outside its
kernel), builds the host-side constants once per (config, device), and
hands the kernel the padded wave; the kernel frames, windows, transforms,
applies the filterbank and takes the log, writing the output directly.

``kaldi_fbank_fused`` (wave -> [B, n_frames, n_mels], the MAST frontend) and
``log_mel_dense_fused`` (wave -> [B, n_mels, n_frames]) are the port of the
TPU functions ``pallas_stft.py:kaldi_fbank_fused`` and ``log_mel_fused``,
which share one kernel (``_fused_rows``): frame rows times the
window-folded DFT bank, power, mel and log. Here too they share one Hopper
source (csrc/fused_rows.cu) in its two log modes: a shared-memory FFT where
the transform length is a power of two (every config of the repo), the
dense window-folded DFT for any other width. Framing (and for Kaldi DC
removal and preemphasis) runs in plain torch before it. The plain version
of that kernel is ``fused_rows_plain``; ``frontend.logmel_features``
routes every CUDA log-mel that is not ``ct_eligible`` to
``log_mel_dense_fused``. Both FFT designs run the passes of
csrc/fft_smem.cuh and take their constants from ``rows_constants``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from audiossl_tpu_torch import kernels, no_tf32
from audiossl_tpu_torch.frontend import fbank as fbankmod
from audiossl_tpu_torch.frontend import mel as melmod
from audiossl_tpu_torch.frontend import stft as stftmod
from audiossl_tpu_torch.frontend.stft import EPS32, EPS64, LogMelConfig, log_mel, padded_window, reflect_pad

ROW_MODES = ("kaldi", "librosa")
_MODE_CODE = {("kaldi", False): 0, ("librosa", False): 1, ("kaldi", True): 2}  # csrc/fused_rows.cu's kMode*


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


def log_mel_design(cfg: LogMelConfig) -> str:
    """Which design of csrc/log_mel.cu a ``ct_eligible`` config takes: "fft"
    where n_fft is a power of two, else "cooley-tukey"."""
    return "fft" if fft_width(cfg.n_fft) else "cooley-tukey"


def kernel_constants(cfg: LogMelConfig) -> "RowsConstants":
    """The FFT design's constants (numpy): ``rows_constants(cfg)``, the
    layout fused_rows.cu's FFT design reads too: window [n_fft], twiddle
    table [n_fft, 2], each filter's packed nonzero weights (``fb_packed``)
    and where they start (``mel_off``), ``mel_range``, and for the bins
    below ``n_dense`` (those of single-bin filters) the window-folded bank."""
    return rows_constants(cfg)


def ct_constants(cfg: LogMelConfig) -> tuple[np.ndarray, np.ndarray]:
    """(consts float32, mel_range int32 [n_mels, 2]) in the Cooley-Tukey
    design's layout (csrc/log_mel.cu, widths that are not a power of two):

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
    return consts, _sparse_rows(fb.T)[1]


def design_flops(cfg: LogMelConfig, n_frames_total: int) -> int:
    """f32 operations csrc/log_mel.cu's design for ``cfg`` does for
    ``n_frames_total`` frames (an FMA counts two). FFT design, per frame: the
    window multiply, each radix-4 Stockham butterfly's three complex twiddle
    multiplies and DFT_4 (34), each radix-2 butterfly (10), the split
    post-pass and power (19 a bin), the dense bins' FMA chains, and the
    filterbank over each mel's nonzero range plus the log's argument.
    Cooley-Tukey design: the radix-N2 stage with its window multiply and
    twiddle, the 128 complex multiply-adds of each of the n_fft/2 + 1 bins,
    the power and the filterbank."""
    n = cfg.n_fft
    n_bins = n // 2 + 1
    if log_mel_design(cfg) == "fft":
        c = kernel_constants(cfg)
        m = n // 2
        log_m = m.bit_length() - 1
        fft = (log_m // 2) * (m // 4) * 34 + (log_m % 2) * (m // 2) * 10 + (m + 1) * 19
        per_frame = n + fft + c.n_dense * (4 * n + 3) + 3 * len(c.fb_packed) + cfg.n_mels
        return n_frames_total * per_frame
    n2 = n // 128
    r_max = n2 // 2 + 1
    _, mel_range = ct_constants(cfg)
    nnz = int((mel_range[:, 1] - mel_range[:, 0]).sum())
    radix = r_max * 128 * (n2 * (1 + 4) + 6)
    dft = n_bins * (128 * 8 + 3)
    mel = 3 * nnz + cfg.n_mels
    return n_frames_total * (radix + dft + mel)


@functools.lru_cache(maxsize=16)
def _ct_device_constants(cfg: LogMelConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    consts, mel_range = ct_constants(cfg)
    return torch.from_numpy(consts).to(device), torch.from_numpy(mel_range).to(device)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = kernels.load("log_mel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.audiossl_log_mel_ct.argtypes = [p, i, i, i, i, i, i, p, p, p, p]
    lib.audiossl_log_mel_ct.restype = i
    lib.audiossl_log_mel_fft_warps.argtypes = [i, i, i, i]
    lib.audiossl_log_mel_fft_warps.restype = i
    lib.audiossl_log_mel_fft.argtypes = [p, i, i, i, i, i, i, i, p, p, p, p, p, p, i, p, p]
    lib.audiossl_log_mel_fft.restype = i
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
        lib = _lib()
        with torch.cuda.device(padded.device):
            stream = torch.cuda.current_stream().cuda_stream
            if log_mel_design(cfg) == "fft":
                c = _rows_constants(cfg, padded.device)
                nnz = c.fb_packed.numel()
                if lib.audiossl_log_mel_fft_warps(cfg.n_fft, cfg.hop, nnz, cfg.n_mels) == 0:
                    raise ValueError(f"n_fft={cfg.n_fft} at hop {cfg.hop} exceeds the log-mel kernel's shared memory")
                err = lib.audiossl_log_mel_fft(
                    padded.data_ptr(), b, n, n_frames, cfg.n_fft, cfg.hop, cfg.n_mels, nnz, c.window.data_ptr(),
                    c.twiddle.data_ptr(), c.fb_packed.data_ptr(), c.mel_range.data_ptr(), c.mel_off.data_ptr(),
                    c.bank.data_ptr(), c.n_dense, out.data_ptr(), stream)
            else:
                consts, mel_range = _ct_device_constants(cfg, padded.device)
                err = lib.audiossl_log_mel_ct(
                    padded.data_ptr(), b, n, n_frames, cfg.n_fft, cfg.hop, cfg.n_mels,
                    consts.data_ptr(), mel_range.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
        log_mel_fused.launches += 1
    return out[0] if squeeze else out


log_mel_fused.launches = 0  # kernel launches; the chip smoke run resets and reads it


@torch.library.custom_op("audiossl_torch::log_mel", mutates_args=())
def log_mel_op(wave: torch.Tensor, sample_rate: int, n_fft: int, win_length: int, hop: int, n_mels: int,
               fmin: float, fmax: float, center: bool, htk: bool, norm: str | None, power: float) -> torch.Tensor:
    """``log_mel_fused`` as a ``torch.library`` custom op, so that
    ``torch.export`` records the log-mel kernel as one node (the native
    serving artifact, serve/export.py): [B, n] -> [B, n_mels, n_frames], the
    kernel on a CUDA tensor, the plain version on the CPU. ``win_length`` 0
    is n_fft. Call it through ``log_mel_native``."""
    cfg = LogMelConfig(sample_rate=sample_rate, n_fft=n_fft, win_length=win_length or None, hop=hop, n_mels=n_mels,
                       fmin=fmin, fmax=fmax, center=center, htk=htk, norm=norm, power=power)
    return log_mel_fused(wave.contiguous(), cfg).contiguous()


@log_mel_op.register_fake
def _log_mel_op_fake(wave, sample_rate, n_fft, win_length, hop, n_mels, fmin, fmax, center, htk, norm, power):
    n_frames = 1 + (wave.shape[-1] + (n_fft if center else 0) - n_fft) // hop
    return wave.new_empty((wave.shape[0], n_mels, n_frames), dtype=torch.float32)


def log_mel_native(wave: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """[B, n] -> [B, n_mels, n_frames] through ``log_mel_op``."""
    return log_mel_op(wave.float(), cfg.sample_rate, cfg.n_fft, cfg.win_length or 0, cfg.hop, cfg.n_mels, cfg.fmin,
                      cfg.fmax, cfg.center, cfg.htk, cfg.norm, cfg.power)


# ---------------------------------------------------------------- dense rows (csrc/fused_rows.cu)


def fused_rows_plain(frames: torch.Tensor, bank: torch.Tensor, mel_t: torch.Tensor, mode: str,
                     magnitude: bool = False) -> torch.Tensor:
    """[..., win] frame rows -> [..., n_mels]: frames @ bank [win, 2 nb]
    (cos columns, then sin), power, then ``mode`` "kaldi":
    log(max(power @ mel_t, EPS32)) or "librosa": log((power + EPS64) @ mel_t
    + EPS32). ``magnitude`` (Kaldi only, ``use_power=False``): sqrt(power)
    takes the power's place. f32 products with TF32 off: the plain version
    of the kernel."""
    n_bins = mel_t.shape[0]
    if magnitude and mode != "kaldi":
        raise ValueError("the magnitude spectrum is a Kaldi-mode option")
    with no_tf32():
        spec = torch.matmul(frames.float(), bank)
        power = spec[..., :n_bins].square() + spec[..., n_bins:].square()
        if magnitude:
            power = power.sqrt()
        if mode == "kaldi":
            return torch.log(torch.clamp_min(torch.matmul(power, mel_t), EPS32))
        if mode == "librosa":
            return torch.log(torch.matmul(power + EPS64, mel_t) + EPS32)
    raise ValueError(f"mode must be one of {ROW_MODES}, got {mode!r}")


@functools.lru_cache(maxsize=1)
def _rows_lib() -> ctypes.CDLL:
    lib = kernels.load("fused_rows")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.audiossl_fused_rows_tile.argtypes = [i, i]
    lib.audiossl_fused_rows_tile.restype = i
    lib.audiossl_fused_rows_fft_warps.argtypes = [i, i, i, i]
    lib.audiossl_fused_rows_fft_warps.restype = i
    lib.audiossl_fused_rows.argtypes = [p, i, i, i, i, p, p, p, i, p, p]
    lib.audiossl_fused_rows.restype = i
    lib.audiossl_fused_rows_fft.argtypes = [p, i, i, i, i, i, p, p, p, p, p, i, p, i, p, p, p]
    lib.audiossl_fused_rows_fft.restype = i
    return lib


def fft_width(n: int) -> bool:
    """Whether rows zero-padded to ``n`` take the FFT design (a power of two,
    n >= 8); any other width takes the dense design."""
    return n >= 8 and n & (n - 1) == 0


def rows_twiddles(n: int) -> np.ndarray:
    """[n, 2] f32: W_n^e = (cos, -sin)(2 pi e / n), computed in float64."""
    ang = 2.0 * np.pi * np.arange(n) / n
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


def _sparse_rows(mel_t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """mel_t [n_bins, n_mels] -> (fb [n_mels, n_bins] f32, mel_range [n_mels, 2]
    int32: each filter's first nonzero bin and one past its last)."""
    fb = np.ascontiguousarray(mel_t.T, np.float32)
    mel_range = np.zeros((fb.shape[0], 2), np.int32)
    for i, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if nz.size:
            mel_range[i] = (nz[0], nz[-1] + 1)
    return fb, mel_range


class RowsConstants(NamedTuple):
    """The rows kernel's constants for one config. ``n`` is the transform
    length the rows are zero-padded to; ``bank`` (window folded into the
    real DFT, [win, 2 n_bins]) and ``mel_t`` serve the plain version, ``bank``
    and ``fb`` the dense design; ``window``, ``twiddle`` (rows_twiddles),
    ``fb_packed`` (each filter's weights over its nonzero bins, filter after
    filter) and ``mel_off`` (where filter i's weights start) the FFT design;
    ``mel_range`` both designs. ``n_dense``: the FFT design takes the power of
    bins below it from the bank's arithmetic (the bins of single-bin
    filters, rounded up to 32; see csrc/fused_rows.cu). Arrays are numpy
    (``rows_constants``) or tensors on a device (``_rows_constants``)."""

    n: int
    n_dense: int
    bank: Any
    mel_t: Any
    fb: Any
    mel_range: Any
    window: Any
    twiddle: Any
    fb_packed: Any
    mel_off: Any


def rows_constants(cfg) -> RowsConstants:
    """RowsConstants (numpy) for an FbankConfig (Kaldi mode: the symmetric
    Hanning over window_size samples, padded to padded_window) or a
    LogMelConfig (librosa mode: the periodic Hann centred in n_fft)."""
    if isinstance(cfg, fbankmod.FbankConfig):
        bank, mel_t = fbankmod.fbank_constants(cfg)
        n, window = cfg.padded_window, fbankmod.hanning_sym(cfg.window_size)
    else:
        bank, mel_t = stftmod._constants(cfg)
        n, window = cfg.n_fft, padded_window(cfg).astype(np.float32)
    fb, mel_range = _sparse_rows(mel_t)
    widths = mel_range[:, 1] - mel_range[:, 0]
    mel_off = (np.cumsum(widths) - widths).astype(np.int32)
    packed = [fb[i, lo:hi] for i, (lo, hi) in enumerate(mel_range)]
    fb_packed = np.concatenate(packed).astype(np.float32) if packed else np.zeros(0, np.float32)
    single = mel_range[widths == 1]
    n_dense = min(-(-int(single[:, 1].max()) // 32) * 32, n // 2 + 1) if len(single) else 0
    return RowsConstants(n, n_dense, bank, mel_t, fb, mel_range, window, rows_twiddles(n), fb_packed, mel_off)


@functools.lru_cache(maxsize=16)
def _rows_constants(cfg, device: torch.device) -> RowsConstants:
    """rows_constants(cfg) with every array as a tensor on ``device``."""
    c = rows_constants(cfg)
    return RowsConstants(c.n, c.n_dense, *(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in c[2:]))


def _check_wave(wave: torch.Tensor, name: str) -> None:
    if wave.device.type != "cuda":
        raise ValueError(f"{name} takes a CPU or CUDA tensor, got {wave.device}")
    if wave.dim() != 2 or wave.dtype != torch.float32 or not wave.is_contiguous():
        raise ValueError(f"{name} takes a contiguous f32 [B, n] wave on the card, got {tuple(wave.shape)} "
                         f"{wave.dtype}{'' if wave.is_contiguous() else ', not contiguous'}")


def fused_rows(frames: torch.Tensor, cfg, mode: str) -> torch.Tensor:
    """The kernel on contiguous f32 frame rows [rows, win] on the card ->
    [rows, n_mels] f32: the FFT design where the transform length is a power
    of two, else the dense design. In Kaldi mode an FbankConfig with
    ``use_power=False`` launches the magnitude mode. Raises for anything
    else; it never falls back."""
    if mode not in ROW_MODES:
        raise ValueError(f"mode must be one of {ROW_MODES}, got {mode!r}")
    code = _MODE_CODE[(mode, mode == "kaldi" and not cfg.use_power)]
    if frames.device.type != "cuda" or frames.dim() != 2 or frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError(f"fused_rows takes contiguous f32 [rows, win] frames on the card, got "
                         f"{tuple(frames.shape)} {frames.dtype} on {frames.device}")
    c = _rows_constants(cfg, frames.device)
    rows, win = frames.shape
    n_bins, n_mels = c.mel_t.shape
    if c.bank.shape != (win, 2 * n_bins):
        raise ValueError(f"frames of width {win} do not fit the bank {tuple(c.bank.shape)}")
    lib = _rows_lib()
    fft = fft_width(c.n)
    if fft and lib.audiossl_fused_rows_fft_warps(win, c.n, c.fb_packed.numel(), n_mels) == 0:
        raise ValueError(f"a {c.n}-point transform exceeds the FFT kernel's shared memory")
    if not fft and lib.audiossl_fused_rows_tile(win, n_bins) == 0:
        raise ValueError(f"rows of {win} samples and {n_bins} bins exceed the kernel's shared-memory tile")
    out = torch.empty((rows, n_mels), dtype=torch.float32, device=frames.device)
    if rows:
        with torch.cuda.device(frames.device):
            stream = torch.cuda.current_stream().cuda_stream
            if fft:
                dense_pw = torch.empty((rows, c.n_dense), dtype=torch.float32, device=frames.device) if c.n_dense else None
                err = lib.audiossl_fused_rows_fft(
                    frames.data_ptr(), rows, win, c.n, n_mels, c.fb_packed.numel(), c.window.data_ptr(),
                    c.twiddle.data_ptr(), c.fb_packed.data_ptr(), c.mel_range.data_ptr(), c.mel_off.data_ptr(),
                    code, c.bank.data_ptr(), c.n_dense, dense_pw.data_ptr() if c.n_dense else None,
                    out.data_ptr(), stream)
            else:
                err = lib.audiossl_fused_rows(
                    frames.data_ptr(), rows, win, n_bins, n_mels, c.bank.data_ptr(), c.fb.data_ptr(),
                    c.mel_range.data_ptr(), code, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"fused_rows kernel launch failed: CUDA error {err}")
        fused_rows.launches[mode] += 1
    return out


def kaldi_fbank_fused(wave: torch.Tensor, cfg: fbankmod.FbankConfig = fbankmod.FbankConfig()) -> torch.Tensor:
    """[B, n] -> [B, n_frames, num_mel_bins] Kaldi fbank (``use_power=False``:
    of the magnitude spectrum). CPU tensor: the plain version
    (fbank.kaldi_fbank). CUDA tensor: frames in plain torch, then the kernel
    in Kaldi mode, or an error."""
    if wave.device.type == "cpu":
        return fbankmod.kaldi_fbank(wave, cfg)
    _check_wave(wave, "kaldi_fbank_fused")
    b = wave.shape[0]
    frames = fbankmod.frame_rows(wave, cfg)
    n_frames = frames.shape[1]
    out = fused_rows(frames.reshape(b * n_frames, cfg.window_size).contiguous(), cfg, "kaldi")
    return out.view(b, n_frames, cfg.num_mel_bins)


def log_mel_dense_fused(wave: torch.Tensor, cfg: LogMelConfig = LogMelConfig()) -> torch.Tensor:
    """[B, n] -> [B, n_mels, n_frames] librosa log-mel through the rows
    kernel in librosa mode (the TPU ``log_mel_fused``, which takes any
    n_fft); ``frontend.logmel_features`` sends it every CUDA config that is
    not ``ct_eligible``. CPU tensor: the plain version (stft.log_mel)."""
    if wave.device.type == "cpu":
        return log_mel(wave, cfg)
    _check_wave(wave, "log_mel_dense_fused")
    if cfg.power != 2.0:
        raise ValueError(f"the rows kernel computes the power spectrum (power=2), got {cfg.power}")
    b = wave.shape[0]
    frames = stftmod.frame_signal(wave, cfg.n_fft, cfg.hop, cfg.center)
    n_frames = frames.shape[1]
    out = fused_rows(frames.reshape(b * n_frames, cfg.n_fft).contiguous(), cfg, "librosa")
    return out.view(b, n_frames, cfg.n_mels).transpose(1, 2)


fused_rows.launches = dict.fromkeys(ROW_MODES, 0)  # kernel launches by mode; the chip smoke run resets and reads them
