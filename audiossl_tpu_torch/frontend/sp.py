"""Sequence-parallel log-mel: the time axis split over a group (port of
``audiossl_tpu.frontend.sp``).

For audio too long for one card, each rank computes the frames whose
hop-aligned starts fall in its slice of the waveform. A frame that starts
near the slice's end reads n_fft - hop samples past it: the right
neighbour's head, which one ``dist.ppermute`` brings (the last rank gets
zeros). The spectrogram stays split over time ([B, n_mels, T / W] a rank),
for the blockwise attention of parallel/ring.py.

The local spectrogram is ``fused_stft.log_mel_fused`` (the log-mel kernel
on CUDA, one launch a rank; ``stft.log_mel`` on the CPU) of the extended
slice with ``center=False``: 1 + (n_local * hop + n_fft - hop - n_fft) / hop
= n_local frames, the ones JAX keeps, each from the same samples as the
one-process frontend's frame. The slice must be a multiple of hop and at
least the halo (``pad_for_sp`` pads the whole signal so).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from audiossl_tpu_torch.frontend.fused_stft import log_mel_fused
from audiossl_tpu_torch.frontend.stft import LogMelConfig, reflect_pad
from audiossl_tpu_torch.parallel import dist


def sp_num_frames(cfg: LogMelConfig, n_samples: int) -> int:
    """The valid global frame count (the one-process frontend's)."""
    return cfg.num_frames(n_samples)


def pad_for_sp(wave: torch.Tensor, cfg: LogMelConfig, n_shards: int) -> torch.Tensor:
    """librosa's reflect-centre pad (``cfg.center``), then zeros on the right
    to a multiple of hop * n_shards, so each shard's slice is hop-aligned."""
    if cfg.center:
        wave = reflect_pad(wave, cfg.n_fft)
    unit = cfg.hop * n_shards
    return F.pad(wave, (0, -(-wave.shape[-1] // unit) * unit - wave.shape[-1]))


def halo_pairs(w: int) -> list[tuple[int, int]]:
    """Each rank's head goes to its left neighbour; the last rank gets none."""
    return [(i, i - 1) for i in range(1, w)]


def sp_log_mel_local(wave_local: torch.Tensor, cfg: LogMelConfig, group=None) -> torch.Tensor:
    """This rank's slice [B, L / W] -> its spectrogram block [B, n_mels,
    (L / W) / hop]; one ``ppermute`` brings the halo."""
    halo = cfg.n_fft - cfg.hop
    if wave_local.shape[-1] < halo:
        raise ValueError(
            f"local time slice ({wave_local.shape[-1]} samples) is shorter than "
            f"the frame halo ({halo}); use fewer shards or longer audio"
        )
    if wave_local.shape[-1] % cfg.hop:
        raise ValueError("local slice length must be a multiple of hop (use pad_for_sp)")
    head = wave_local[..., :halo].contiguous()
    recv = dist.ppermute(head, halo_pairs(dist.world(group)), group, "sp_halo")
    return log_mel_fused(torch.cat([wave_local, recv], dim=-1), dataclasses.replace(cfg, center=False))
