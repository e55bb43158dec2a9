"""Streaming frontends: chunked, stateful log-mel and fbank for continuous
audio (port of ``audiossl_tpu.frontend.streaming``).

A serving process that consumes a live stream, or a file too long to hold,
pushes hop-aligned chunks through :class:`StreamingLogMel` or
:class:`StreamingFbank`. Each carries exactly the overlap samples the next
frame needs and emits the frames the batch frontend gives on the
concatenated signal, librosa's ``center=True`` reflect padding included
(reproduced at the stream's edges by ``start`` and ``finish``)::

    sl = StreamingLogMel(cfg)
    state, lm0 = sl.start(first_chunk)       # left reflect pad + first frames
    state, lm  = sl.step(state, chunk)       # chunk // hop frames
    tail       = sl.finish(state)            # right reflect pad + last frames

On a CUDA tensor each chunk's frames go through the port's kernels: the
log-mel through ``frontend.logmel_features`` with ``center=False`` (the
log-mel kernel where the config is ``ct_eligible``, as ``frontend/sp.py``
runs it on a rank's slice, else the rows kernel in librosa mode), the fbank
through the rows kernel in Kaldi mode (``fused_stft.fused_rows``). On the
CPU they take the plain versions.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from audiossl_tpu_torch.frontend import fused_stft, logmel_features
from audiossl_tpu_torch.frontend.fbank import FbankConfig, fbank_from_frames, prepare_frames
from audiossl_tpu_torch.frontend.stft import LogMelConfig


def _reflect(x: torch.Tensor, pad: int, left: bool) -> torch.Tensor:
    """librosa's reflect pad of ``pad`` samples on one side of [..., n]."""
    flat = x.float().reshape(-1, 1, x.shape[-1])
    return F.pad(flat, (pad, 0) if left else (0, pad), mode="reflect").reshape(*x.shape[:-1], -1)


def _logmel_frames(x: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """[..., n] (edge padding applied) -> [..., n_mels, frames] with
    ``center=False`` framing: the batch path's tail."""
    lead = x.shape[:-1]
    out = logmel_features(x.reshape(-1, x.shape[-1]).float().contiguous(), dataclasses.replace(cfg, center=False))
    return out.reshape(*lead, *out.shape[-2:])


class StreamingLogMel:
    """Chunk lengths must be multiples of ``hop`` (the first also long
    enough to cover the reflect pad); the state is the sample window ahead
    of the next frame's start, so every ``step`` emits ``chunk // hop``
    frames."""

    def __init__(self, cfg: LogMelConfig = LogMelConfig()):
        self.cfg = cfg
        self.pad = cfg.n_fft // 2 if cfg.center else 0

    def buf_len(self, first_chunk_len: int) -> int:
        """The state's length after ``start``; checks the first chunk."""
        cfg = self.cfg
        avail = self.pad + first_chunk_len
        e0 = (avail - cfg.n_fft) // cfg.hop + 1
        if first_chunk_len % cfg.hop:
            raise ValueError(f"chunk length must be a multiple of hop={cfg.hop}")
        if e0 < 0 or (cfg.center and first_chunk_len < self.pad + 1):
            raise ValueError(f"first chunk too short: need >= {max(cfg.n_fft - self.pad, self.pad + 1)} samples")
        return avail - cfg.hop * e0

    def _empty(self, like: torch.Tensor) -> torch.Tensor:
        return torch.zeros((*like.shape[:-1], self.cfg.n_mels, 0), dtype=torch.float32, device=like.device)

    def start(self, first_chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (state, log-mel of the first frames), the left reflect pad
        taken from the chunk itself."""
        cfg = self.cfg
        self.buf_len(first_chunk.shape[-1])
        x = _reflect(first_chunk, self.pad, left=True) if self.pad else first_chunk
        e0 = (x.shape[-1] - cfg.n_fft) // cfg.hop + 1
        out = _logmel_frames(x[..., : cfg.n_fft + cfg.hop * (e0 - 1)], cfg) if e0 > 0 else self._empty(first_chunk)
        return x[..., cfg.hop * max(e0, 0):], out

    def step(self, state: torch.Tensor, chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (state, log-mel [..., n_mels, chunk // hop])."""
        cfg = self.cfg
        if chunk.shape[-1] % cfg.hop:
            raise ValueError(f"chunk length must be a multiple of hop={cfg.hop}")
        x = torch.cat([state, chunk], dim=-1)
        e = chunk.shape[-1] // cfg.hop
        return x[..., cfg.hop * e:], _logmel_frames(x[..., : cfg.n_fft + cfg.hop * (e - 1)], cfg)

    def finish(self, state: torch.Tensor) -> torch.Tensor:
        """The right edge's frames under the trailing reflect pad (none for
        ``center=False``, whose batch framing drops the partial tail)."""
        if not self.pad:
            return self._empty(state)
        return _logmel_frames(_reflect(state, self.pad, left=False), self.cfg)


class StreamingFbank:
    """Chunked Kaldi fbank (the MAST / AST frontend). Snip-edges framing pads
    nothing and treats every frame alone, so the state is the
    ``window_size - shift`` overlap; a step emits [..., chunk // shift,
    num_mel_bins], the batch ``kaldi_fbank``'s frames on the concatenated
    stream (no ``finish``: snip-edges drops the tail)."""

    def __init__(self, cfg: FbankConfig | None = None):
        self.cfg = cfg if cfg is not None else FbankConfig()

    def buf_len(self, first_chunk_len: int) -> int:
        cfg = self.cfg
        if first_chunk_len % cfg.shift:
            raise ValueError(f"chunk length must be a multiple of shift={cfg.shift}")
        if first_chunk_len < cfg.window_size:
            raise ValueError(f"first chunk too short: need >= {cfg.window_size} samples")
        return first_chunk_len - cfg.shift * cfg.num_frames(first_chunk_len)

    def start(self, first_chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        self.buf_len(first_chunk.shape[-1])
        return self._emit(first_chunk, self.cfg.num_frames(first_chunk.shape[-1]))

    def step(self, state: torch.Tensor, chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if chunk.shape[-1] % self.cfg.shift:
            raise ValueError(f"chunk length must be a multiple of shift={self.cfg.shift}")
        return self._emit(torch.cat([state, chunk], dim=-1), chunk.shape[-1] // self.cfg.shift)

    def _emit(self, x: torch.Tensor, n_frames: int) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        raw = x.float()[..., : (n_frames - 1) * cfg.shift + cfg.window_size].unfold(-1, cfg.window_size, cfg.shift)
        frames = prepare_frames(raw, cfg)
        if x.device.type == "cpu":
            out = fbank_from_frames(frames, cfg)
        else:
            rows = fused_stft.fused_rows(frames.reshape(-1, cfg.window_size).contiguous(), cfg, "kaldi")
            out = rows.view(*frames.shape[:-1], cfg.num_mel_bins)
        return x[..., cfg.shift * n_frames:], out
