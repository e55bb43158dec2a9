"""Frontend registry: waveform -> [B, F, T] feature maps.

Mirrors ``audiossl_tpu.frontend``:
  * ``logmel`` — librosa-style STFT power mel. On a CUDA tensor it runs the
    Hopper log-mel kernel (fused_stft.log_mel_fused) whenever the config is
    ``ct_eligible``, which the TPU package splits between its ct2 and ct
    kernels, and the rows kernel in librosa mode
    (fused_stft.log_mel_dense_fused, the TPU package's general
    ``log_mel_fused``) for any other n_fft; on the CPU the plain version
    (stft.log_mel). A CUDA tensor never reaches the plain version.
  * ``fbank`` — Kaldi-compatible fbank for MAST/AST, padded or cut to
    ``target_length`` frames. On a CUDA tensor it runs the rows Hopper
    kernel in Kaldi mode (fused_stft.kaldi_fbank_fused); on the CPU the plain
    version (fbank.kaldi_fbank). The JAX package keeps fbank on XLA for a
    TPU-only reason (the 400-tap window pads to 512 lanes).

A ``FrontendSpec`` is called on waves, [B, L] -> [B, F, T], in training
and in serving alike; neither kind falls back to a plain version on the
card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from audiossl_tpu_torch.frontend import fused_stft
from audiossl_tpu_torch.frontend.fbank import FbankConfig, pad_or_trim_frames
from audiossl_tpu_torch.frontend.stft import LogMelConfig, log_mel


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    kind: str  # 'logmel' | 'fbank'
    n_mels: int
    sample_rate: int
    target_length: int | None = None  # fbank: fixed frame count

    def logmel_config(self) -> LogMelConfig:
        """The log-mel kind's config (a fbank spec has none)."""
        if self.kind != "logmel":
            raise ValueError(f"a {self.kind!r} frontend has no log-mel config")
        return LogMelConfig(sample_rate=self.sample_rate, n_mels=self.n_mels)

    def fbank_config(self) -> FbankConfig:
        return FbankConfig(sample_rate=self.sample_rate, num_mel_bins=self.n_mels)

    def num_frames(self, n_samples: int) -> int:
        if self.kind == "fbank":
            return self.target_length or self.fbank_config().num_frames(n_samples)
        return self.logmel_config().num_frames(n_samples)

    def __call__(self, waves: torch.Tensor) -> torch.Tensor:
        """[B, L] -> [B, F, T]."""
        if self.kind == "fbank":
            cfg = self.fbank_config()
            fb = fused_stft.kaldi_fbank_fused(waves, cfg)  # [B, T, M]; the plain version on the CPU
            if self.target_length:
                fb = pad_or_trim_frames(fb, self.target_length)
            return fb.transpose(-1, -2)
        return logmel_features(waves, self.logmel_config())


def logmel_features(waves: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """[B, L] -> [B, n_mels, T]. CPU tensor: the plain version. CUDA tensor:
    the log-mel kernel where the config is ``ct_eligible``, else the rows
    kernel in librosa mode; either raises rather than fall back."""
    if waves.device.type == "cpu":
        return log_mel(waves, cfg)
    if fused_stft.ct_eligible(cfg):
        return fused_stft.log_mel_fused(waves, cfg)
    out = fused_stft.log_mel_dense_fused(waves.reshape(-1, waves.shape[-1]).float().contiguous(), cfg)
    return out.reshape(*waves.shape[:-1], *out.shape[1:])


def build_frontend(input_cfg: dict[str, Any]) -> FrontendSpec:
    """From the YAML `pretrain.input` / `downstream.input` section."""
    kind = "fbank" if str(input_cfg.get("type", "raw_wav")) == "fbank" else "logmel"
    return FrontendSpec(
        kind=kind,
        n_mels=int(input_cfg.get("n_mels", 64)),
        sample_rate=int(input_cfg.get("sampling_rate", 16000)),
        target_length=int(input_cfg["target_length"]) if input_cfg.get("target_length") else None,
    )
