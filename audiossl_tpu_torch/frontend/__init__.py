"""Frontend registry: waveform -> [B, F, T] feature maps.

Mirrors ``audiossl_tpu.frontend``:
  * ``logmel`` — librosa-style STFT power mel. On a CUDA tensor it runs the
    Hopper log-mel kernel (fused_stft.log_mel_fused) whenever the config is
    ``ct_eligible``, which the TPU package splits between its ct2 and ct
    kernels; otherwise the plain version (stft.log_mel).
  * ``fbank`` — Kaldi-compatible fbank for MAST/AST; not ported yet (the
    SS-MAST slice in ROADMAP.md), so it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from audiossl_tpu_torch.frontend import fused_stft
from audiossl_tpu_torch.frontend.stft import LogMelConfig, log_mel

_FBANK_TODO = (
    "the Kaldi fbank frontend is not ported yet: it belongs to the SS-MAST "
    "slice (ROADMAP.md, Queue 1)"
)


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    kind: str  # 'logmel' | 'fbank'
    n_mels: int
    sample_rate: int
    target_length: int | None = None  # fbank: fixed frame count

    def logmel_config(self) -> LogMelConfig:
        if self.kind == "fbank":
            raise NotImplementedError(_FBANK_TODO)
        return LogMelConfig(sample_rate=self.sample_rate, n_mels=self.n_mels)

    def num_frames(self, n_samples: int) -> int:
        return self.logmel_config().num_frames(n_samples)

    def __call__(self, waves: torch.Tensor) -> torch.Tensor:
        """[B, L] -> [B, F, T]."""
        return logmel_features(waves, self.logmel_config())


def logmel_features(waves: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """[B, L] -> [B, n_mels, T]: the kernel on CUDA when the config allows
    it, else the plain version."""
    if waves.is_cuda and fused_stft.ct_eligible(cfg):
        return fused_stft.log_mel_fused(waves, cfg)
    return log_mel(waves, cfg)


def build_frontend(input_cfg: dict[str, Any]) -> FrontendSpec:
    """From the YAML `pretrain.input` / `downstream.input` section."""
    kind = "fbank" if str(input_cfg.get("type", "raw_wav")) == "fbank" else "logmel"
    return FrontendSpec(
        kind=kind,
        n_mels=int(input_cfg.get("n_mels", 64)),
        sample_rate=int(input_cfg.get("sampling_rate", 16000)),
        target_length=int(input_cfg["target_length"]) if input_cfg.get("target_length") else None,
    )
