"""Serving of trained encoders: waveform -> log-mel -> encoder -> embedding.

Port of ``audiossl_tpu.serve.export``. The JAX package lowers the pipeline
to a StableHLO artifact; here the artifact is one ``torch.save`` file that
holds the frontend config, the clip length, the compute dtype and the
encoder's reference-layout ``state_dict`` — like the ``.jexp``, it needs no
checkpoint or config to serve. On the card the log-mel runs in the Hopper
kernel (frontend.fused_stft) and the encoder in bf16 by default.

CLI:
    python -m audiossl_tpu_torch.serve.export --state_dict encoder.pth \
        [--config configs/delores_s.yaml] --out enc.pt [--dtype default|f32|bf16] --selftest
    python -m audiossl_tpu_torch.serve.export --artifact enc.pt --selftest

``encoder.pth`` is what ``python -m audiossl_tpu.models.torch_export --arch
audiontt`` writes; without ``--state_dict``, ``--seed N`` makes seeded
random weights.

Library:
    emb = build_embedder(state_dict, frontend, clip_samples)
    save_artifact(emb, "enc.pt")
    enc = ServingEncoder("enc.pt", bucket=64)
    out = enc(waves)            # np [n, clip_samples] -> np [n, D]
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from audiossl_tpu_torch import resolve_device
from audiossl_tpu_torch.downstream.model import DownstreamModel
from audiossl_tpu_torch.frontend import FrontendSpec, build_frontend, logmel_features

log = logging.getLogger(__name__)

DTYPES = {"default": torch.bfloat16, "bf16": torch.bfloat16, "f32": torch.float32}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


class Embedder(nn.Module):
    """waves [b, clip_samples] f32 -> embedding [b, D] f32 (the time mean of
    the encoder's final features)."""

    def __init__(self, model: DownstreamModel, frontend: FrontendSpec, clip_samples: int):
        super().__init__()
        self.model = model
        self.frontend = frontend
        self.clip_samples = clip_samples
        self.logmel = frontend.logmel_config()

    def features(self, waves: torch.Tensor) -> torch.Tensor:
        """[b, L] -> [b, 1, n_mels, T]."""
        return logmel_features(waves, self.logmel)[:, None]

    def forward(self, waves: torch.Tensor) -> torch.Tensor:
        return self.model(self.features(waves))

    def artifact(self) -> dict[str, Any]:
        """Everything serving needs, as plain types and CPU tensors."""
        return {
            "frontend": dataclasses.asdict(self.frontend),
            "clip_samples": int(self.clip_samples),
            "compute_dtype": _DTYPE_NAMES[self.model.encoder.compute_dtype],
            "state_dict": {k: v.detach().cpu() for k, v in self.model.encoder.state_dict().items()},
        }


def build_embedder(
    state_dict: Mapping[str, torch.Tensor],
    frontend: FrontendSpec,
    clip_samples: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Embedder:
    """The serving module for a reference-layout AudioNTT ``state_dict``
    (loaded with ``strict=True``), in eval mode on ``device``."""
    dev = resolve_device(device)
    n_mels = frontend.n_mels
    d = int(state_dict["fc.3.weight"].shape[0])
    model = DownstreamModel(n_mels=n_mels, d=d, num_classes=0, compute_dtype=compute_dtype)
    model.encoder.load_state_dict(dict(state_dict), strict=True)
    return Embedder(model, frontend, clip_samples).to(dev).eval()


def save_artifact(embedder: Embedder, path: str) -> None:
    torch.save(embedder.artifact(), path)


def load_artifact(path: str) -> dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def embedder_from_artifact(artifact: Mapping[str, Any], device: str | torch.device = "cuda") -> Embedder:
    return build_embedder(
        artifact["state_dict"], FrontendSpec(**artifact["frontend"]), int(artifact["clip_samples"]),
        DTYPES[artifact["compute_dtype"]], device,
    )


class ServingEncoder:
    """Callable over an artifact (a path or a loaded dict): np waves
    [n, clip_samples] -> np embeddings [n, D].

    ``bucket`` rounds each request's batch up to a multiple (zero padding,
    result sliced back), so the card sees few distinct shapes;
    ``fixed_batch`` pads and chunks every request to exactly that batch
    (the JAX package's native-kernel artifacts run at one fixed batch).
    """

    def __init__(
        self,
        artifact: str | os.PathLike | Mapping[str, Any],
        bucket: int | None = None,
        fixed_batch: int | None = None,
        device: str | torch.device = "cuda",
    ):
        if isinstance(artifact, (str, os.PathLike)):
            artifact = load_artifact(os.fspath(artifact))
        self.embedder = embedder_from_artifact(artifact, device)
        self.device = next(self.embedder.parameters()).device
        self.clip_samples = self.embedder.clip_samples
        self.bucket = bucket
        self.fixed_batch = fixed_batch

    @torch.inference_mode()
    def _run(self, waves: np.ndarray) -> np.ndarray:
        return self.embedder(torch.from_numpy(waves).to(self.device)).cpu().numpy()

    def __call__(self, waves: np.ndarray) -> np.ndarray:
        waves = np.asarray(waves, np.float32)
        if waves.ndim != 2 or waves.shape[1] != self.clip_samples:
            raise ValueError(f"expected waves [n, {self.clip_samples}], got {waves.shape}")
        n = waves.shape[0]
        if self.fixed_batch:
            fb = self.fixed_batch
            if n % fb:
                waves = np.pad(waves, ((0, fb - n % fb), (0, 0)))
            chunks = [self._run(waves[i : i + fb]) for i in range(0, waves.shape[0], fb)]
            return np.concatenate(chunks)[:n]
        if self.bucket and n % self.bucket:
            waves = np.pad(waves, ((0, self.bucket - n % self.bucket), (0, 0)))
        return self._run(waves)[:n]


def _embedder_from_config(
    config: str, state_dict: Mapping[str, torch.Tensor] | None, seed: int,
    clip_samples: int | None, dtype: str, device: str,
) -> Embedder:
    """The encoder a pretrain config names, with the given or seeded weights."""
    from audiossl_tpu_torch.config import load_config
    from audiossl_tpu_torch.models.audiontt import random_state_dict

    pre = load_config(config)["pretrain"]
    inp = pre.get("input", {})
    frontend = build_frontend(inp)
    if clip_samples is None:
        clip_samples = int(float(inp.get("length_wave", 0.95)) * frontend.sample_rate)
    enc = pre["base_encoder"]
    if str(enc.get("type", "AudioNTT2020Task6")) != "AudioNTT2020Task6":
        raise NotImplementedError(f"serving {enc['type']!r} is not ported yet (AudioNTT2020Task6 only)")
    if state_dict is None:
        state_dict = random_state_dict(frontend.n_mels, int(enc.get("output_dim", 2048)), seed)
    return build_embedder(state_dict, frontend, clip_samples, DTYPES[dtype], device)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--state_dict", help="reference-layout AudioNTT encoder .pth (audiossl_tpu.models.torch_export)")
    p.add_argument("--config", default=os.path.join("configs", "delores_s.yaml"),
                   help="pretrain config naming the frontend, clip length and encoder width")
    p.add_argument("--seed", type=int, default=0, help="seed of random weights when --state_dict is absent")
    p.add_argument("--out", help="artifact path to write (.pt)")
    p.add_argument("--clip_samples", type=int, default=None, help="input length (defaults to the config's length_wave)")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="default",
                   help="encoder compute dtype (default = bf16)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--artifact", help="existing artifact for --selftest")
    p.add_argument("--selftest", action="store_true", help="run a zero batch through the artifact and print the shape")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if args.artifact and args.selftest:
        enc = ServingEncoder(args.artifact, device=args.device)
        out = enc(np.zeros((3, enc.clip_samples), np.float32))
        print(f"selftest OK: [3, {enc.clip_samples}] waves -> {out.shape} embeddings")
        return

    if not args.out:
        p.error("--out is required for export")
    sd = torch.load(args.state_dict, map_location="cpu", weights_only=True) if args.state_dict else None
    emb = _embedder_from_config(args.config, sd, args.seed, args.clip_samples, args.dtype, args.device)
    save_artifact(emb, args.out)
    log.info("wrote %s (%d-sample clips, %s weights) to %s (%.1f MB)",
             "AudioNTT2020Task6", emb.clip_samples, "given" if sd else f"seed {args.seed}",
             args.out, os.path.getsize(args.out) / 1e6)
    if args.selftest:
        enc = ServingEncoder(args.out, device=args.device)
        out = enc(np.zeros((3, enc.clip_samples), np.float32))
        print(f"selftest OK: [3, {enc.clip_samples}] waves -> {out.shape} embeddings")


if __name__ == "__main__":
    main()
