"""Serving of trained encoders: waveform -> frontend -> encoder -> embedding.

Port of ``audiossl_tpu.serve.export``. The JAX package lowers the pipeline
to a StableHLO artifact; here the artifact is one ``torch.save`` file that
holds the frontend spec, the clip length, the encoder type, size and input
frames, the compute dtype and the encoder's reference-layout
``state_dict`` — like the ``.jexp``, it needs no checkpoint or config to
serve. Every downstream encoder serves behind either frontend: AudioNTT
behind the log-mel (the Hopper log-mel kernel on the card), MAST and AST
behind the Kaldi fbank of their pretraining (the rows kernel in Kaldi mode
on the card, padded or cut to ``target_length``). The compute dtype is
the JAX export's: ``default`` each encoder's own (AudioNTT and MAST bf16,
AST f32 with bf16 attention operands on the card), ``bf16``, or ``f32``
(IEEE f32 on the card, TF32 off and f32 attention).

CLI:
    python -m audiossl_tpu_torch.serve.export --checkpoint <save_path>_chkp --out enc.pt \
        [--dtype default|f32|bf16] [--clip_samples N] --selftest
    python -m audiossl_tpu_torch.serve.export --state_dict encoder.pth \
        [--config configs/delores_s.yaml] --out enc.pt --selftest
    python -m audiossl_tpu_torch.serve.export --artifact enc.pt --selftest

``--checkpoint`` reads a port pretraining run's ``config.yaml`` and newest
``encoder/<step>.pt`` (an SS-MAST run serves its MAST trunk behind its
fbank), as JAX's ``_build_model_and_vars`` does. ``encoder.pth`` is what
``python -m audiossl_tpu.models.torch_export --arch audiontt`` writes;
without either, ``--seed N`` makes seeded random weights for the encoder
the ``--config`` names.

Library:
    emb = build_embedder(state_dict, frontend, clip_samples, encoder_type="MAST")
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
from audiossl_tpu_torch.config import encoder_section
from audiossl_tpu_torch.downstream.model import DownstreamModel
from audiossl_tpu_torch.frontend import FrontendSpec, build_frontend
from audiossl_tpu_torch.models.convert import port_layout, reference_layout
from audiossl_tpu_torch.models.surgery import newest_encoder, token_grid

log = logging.getLogger(__name__)

DTYPES = {"default": None, "bf16": torch.bfloat16, "f32": torch.float32}
_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


def _grid_ft(encoder_type: str, n_mels: int, n_frames: int) -> tuple[int, int] | None:
    """AST's (freq, time) patch grid, which its reference layout is ordered by."""
    return token_grid((n_frames, n_mels))[::-1] if encoder_type == "AST" else None


class Embedder(nn.Module):
    """waves [b, clip_samples] f32 -> embedding [b, D] f32: the encoder's
    pooled output on the frontend's features."""

    def __init__(self, model: DownstreamModel, frontend: FrontendSpec, clip_samples: int, model_size: str = "base"):
        super().__init__()
        self.model = model
        self.frontend = frontend
        self.clip_samples = clip_samples
        self.model_size = model_size
        self.n_frames = frontend.num_frames(clip_samples)

    def features(self, waves: torch.Tensor) -> torch.Tensor:
        """[b, L] -> [b, 1, n_mels, T]."""
        return self.frontend(waves)[:, None]

    def forward(self, waves: torch.Tensor) -> torch.Tensor:
        return self.model(self.features(waves))

    def artifact(self) -> dict[str, Any]:
        """Everything serving needs, as plain types and CPU tensors."""
        enc_type = self.model.encoder_type
        sd = {k: v.detach().cpu() for k, v in self.model.encoder.state_dict().items()}
        return {
            "frontend": dataclasses.asdict(self.frontend),
            "clip_samples": int(self.clip_samples),
            "encoder_type": enc_type,
            "model_size": self.model_size,
            "input_tdim": int(self.n_frames),
            "compute_dtype": _DTYPE_NAMES[self.model.compute_dtype],
            "state_dict": reference_layout(sd, enc_type, _grid_ft(enc_type, self.frontend.n_mels, self.n_frames)),
        }


def build_embedder(
    state_dict: Mapping[str, torch.Tensor],
    frontend: FrontendSpec,
    clip_samples: int,
    compute_dtype: torch.dtype | None = None,
    device: str | torch.device = "cuda",
    encoder_type: str = "AudioNTT2020Task6",
    model_size: str = "base",
) -> Embedder:
    """The serving module for a reference-layout encoder ``state_dict``
    (turned into the port's layout and loaded with ``strict=True``), in
    eval mode on ``device``; ``compute_dtype`` None is the encoder's own."""
    dev = resolve_device(device)
    n_frames = frontend.num_frames(clip_samples)
    d = int(state_dict["fc.3.weight"].shape[0]) if encoder_type == "AudioNTT2020Task6" else 0
    model = DownstreamModel(n_mels=frontend.n_mels, d=d, num_classes=0, encoder_type=encoder_type,
                            compute_dtype=compute_dtype, input_tdim=n_frames, model_size=model_size)
    model.encoder.load_state_dict(port_layout(state_dict, encoder_type, _grid_ft(encoder_type, frontend.n_mels, n_frames)),
                                  strict=True)
    return Embedder(model, frontend, clip_samples, model_size).to(dev).eval()


def save_artifact(embedder: Embedder, path: str) -> None:
    torch.save(embedder.artifact(), path)


def load_artifact(path: str) -> dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def embedder_from_artifact(artifact: Mapping[str, Any], device: str | torch.device = "cuda") -> Embedder:
    emb = build_embedder(
        artifact["state_dict"], FrontendSpec(**artifact["frontend"]), int(artifact["clip_samples"]),
        DTYPES[artifact["compute_dtype"]], device, artifact.get("encoder_type", "AudioNTT2020Task6"),
        artifact.get("model_size", "base"),
    )
    if "input_tdim" in artifact and emb.n_frames != int(artifact["input_tdim"]):
        raise ValueError(f"the artifact's input_tdim {artifact['input_tdim']} != its frontend's {emb.n_frames} frames")
    return emb


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


def encoder_spec(pre: Mapping[str, Any]) -> tuple[str, str, int]:
    """(encoder type, model size, output width) of a pretrain config
    section. The size is ``base_encoder.model_size``, else the section's
    own ``model_size`` (where SS-MAST keeps it), else base."""
    enc = pre.get("base_encoder", {})
    size = str(enc.get("model_size", pre.get("model_size", "base")))
    return str(enc.get("type", "AudioNTT2020Task6")), size, int(enc.get("output_dim", 2048))


def seeded_state_dict(encoder_type: str, model_size: str, n_mels: int, n_frames: int, d: int,
                      seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights of an encoder, in the reference layout."""
    if encoder_type == "AudioNTT2020Task6":
        from audiossl_tpu_torch.models.audiontt import random_state_dict

        return random_state_dict(n_mels, d, seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = DownstreamModel(n_mels, d, 0, encoder_type=encoder_type, input_tdim=n_frames, model_size=model_size)
    return reference_layout(model.encoder.state_dict(), encoder_type, _grid_ft(encoder_type, n_mels, n_frames))


def embedder_from_config(
    config: Mapping[str, Any], state_dict: Mapping[str, torch.Tensor] | None, seed: int,
    clip_samples: int | None, dtype: str, device: str | torch.device,
) -> Embedder:
    """The encoder a pretrain config names behind its frontend, with the
    given or seeded weights."""
    pre = encoder_section(config)  # a pretraining run's section, or a MAST fine-tune's
    inp = pre.get("input", {})
    frontend = build_frontend(inp)  # log-mel, or the Kaldi fbank of a MAST / AST config
    if clip_samples is None:
        clip_samples = int(float(inp.get("length_wave", 0.95)) * frontend.sample_rate)
    enc_type, size, d = encoder_spec(pre)
    if state_dict is None:
        state_dict = seeded_state_dict(enc_type, size, frontend.n_mels, frontend.num_frames(clip_samples), d, seed)
    return build_embedder(state_dict, frontend, clip_samples, DTYPES[dtype], device, enc_type, size)


def embedder_from_checkpoint(checkpoint: str, clip_samples: int | None, dtype: str = "default",
                             device: str | torch.device = "cuda") -> Embedder:
    """The encoder of a port pretraining run: its ``config.yaml`` and newest
    ``encoder/<step>.pt`` (JAX's ``_build_model_and_vars``)."""
    from audiossl_tpu_torch.config import load_config

    config = load_config(os.path.join(checkpoint, "config.yaml"))
    sd = torch.load(newest_encoder(checkpoint), map_location="cpu", weights_only=True)
    return embedder_from_config(config, sd, 0, clip_samples, dtype, device)


def _selftest(path: str, device: str) -> None:
    enc = ServingEncoder(path, device=device)
    out = enc(np.zeros((3, enc.clip_samples), np.float32))
    print(f"selftest OK: [3, {enc.clip_samples}] waves -> {out.shape} embeddings")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", help="port pretraining checkpoint dir (config.yaml + encoder/<step>.pt)")
    p.add_argument("--state_dict", help="reference-layout AudioNTT encoder .pth (audiossl_tpu.models.torch_export)")
    p.add_argument("--config", default=os.path.join("configs", "delores_s.yaml"),
                   help="pretrain config naming the frontend, clip length and encoder (without --checkpoint)")
    p.add_argument("--seed", type=int, default=0, help="seed of random weights without --checkpoint or --state_dict")
    p.add_argument("--out", help="artifact path to write (.pt)")
    p.add_argument("--clip_samples", type=int, default=None, help="input length (defaults to the config's length_wave)")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="default",
                   help="encoder compute dtype (default = the encoder's own)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--artifact", help="existing artifact for --selftest")
    p.add_argument("--selftest", action="store_true", help="run a zero batch through the artifact and print the shape")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if args.artifact and args.selftest:
        _selftest(args.artifact, args.device)
        return

    if not args.out:
        p.error("--out is required for export")
    if args.checkpoint:
        emb = embedder_from_checkpoint(args.checkpoint, args.clip_samples, args.dtype, args.device)
        source = f"checkpoint {args.checkpoint}"
    else:
        from audiossl_tpu_torch.config import load_config

        sd = torch.load(args.state_dict, map_location="cpu", weights_only=True) if args.state_dict else None
        emb = embedder_from_config(load_config(args.config), sd, args.seed, args.clip_samples, args.dtype, args.device)
        source = "given" if sd else f"seed {args.seed}"
    save_artifact(emb, args.out)
    log.info("wrote %s %s behind %s (%d-sample clips, %d frames, %s weights, dtype %s) to %s (%.1f MB)",
             emb.model.encoder_type, emb.model_size, emb.frontend.kind, emb.clip_samples, emb.n_frames, source,
             args.dtype, args.out, os.path.getsize(args.out) / 1e6)
    if args.selftest:
        _selftest(args.out, args.device)


if __name__ == "__main__":
    main()
