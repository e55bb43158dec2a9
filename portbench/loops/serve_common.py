"""What the serving loops share: the in-memory artifact of the seed's
weights behind the configuration's serving frontend, the host pool of
clips, the taps of the configuration's stages, and the check of sampled
answers and of the stages against the reference."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import counts
from portbench.harness import check, common
from portbench.harness.taps import Taps
from portbench.reference import frontend as ref_frontend
from portbench.reference import models as ref_models
from portbench.reference.precision import Precision


class Served:
    """The encoder of ``cell.config`` served through ``ServingEncoder`` with
    ``serve_kw`` (``bucket`` or ``fixed_batch``) on seeded weights, and a
    host pool of ``pool_clips`` seeded clips."""

    def __init__(self, cell, seed: int, device: torch.device, serve_kw: dict):
        from audiossl_tpu_torch.downstream.model import DownstreamModel
        from audiossl_tpu_torch.frontend import build_frontend
        from audiossl_tpu_torch.models.convert import reference_layout
        from audiossl_tpu_torch.serve.export import ServingEncoder, _grid_ft

        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.inp = cfg["serve_input"]
        frontend = build_frontend(self.inp)
        self.clip = int(round(float(tr["clip_seconds"]) * frontend.sample_rate))
        self.n_frames = frontend.num_frames(self.clip)
        enc_type, size = cfg["encoder"], str(cfg["model_size"])
        with torch.device("meta"):
            model = DownstreamModel(n_mels=frontend.n_mels, d=int(cfg["arch"].get("d", 0)), num_classes=0,
                                    encoder_type=enc_type, input_tdim=self.n_frames, model_size=size)
        self.shapes = {n: p.shape for n, p in model.encoder.named_parameters()}
        grid = _grid_ft(enc_type, frontend.n_mels, self.n_frames)  # the layout's grid, where it has one
        artifact = {"frontend": dataclasses.asdict(frontend), "clip_samples": self.clip, "encoder_type": enc_type,
                    "model_size": size, "input_tdim": self.n_frames, "compute_dtype": "default",
                    "state_dict": reference_layout(self.weights(), enc_type, grid)}
        self.encoder = ServingEncoder(artifact, device=device, **serve_kw)
        del artifact
        self.taps = Taps(cfg.get("stages", []), self.encoder.embedder.model.encoder)
        n_pool = int(tr["pool_clips"])
        self.pool = common.seeded_waves((n_pool, self.clip), seed, "waves", device, float(tr["wave_std"])).cpu().numpy()
        self.clip_flops = counts.encoder_flops(cfg["encoder"], cfg["arch"], frontend.n_mels, self.n_frames)

    def weights(self) -> dict[str, torch.Tensor]:
        return common.seeded_weights(self.shapes, self.seed, self.device)

    def reference(self, waves: np.ndarray, prec: Precision, block: int = 16) -> torch.Tensor:
        """The reference's embeddings of ``waves`` [n, clip], in blocks of rows."""
        cfg = self.cell.config
        w = self.weights()
        out = []
        with torch.no_grad(), prec.products():
            for i in range(0, len(waves), block):
                x = torch.from_numpy(waves[i:i + block]).to(self.device)
                feats = ref_frontend.kaldi_fbank(x, int(self.inp["n_mels"]), int(self.inp["sampling_rate"]),
                                                 int(self.inp["target_length"]))[:, None]
                out.append(ref_models.encoder_forward(cfg["encoder"], feats, w, cfg["arch"], prec).double().cpu())
        return torch.cat(out)

    def tapped(self, waves: np.ndarray) -> np.ndarray:
        """One request served with the stages' taps on."""
        with self.taps:
            return self.encoder(waves)

    def checks(self, waves: np.ndarray, answers: np.ndarray) -> list[tuple[str, float, float]]:
        ref = self.reference(waves, Precision(**self.cell.config["precision"]["reference"]))
        return ([("emb_gap", check.row_gap(torch.from_numpy(answers), ref), self.cell.limits["emb_gap"])]
                + check.stage_checks(self.cell, *self.stage_source()))

    def stage_source(self) -> tuple[Taps, dict, str]:
        """The taps of the tapped request, the weights it ran on, and their
        names' prefix before the encoder's (none)."""
        return self.taps, self.weights(), ""
