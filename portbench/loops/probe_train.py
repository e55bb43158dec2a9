"""The downstream fine-tune, closed loop: ``downstream/probe.py:probe_step``
(log-mel, encoder, linear head, cross-entropy, Adam) one step after
another, each on another batch of a seeded pool of waves and labels
already on the card.

Set-up builds the DownstreamModel on the card with the seed's weights and
Adam as the probe makes it, and makes the first ``checked_steps`` steps
through the same call on the pool's first batches, keeping the losses, the
first gradient (from Adam's state), each leaf's change after them and what
the first step hands across the configuration's stages.
"""
from __future__ import annotations

import time

import torch

from portbench import counts
from portbench.loops import train_common
from portbench.harness import check, common
from portbench.harness.taps import Taps
from portbench.reference import training as ref_training
from portbench.reference.precision import Precision


class Loop:
    kind = "train"

    def __init__(self, cell, seed: int, device: torch.device):
        from audiossl_tpu_torch.downstream import probe
        from audiossl_tpu_torch.downstream.model import DownstreamModel
        from audiossl_tpu_torch.frontend.stft import LogMelConfig

        self.cell, self.seed, self.device = cell, seed, device
        self.phases = {"imported": time.perf_counter()}
        tr, config = cell.traffic, cell.config["program_config"]
        ds, run = config["downstream"], config["run"]
        enc = ds["base_encoder"]
        self.b, self.k = int(tr["batch"]), int(tr["num_classes"])
        self.n_checked = int(tr["checked_steps"])
        self.mel_cfg = LogMelConfig(sample_rate=int(ds["input"]["sampling_rate"]), n_mels=int(ds["input"]["n_mels"]))
        clip = int(round(float(tr["clip_seconds"]) * self.mel_cfg.sample_rate))
        n_frames = self.mel_cfg.num_frames(clip)
        with torch.device("meta"):
            model = DownstreamModel(
                n_mels=self.mel_cfg.n_mels, d=int(enc["output_dim"]), num_classes=self.k,
                finetune_layer=int(ds.get("finetune_layer", -1)), encoder_type=str(enc["type"]),
                input_tdim=n_frames, model_size=str(enc.get("model_size", "base")),
                patch_drop=float(enc.get("patch_drop", 0.0)))
        self.model = model = model.to_empty(device=device).train()
        self.shapes = {n: p.shape for n, p in model.named_parameters()}
        common.load_weights_(model, self.weights())
        self.names = {p: n for n, p in model.named_parameters()}
        self.lr = float(run.get("lr", 1e-3))
        self.opt = torch.optim.Adam(list(self.names), lr=self.lr)
        gen = common.generator(seed, "draws", device)
        n_pool = int(tr["pool_batches"])
        self.waves = common.seeded_waves((n_pool, self.b, clip), seed, "waves", device, float(tr["wave_std"]))
        self.labels = torch.randint(0, self.k, (n_pool, self.b), device=device,
                                    generator=common.generator(seed, "labels", device))
        self.train_step = lambda i: probe.probe_step(self.model, self.opt, self.mel_cfg, self.waves[i],
                                                     self.labels[i], gen)
        self.phases["built"] = time.perf_counter()
        arch = cell.config["arch"]
        encoder_flops = counts.encoder_flops(cell.config["encoder"], arch, self.mel_cfg.n_mels, n_frames)
        self.flops = 3 * self.b * (encoder_flops + counts.linear_flops(1, model.final.in_features, self.k))
        losses = []
        self.taps = Taps(cell.config.get("stages", []), model.encoder)
        with self.taps:  # keeps the stages' tensors of the first step
            for i in range(self.n_checked):
                losses.append(self.train_step(i))
                if i == 0:
                    grad1 = train_common.adam_first_grads(self.opt, self.names, self.opt.defaults["betas"][0])
        w0 = self.weights()
        change = check.leaf_norms({n: p.detach() - w0[n] for p, n in self.names.items()})
        self.prog = {"losses": torch.stack(losses).tolist(), "grad1": grad1, "change": change}
        del w0
        self.phases["checked steps"] = time.perf_counter()
        self.next = self.n_checked
        for _ in range(int(tr.get("warmup_steps", 0))):
            self.train_step(self.next % n_pool)
            self.next += 1
        train_common.sync(device)

    def weights(self) -> dict[str, torch.Tensor]:
        return common.seeded_weights(self.shapes, self.seed, self.device)

    def window(self, seconds: float) -> dict:
        n, secs, self.next = train_common.step_window(self.train_step, len(self.waves), self.next, seconds, self.device)
        clips = n * self.b
        return {"metrics": {"train_clips_per_s": clips / secs}, "attempted": n, "failed": 0,
                "flops": n * self.flops, "seconds": secs,
                "lines": [f"train_clips_per_s {clips / secs} over {n} steps of {self.b} clips ({clips} clips) "
                          f"in {secs} s"]}

    def profiled(self) -> None:
        for _ in range(int(self.cell.traffic["profiled_steps"])):
            self.train_step(self.next % len(self.waves))
            self.next += 1

    def release(self) -> None:
        del self.train_step, self.opt, self.model, self.names
        self.waves = self.waves[: self.n_checked].clone()
        self.labels = self.labels[: self.n_checked].clone()

    def reference(self, prec: Precision, half_batch: bool = False) -> dict:
        cfg = self.cell.config
        return ref_training.finetune_reference(
            self.weights(), list(zip(self.waves[: self.n_checked], self.labels[: self.n_checked])), cfg["encoder"],
            cfg["arch"], self.mel_cfg.n_mels, self.lr, prec, int(self.cell.traffic.get("reference_block", 8)),
            half_batch)

    def checks(self) -> list[tuple[str, float, float]]:
        ref = self.reference(Precision(**self.cell.config["precision"]["reference"]))
        self.ref, self.notes = ref, train_common.training_notes(self.prog, ref)
        return (train_common.training_checks(self.prog, ref, self.cell.limits)
                + check.stage_checks(self.cell, *self.stage_source()))

    def stage_source(self) -> tuple[Taps, dict, str]:
        """The taps of the first step, the weights it ran on, and their
        names' prefix before the encoder's."""
        return self.taps, self.weights(), "encoder."

