"""SS-MAST pretraining, closed loop: ``train/step.py:TrainStep`` over
``objectives/ssmast.py`` on MAST, one step after another, each on another
batch of a seeded pool of waves already on the card.

Set-up builds one TrainStep (the objective on the card with the seed's
weights, the key encoder a copy, the queue seeded; AdamW as the config
names it; the step's generator seeded) and makes its first
``checked_steps`` steps through the same call on the pool's first batches,
keeping the generator's state at each step's start, the losses, the first
gradient (from AdamW's state), the change of every leaf after them, the
queue and the key encoder's change, and what the first step's query pass
hands across the configuration's stages. The window goes on from there.
The check rebuilds the weights and replays the draws into the reference.
"""
from __future__ import annotations

import copy
import time

import torch

from portbench import counts
from portbench.loops import train_common
from portbench.harness import check, common
from portbench.harness.taps import Taps
from portbench.counts import mast as mast_counts
from portbench.reference import training as ref_training
from portbench.reference.precision import Precision


def ssmast_settings(config: dict, traffic: dict) -> dict:
    """What the reference reads of the configuration and the mix."""
    pre, run = config["pretrain"], config["run"]
    inp, aug = pre["input"], pre.get("augmentations") or {}
    return dict(
        n_mels=int(inp["n_mels"]), sample_rate=int(inp["sampling_rate"]), target_length=int(inp["target_length"]),
        wave_mixup=float(inp.get("mixup", 0.0)), freq_param=int(aug["SpecMask"]["freq_param"]),
        time_param=int(aug["SpecMask"]["time_param"]), norm_mean=float(pre["norm_stats"]["mean"]),
        norm_std=float(pre["norm_stats"]["std"]), norm_std_mult=float(pre.get("norm_std_mult", 2.0)),
        temperature=float(pre["softmax_temperature"]), momentum_base=float(pre["encoder_momentum"]),
        momentum_epochs=int(pre["momentum_total_epochs"]), steps_per_epoch=int(pre["steps_per_epoch"]),
        lr=float(run["learning_rate"]), weight_decay=float((run.get("optimizer_args") or {}).get("weight_decay", 0.0)),
        clip_samples=int(round(float(traffic["clip_seconds"]) * int(inp["sampling_rate"]))),
    )


def step_flops(arch: dict, s: dict, b: int, emb: int, n_neg: int) -> float:
    """One step's model FLOPs: the query pass forward and backward (3x its
    forward) and the key pass forward over 2B clips, each with the head, and
    the InfoNCE products (forward, and the gradient into q)."""
    dim = mast_counts.out_dim(arch, s["n_mels"], s["target_length"])
    clip = counts.encoder_flops("MAST", arch, s["n_mels"], s["target_length"]) + counts.linear_flops(1, dim, emb)
    nce = counts.linear_flops(2 * b, emb, n_neg + 1)
    return 4 * 2 * b * clip + 2 * nce


class Loop:
    kind = "train"

    def __init__(self, cell, seed: int, device: torch.device):
        from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
        from audiossl_tpu_torch.frontend import build_frontend
        from audiossl_tpu_torch.objectives import get_objective
        from audiossl_tpu_torch.train.optim import build_optimizer
        from audiossl_tpu_torch.train.step import TrainStep

        self.cell, self.seed, self.device = cell, seed, device
        self.phases = {"imported": time.perf_counter()}
        tr = cell.traffic
        config = copy.deepcopy(cell.config["program_config"])
        pre, run = config["pretrain"], config["run"]
        self.settings = s = ssmast_settings(config, tr)
        self.b = b = int(tr["batch"])
        self.n_checked = int(tr["checked_steps"])
        frontend = build_frontend(pre["input"])
        pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
        with torch.device("meta"):
            obj = get_objective("ssmast", config)
        self.obj = obj = obj.to_empty(device=device).train()
        self.shapes = {n: p.shape for n, p in obj.encoder.named_parameters()}
        self.queue_shape = (obj.emb_dim, obj.num_negatives)
        weights = self.weights()
        common.load_weights_(obj.encoder, weights)
        common.load_weights_(obj.encoder_k, weights)
        with torch.no_grad():
            obj.queue.copy_(self.queue0())
            obj.queue_ptr.zero_()
            obj.step.zero_()
        self.names = {p: n for n, p in obj.encoder.named_parameters()}
        self.opt, _ = build_optimizer(run["optimizer"], list(self.names), s["lr"], **(run.get("optimizer_args") or {}))
        self.gen = common.generator(seed, "draws", device)
        self.train_step = TrainStep(obj, pipeline, frontend, self.opt, self.gen, None, pre.get("normalization", "none"))
        self.aug = pipeline.init_state(frontend.n_mels, frontend.num_frames(s["clip_samples"]), device)
        self.pool = common.seeded_waves((int(tr["pool_batches"]), b, s["clip_samples"]), seed, "waves", device,
                                        float(tr["wave_std"]))
        self.phases["built"] = time.perf_counter()
        self.flops = step_flops(cell.config["arch"], s, b, obj.emb_dim, obj.num_negatives)
        # the checked steps, through the window's own call and feed
        self.gen_states, losses = [], []
        self.taps = Taps(cell.config.get("stages", []), obj.encoder.mast)
        with self.taps:  # keeps the stages' tensors of the first step's query pass
            for i in range(self.n_checked):
                self.gen_states.append(self.gen.get_state())
                losses.append(self.step(i))
                if i == 0:
                    grad1 = train_common.adam_first_grads(self.opt, self.names, self.opt.defaults["betas"][0])
        w0 = self.weights()
        change = check.leaf_norms({n: p.detach() - w0[n] for p, n in self.names.items()})
        key_change = check.leaf_norms({n: p.detach() - w0[n] for n, p in obj.encoder_k.named_parameters()})
        self.prog = {"losses": torch.stack(losses).tolist(), "grad1": grad1, "change": change,
                     "queue": obj.queue.detach().clone(), "key_change": key_change}
        del w0
        self.phases["checked steps"] = time.perf_counter()
        self.next = self.n_checked
        for _ in range(int(tr.get("warmup_steps", 0))):
            self.step(self.next % len(self.pool))
            self.next += 1
        train_common.sync(device)

    def weights(self) -> dict[str, torch.Tensor]:
        return common.seeded_weights(self.shapes, self.seed, self.device)

    def queue0(self) -> torch.Tensor:
        q = torch.randn(self.queue_shape, device=self.device,
                        generator=common.generator(self.seed, "queue", self.device))
        return q / q.norm(dim=0, keepdim=True)

    def step(self, i: int) -> torch.Tensor:
        self.aug, loss = self.train_step(self.aug, self.pool[i])
        return loss

    def window(self, seconds: float) -> dict:
        n, secs, self.next = train_common.step_window(self.step, len(self.pool), self.next, seconds, self.device)
        clips = n * self.b
        return {"metrics": {"train_clips_per_s": clips / secs}, "attempted": n, "failed": 0,
                "flops": n * self.flops, "seconds": secs,
                "lines": [f"train_clips_per_s {clips / secs} over {n} steps of {self.b} clips ({clips} clips) "
                          f"in {secs} s"]}

    def profiled(self) -> None:
        for _ in range(int(self.cell.traffic["profiled_steps"])):
            self.step(self.next % len(self.pool))
            self.next += 1

    def release(self) -> None:
        del self.train_step, self.opt, self.obj, self.aug, self.names
        self.pool = self.pool[: self.n_checked].clone()

    def reference(self, prec: Precision, half_batch: bool = False) -> dict:
        cfg = self.cell.config
        w0 = self.weights()
        return ref_training.ssmast_reference(w0, self.queue0(), list(self.pool[: self.n_checked]), self.gen_states,
                                             self.settings, cfg["arch"], prec,
                                             int(self.cell.traffic.get("reference_block", 32)), half_batch)

    def checks(self) -> list[tuple[str, float, float]]:
        ref = self.reference(Precision(**self.cell.config["precision"]["reference"]))
        self.ref, self.notes = ref, train_common.training_notes(self.prog, ref)
        return (train_common.training_checks(self.prog, ref, self.cell.limits)
                + check.stage_checks(self.cell, *self.stage_source()))

    def stage_source(self) -> tuple[Taps, dict, str]:
        """The taps of the first step's query pass, the weights it ran on,
        and their names' prefix before the encoder's."""
        return self.taps, self.weights(), "mast."
