"""Upstream pretraining loop (port of ``audiossl_tpu.train.loop``).

Drives ``TrainStep`` over epochs of the manifest loader with the JAX loop's
surface: JSON-lines stats (``stats.jsonl``: epoch, step, train_loss, batch
and data time) written every ``run.log_every`` steps, which is also when the
losses come back from the device and a non-finite one stops the run;
step checkpoints every ``save_every`` steps; a checkpoint at the end of an
epoch whose loss is the best so far, at the last epoch and at ``max_steps``.
An objective whose class is ``labeled`` (UnFuSeD) reads a labelled
manifest (columns ``files`` and ``label``) and gets each batch's ids.
A resumed run (``load_checkpoint``) restores the whole state and continues
the loader where the checkpoint left it, so it takes the same steps as a run
that was never stopped.

Kmix (``pretrain.augmentations.Kmix.centroid_path``) loads its centroids
from the .npy file there, as the JAX loop does.

SIGTERM (``train/preemption.py``) is checked at the log cadence: the loop
then writes the usual checkpoint at the current step, skips the epoch-end
one, and returns normally; a resume from it is exact.

Not ported yet: the multi-device paths (ROADMAP.md Queue 1, item 9):
``check_parallel_knobs`` refuses the knobs that ask for them, here and in
the DECAR, DeepCluster and fine-tune trainers.
"""
from __future__ import annotations

import copy
import json
import logging
import math
import os
import time
from typing import Any

import numpy as np
import torch

from audiossl_tpu_torch import config as cfgmod
from audiossl_tpu_torch import resolve_device
from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline, AugmentState, MixupBankState
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.frontend import build_frontend
from audiossl_tpu_torch.objectives import init_objective, objective_class
from audiossl_tpu_torch.ops.stats import RunningNormState
from audiossl_tpu_torch.train import checkpoint as ckpt
from audiossl_tpu_torch.train.optim import build_optimizer, warmup_cosine
from audiossl_tpu_torch.train.preemption import PreemptionGuard
from audiossl_tpu_torch.train.step import TrainStep

log = logging.getLogger("audiossl_tpu_torch.train")


class MetricsBuffer:
    """Deferred metric fetching: the loop appends device scalars and copies
    them to the host every ``flush_every`` steps, so the host does not wait
    for the device each step. A non-finite loss raises at the flush."""

    def __init__(self, flush_every: int, stats_file):
        self.flush_every = max(1, int(flush_every))
        self.stats_file = stats_file
        self.pending: list[tuple[int, int, torch.Tensor, float, float, dict]] = []
        self.last_loss = float("nan")
        self._loss_sum, self._loss_n = 0.0, 0

    def push(self, epoch: int, step: int, loss: torch.Tensor, batch_time: float, data_time: float,
             **extra: float) -> bool:
        """Queue one step's record; ``extra`` numbers go into its line as
        they are (DeepCluster-v1's ``kmeans_loss``)."""
        self.pending.append((epoch, step, loss, batch_time, data_time, extra))
        if len(self.pending) >= self.flush_every:
            self.flush()
            return True
        return False

    def flush(self) -> None:
        if not self.pending:
            return
        losses = torch.stack([p[2] for p in self.pending]).float().cpu().tolist()  # one host sync
        for (epoch, step, _, bt, dt, extra), loss in zip(self.pending, losses):
            print(json.dumps({"epoch": epoch, "step": step, "train_loss": loss, "batch_time": bt, "data_time": dt,
                              **extra}), file=self.stats_file)
            self.last_loss = loss
            self._loss_sum += loss
            self._loss_n += 1
            if not math.isfinite(loss):
                raise FloatingPointError(f"loss became {loss} at step {step}; stopping training")
        self.pending.clear()

    @property
    def avg_loss(self) -> float:
        """The mean train_loss of every step flushed since ``reset_avg``."""
        return self._loss_sum / self._loss_n if self._loss_n else float("nan")

    def reset_avg(self) -> None:
        self._loss_sum, self._loss_n = 0.0, 0


def check_parallel_knobs(config: dict[str, Any]) -> None:
    """The JAX trainer's checks of ``pretrain.tp``, ``run.fsdp`` and
    ``run.zero_optimizer`` (audiossl_tpu/train/loop.py:117-160, 216-220):
    first its ValueErrors (tp needs a MAST encoder; tp + zero, fsdp + tp and
    fsdp + zero exclude each other), then NotImplementedError for any knob
    that is set, or for ``run.world_size > 1``, since the port runs one
    process on one device. A config with no ``pretrain`` section (the
    fine-tune's) has no tp."""
    run, pre = config["run"], config.get("pretrain") or {}
    tp = int(pre.get("tp", 0) or 0)
    fsdp = bool(run.get("fsdp", False))
    zero = bool(run.get("zero_optimizer", False))
    if tp > 1:
        enc_type = (pre.get("base_encoder") or {}).get("type")
        if str(enc_type) != "MAST":
            raise ValueError("pretrain.tp requires base_encoder.type: MAST (the MViT weight-sharding specs, "
                             f"parallel/tp_mvit.py); got {enc_type!r}")
        if zero:
            raise ValueError("pretrain.tp is incompatible with run.zero_optimizer: the GSPMD step already "
                             "shards the moments on the model axis")
    if fsdp:
        if tp > 1:
            raise ValueError("run.fsdp and pretrain.tp are mutually exclusive; pick one")
        if zero:
            raise ValueError("run.fsdp is incompatible with run.zero_optimizer: FSDP already shards the "
                             "moments (and params/grads) over the mesh")
    world = int(run.get("world_size", 0) or 0)
    for knob, on in (("pretrain.tp > 1", tp > 1), ("run.fsdp", fsdp), ("run.zero_optimizer", zero),
                     ("run.world_size > 1", world > 1)):
        if on:
            raise NotImplementedError(f"{knob} is not ported yet: the port trains in one process on one device "
                                      "(ROADMAP.md Queue 1, item 9: parallelism)")


def aug_state_dict(state: AugmentState) -> dict[str, Any]:
    out: dict[str, Any] = {}
    if state.mixup is not None:
        out["mixup"] = {"bank": state.mixup.bank, "fill": state.mixup.fill, "ptr": state.mixup.ptr}
    if state.running_norm is not None:
        rn = state.running_norm
        out["running_norm"] = {"n": rn.n, "mean": rn.mean, "var": rn.var, "max_update": rn.max_update}
    return out


def aug_state_from_dict(d: dict[str, Any], device: torch.device) -> AugmentState:
    mix = d.get("mixup")
    rn = d.get("running_norm")
    return AugmentState(
        mixup=MixupBankState(mix["bank"].to(device), int(mix["fill"]), int(mix["ptr"])) if mix else None,
        running_norm=RunningNormState(int(rn["n"]), rn["mean"].to(device), rn["var"].to(device), int(rn["max_update"]))
        if rn else None,
    )


def kmix_centroids(pre: dict[str, Any]) -> np.ndarray | None:
    """Kmix's [K, n_mels] centroids from ``augmentations.Kmix.centroid_path``
    (augmentations.py:130-136), or None when Kmix is off."""
    cp = ((pre.get("augmentations") or {}).get("Kmix") or {}).get("centroid_path")
    if not cp or cp == "None":
        return None
    centroids = np.load(cp)
    log.info("Kmix enabled with %s centroids from %s", centroids.shape, cp)
    return centroids


def train_upstream(
    config: dict[str, Any],
    input_csv: str,
    upstream: str,
    load_checkpoint: str | None = None,
    max_steps: int | None = None,
    save_every: int = 500,
    seed: int = 31,  # the reference seeds torch.manual_seed(31) (extras/delores-s/main.py:59-64)
    device: str | torch.device = "cuda",
):
    """Pretrain ``upstream`` on the manifest ``input_csv``. Returns
    (objective, final step, checkpoint directory). ``config`` is not
    changed: the run writes ``pretrain.steps_per_epoch`` into its own copy
    (the one its checkpoints store)."""
    check_parallel_knobs(config)
    dev = resolve_device(device)
    config = copy.deepcopy(config)
    run, pre = config["run"], config["pretrain"]
    batch = int(run["batch_size"])
    frontend = build_frontend(pre["input"])
    clip = cfgmod.clip_samples(config)
    loader = ManifestLoader(
        input_csv, batch_size=batch, clip_samples=clip, sample_rate=frontend.sample_rate,
        labeled=objective_class(upstream).labeled, num_workers=int(run.get("num_dataloader_workers", 8)), seed=seed,
        wire_dtype=str(run.get("wire_dtype", "int16")), on_error=str(run.get("data_on_error", "raise")),
    )
    normalization = str(pre.get("normalization", "mean_var"))
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=loader.num_samples,
                               centroids=kmix_centroids(pre))
    steps_per_epoch = max(len(loader), 1)
    pre["steps_per_epoch"] = steps_per_epoch  # SS-MAST's momentum schedule reads it
    objective = init_objective(upstream, config, seed, dev).train()

    epochs = int(run.get("epochs", 1))
    lr = float(run.get("learning_rate", 0.03))
    if run.get("lr_schedule") == "warmup_cosine":
        lr = warmup_cosine(lr, epochs * steps_per_epoch, 10 * steps_per_epoch)
    optimizer, scheduler = build_optimizer(
        str(run.get("optimizer", "sgd")), [p for p in objective.parameters() if p.requires_grad], lr,
        **(run.get("optimizer_args") or {}),
    )
    generator = torch.Generator(device=dev).manual_seed(seed)
    aug_state = pipeline.init_state(frontend.n_mels, frontend.num_frames(clip), dev)
    step, position = 0, None
    if load_checkpoint:
        saved = ckpt.load_checkpoint(load_checkpoint)
        objective.load_state_dict(saved["objective"])
        optimizer.load_state_dict(saved["optimizer"])
        if scheduler is not None:
            scheduler.load_state_dict(saved["scheduler"])
        aug_state = aug_state_from_dict(saved["augment"], dev)
        generator.set_state(saved["generator"])
        step, position = int(saved["step"]), saved["loader"]
        log.info("resumed from %s at step %d", load_checkpoint, step)
    train_step = TrainStep(objective, pipeline, frontend, optimizer, generator, scheduler, normalization)

    save_path = run.get("save_path", "./runs/" + upstream)
    ckpt_dir = save_path + "_chkp"
    os.makedirs(ckpt_dir, exist_ok=True)
    keep_last = int(run.get("keep_checkpoints", 0)) or None

    def save() -> None:
        state = {
            "objective": objective.state_dict(),
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict() if scheduler is not None else None,
            "augment": aug_state_dict(aug_state),
            "generator": generator.get_state(),
            "loader": loader.position,
            "step": step,
            "config": config,
        }
        ckpt.save_checkpoint(ckpt_dir, step, state, objective.export_state_dict(), config, keep_last)

    start_epoch, start_batch, rng_state = 0, 0, None
    if position is not None:
        start_epoch, start_batch, rng_state = position["epoch"], position["batch"], position["rng"]
        if start_batch >= steps_per_epoch:
            start_epoch, start_batch, rng_state = start_epoch + 1, 0, None
    best_loss = float("inf")
    done = preempted = False
    with open(os.path.join(ckpt_dir, "stats.jsonl"), "a", buffering=1) as stats_file, PreemptionGuard() as guard:
        buf = MetricsBuffer(int(run.get("log_every", 10)), stats_file)
        t_end = time.time()
        for epoch in range(start_epoch, epochs):
            first = epoch == start_epoch
            for waves, labels in loader.epoch(epoch, start_batch if first else 0, rng_state if first else None):
                data_time = time.time() - t_end
                if labels is not None:
                    labels = torch.from_numpy(labels).to(dev)
                aug_state, loss = train_step(aug_state, torch.from_numpy(waves).to(dev), labels)
                step += 1
                batch_time = time.time() - t_end
                t_end = time.time()
                if buf.push(epoch, step, loss, batch_time, data_time):
                    log.info("epoch %d step %d loss %.4f (batch %.3fs data %.3fs)",
                             epoch, step, buf.last_loss, batch_time, data_time)
                    # the preemption check rides the log cadence
                    if guard.should_stop():
                        save()
                        log.warning("SIGTERM: preemption checkpoint saved at step %d; exiting", step)
                        done = preempted = True
                        break
                if save_every and step % save_every == 0:
                    save()
                if max_steps and step >= max_steps:
                    done = True
                    break
            buf.flush()
            # best-train-loss checkpoint at epoch granularity (the reference's
            # ModelCheckpoint(monitor='train_loss', save_top_k=1)); none after
            # the preemption save, which is at this step already
            if (buf.last_loss < best_loss or epoch == epochs - 1 or done) and not preempted:
                best_loss = min(best_loss, buf.last_loss)
                save()
            if done:
                break
    return objective, step, ckpt_dir
