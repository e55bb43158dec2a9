"""DECAR-v2 trainer: k-means over a memory bank each epoch, prototype CE each
step (port of ``audiossl_tpu.train.decar_loop``).

extras/decar-v2/main.py's structure (SURVEY.md §3.3): fill the embedding
memory bank with an eval-mode pass over epoch 0 (raw log-mel, no
RunningNorm: utils.py:244-269), then each epoch (1) spherical k-means over
the bank, its centroids copied into the prototype weights, (2) CE steps
against the epoch's assignments, view 2's scores, while view 1's embeddings
refresh the bank in place at slots (epoch step * B + arange(B)) mod M.
LARC-wrapped SGD (momentum 0.9, weight decay 1e-6, trust 0.001, no clip) on
``warmup_cosine(lr, epochs * spe, 10 * spe, final_lr / lr)``
(main.py:93-122); the prototypes' gradients are zeroed for the first
``freeze_prototypes_niters`` steps.

On the card the log-mel kernel makes every batch's log-mel (one launch a
bank batch, one a step) and block 1's kernels run both views' training-mode
passes (forward 2, backward sums 1, weight 1 a step: view 1 has no
gradient). The checkpoint (at each epoch's end and at ``max_steps``) holds
the bank, the assignments, the epoch step, the optimizer, the generator and
the loader's position, so a resumed run takes the steps of a run never
stopped; it re-clusters only where that run would, at an epoch's start (the
JAX trainer restarts at epoch 0 and re-clusters at once). SIGTERM stops the
epoch at the log cadence, and that save is the preemption checkpoint. The k-means
initial picks come from ``np.random.default_rng((seed, 10_000 + epoch,
head))``.

Data parallel across processes as the JAX trainer splits its step over the
``data`` mesh (torchrun or the ``AUDIOSSL_*`` environment,
parallel/launch.py): every process reads the global batch and takes its
contiguous share, holds its shard of the bank (``steps_per_epoch ·
batch / world`` slots, filled from its shares), clusters with the group
(``kmeans_on_mesh``'s collectives), and the step's gradients and loss are
the group's means. Rank 0 writes the checkpoints, with every shard of the
bank and of the augmentation state in one world-sized layout; a resume
takes the world size it was saved at.

``pretrain.tp``, ``run.fsdp`` and ``run.zero_optimizer`` raise
NotImplementedError (``train.loop.check_parallel_knobs``): the JAX trainer
has no such path.
"""
from __future__ import annotations

import contextlib
import copy
import logging
import os
import time
from typing import Any

import numpy as np
import torch

from audiossl_tpu_torch import config as cfgmod
from audiossl_tpu_torch import no_tf32, resolve_device
from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.frontend import build_frontend
from audiossl_tpu_torch.objectives import init_objective
from audiossl_tpu_torch.objectives.decar import IGNORE_INDEX, DecarV2, kmeans_on_mesh, memory_update
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.train import checkpoint as ckpt
from audiossl_tpu_torch.train.loop import (
    MetricsBuffer, aug_state_from_world, check_parallel_knobs, gather_generators, global_batch, join_group,
    kmix_centroids, stats_log, world_aug_state,
)
from audiossl_tpu_torch.train.optim import build_optimizer, warmup_cosine
from audiossl_tpu_torch.train.preemption import PreemptionGuard
from audiossl_tpu_torch.train.step import TrainStep

log = logging.getLogger("audiossl_tpu_torch.decar")


def waves_to_device(waves: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A loader batch on ``dev`` as f32 (PCM16 rescaled by 1/32768)."""
    w = torch.from_numpy(waves).to(dev)
    return w.float() / 32768.0 if w.dtype == torch.int16 else w


@torch.no_grad()
def fill_memory(objective: DecarV2, loader: ManifestLoader, frontend, mem_emb: torch.Tensor,
                mem_idx: torch.Tensor) -> None:
    """The bank from an eval-mode pass over epoch 0's batches, slot by slot
    in batch order, on the raw log-mel (no RunningNorm); across processes
    each fills its shard from its share of every batch."""
    objective.eval()
    pos = 0
    for waves, idxs in loader.epoch(0):
        waves, idxs = dist.share(waves), dist.share(idxs)
        emb, _ = objective.net(frontend(waves_to_device(waves, mem_emb.device))[:, None])
        mem_emb[pos:pos + len(idxs)] = emb
        mem_idx[pos:pos + len(idxs)] = torch.from_numpy(idxs).to(mem_idx.device)
        pos += len(idxs)
    objective.train()


def cluster(objective: DecarV2, mem_emb: torch.Tensor, mem_idx: torch.Tensor, n_total: int, seed: int,
            epoch: int) -> torch.Tensor:
    """k-means per prototype head over the bank, the centroids copied into
    the prototypes -> the assignments [heads, n_total]."""
    cents, assigns = [], []
    for h, k in enumerate(objective.nmb_prototypes):
        pick = np.random.default_rng((seed, 10_000 + epoch, h)).permutation(mem_emb.shape[0])[:k]
        c, a = kmeans_on_mesh(mem_emb, mem_idx, n_total, k, torch.from_numpy(pick), objective.kmeans_iters)
        cents.append(c)
        assigns.append(a)
    objective.set_prototypes(cents)
    gap = max(float((p.weight.detach() - c).abs().max()) for p, c in zip(objective.net.prototypes(), cents))
    assignments = torch.stack(assigns)
    n_assigned = int((assignments[0] != IGNORE_INDEX).sum())
    log.info("epoch %d: k-means over %d slots, %d/%d clips assigned; max|prototypes - centroids| = %g",
             epoch, mem_emb.shape[0], n_assigned, n_total, gap)
    return assignments


class DecarStep(TrainStep):
    """``step(aug_state, waves, idx) -> (aug_state', loss)`` of DECAR:
    views; view 1's pass (no gradient) and view 2's, CE against the
    epoch's ``assignments[:, idx]``; backward; the prototypes' gradients
    zeroed while ``step`` < freeze_prototypes_niters; LARC and its
    schedule; view 1's embeddings into the bank at ``epoch_step``'s slots.
    The trainer sets ``assignments`` at each clustering and keeps ``step``
    and ``epoch_step`` (which this advances) in its checkpoints."""

    def __init__(self, objective: DecarV2, pipeline, frontend, optimizer, generator, scheduler, normalization: str,
                 mem_emb: torch.Tensor, mem_idx: torch.Tensor, assignments: torch.Tensor):
        super().__init__(objective, pipeline, frontend, optimizer, generator, scheduler, normalization)
        self.mem_emb, self.mem_idx, self.assignments = mem_emb, mem_idx, assignments
        self.step = self.epoch_step = 0
        self._pending: tuple[torch.Tensor, torch.Tensor] | None = None

    def loss_and_grads(self, v1: torch.Tensor, v2: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        """``labels`` are the batch's dataset indices."""
        f32 = self.objective.compute_dtype == torch.float32
        with no_tf32() if f32 else contextlib.nullcontext():
            loss, emb = self.objective.step_loss(v1, v2, self.assignments[:, labels], self.generator)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        dist.all_reduce_grads_(self.objective.parameters())
        self._pending = (emb, labels)
        return dist.all_reduce_mean(loss.detach())

    def update(self) -> None:
        self.objective.freeze_prototype_grads(self.step)
        super().update()
        memory_update(self.mem_emb, self.mem_idx, *self._pending, self.epoch_step)
        self._pending = None
        self.step += 1
        self.epoch_step += 1


def train_decar(
    config: dict[str, Any],
    input_csv: str,
    load_checkpoint: str | None = None,
    max_steps: int | None = None,
    seed: int = 31,
    device: str | torch.device = "cuda",
):
    """DECAR-v2 pretraining on the manifest ``input_csv`` -> (objective,
    final step, checkpoint directory). ``config`` is not changed."""
    dev = resolve_device(device)
    world = join_group(config["run"], dev)
    check_parallel_knobs(config)
    config = copy.deepcopy(config)
    run, pre = config["run"], config["pretrain"]
    batch = global_batch(int(run["batch_size"]), world)  # every process reads it and takes its share
    frontend = build_frontend(pre["input"])
    loader = ManifestLoader(
        input_csv, batch_size=batch, clip_samples=cfgmod.clip_samples(config), sample_rate=frontend.sample_rate,
        num_workers=int(run.get("num_dataloader_workers", 8)), seed=seed,
        wire_dtype=str(run.get("wire_dtype", "int16")), on_error=str(run.get("data_on_error", "raise")),
    )
    n_total = loader.num_samples
    loader.labels = np.arange(n_total, dtype=np.int64)  # the label slot carries dataset indices
    steps_per_epoch = max(len(loader), 1)
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=n_total, centroids=kmix_centroids(pre))
    objective = init_objective("decar_v2", config, seed, dev).train()

    epochs = int(run.get("epochs", 1))
    base_lr, final_lr = float(run.get("learning_rate", 4.8)), float(run.get("final_lr", 0.0))
    sched = warmup_cosine(base_lr, epochs * steps_per_epoch, 10 * steps_per_epoch,
                          end_lr_factor=final_lr / max(base_lr, 1e-9))
    optimizer, scheduler = build_optimizer("larc", objective.parameters(), sched, momentum=0.9, weight_decay=1e-6,
                                           trust_coefficient=0.001, clip=False)
    generator = torch.Generator(device=dev).manual_seed(dist.rank_seed(seed))
    aug_state = pipeline.init_state(frontend.n_mels, frontend.num_frames(loader.clip_samples), dev)
    slots = steps_per_epoch * (batch // world)  # this process's shard of the bank
    mem_emb = torch.zeros((slots, objective.feat_dim), dtype=torch.float32, device=dev)
    mem_idx = torch.full((slots,), -1, dtype=torch.long, device=dev)
    assignments = torch.full((len(objective.nmb_prototypes), n_total), IGNORE_INDEX, dtype=torch.long, device=dev)
    step, epoch_step, position = 0, 0, None
    if load_checkpoint:
        saved = ckpt.load_checkpoint(load_checkpoint)
        objective.load_state_dict(saved["objective"])
        optimizer.load_state_dict(saved["optimizer"])
        scheduler.load_state_dict(saved["scheduler"])
        aug_state = aug_state_from_world(saved["augment"], dev)  # raises at another world size
        generator.set_state(saved["generator"][dist.rank()])
        mem_emb.copy_(saved["memory"]["emb"][dist.rank()])
        mem_idx.copy_(saved["memory"]["index"][dist.rank()])
        assignments.copy_(saved["assignments"])
        step, epoch_step, position = int(saved["step"]), int(saved["epoch_step"]), saved["loader"]
        log.info("resumed from %s at step %d", load_checkpoint, step)
    else:
        log.info("initializing the memory bank (%d slots)", mem_emb.shape[0])
        fill_memory(objective, loader, frontend, mem_emb, mem_idx)
    train_step = DecarStep(objective, pipeline, frontend, optimizer, generator, scheduler,
                           str(pre.get("normalization", "mean_var")), mem_emb, mem_idx, assignments)
    train_step.step, train_step.epoch_step = step, epoch_step

    ckpt_dir = run.get("save_path", "./runs/decar_v2") + "_chkp"
    if dist.rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
    keep_last = int(run.get("keep_checkpoints", 0)) or None

    def save() -> None:
        # collectives: every process's augmentation state, generator and bank shard
        augment, generators = world_aug_state(aug_state), gather_generators(generator)
        memory = {"emb": dist.all_gather(mem_emb[None]), "index": dist.all_gather(mem_idx[None])}
        if dist.rank() != 0:
            return
        state = {
            "objective": objective.state_dict(), "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(), "augment": augment,
            "generator": generators, "loader": loader.position, "step": train_step.step,
            "epoch_step": train_step.epoch_step, "memory": memory,
            "assignments": train_step.assignments, "config": config,
        }
        ckpt.save_checkpoint(ckpt_dir, train_step.step, state, objective.export_state_dict(), config, keep_last)

    start_epoch, start_batch, rng_state = 0, 0, None
    if position is not None:
        start_epoch, start_batch, rng_state = position["epoch"], position["batch"], position["rng"]
        if start_batch >= steps_per_epoch:
            start_epoch, start_batch, rng_state = start_epoch + 1, 0, None
    done = False
    with stats_log(os.path.join(ckpt_dir, "stats.jsonl")) as stats_file, PreemptionGuard() as guard:
        buf = MetricsBuffer(int(run.get("log_every", 10)), stats_file)
        for epoch in range(start_epoch, epochs):
            first = epoch == start_epoch
            if not (first and start_batch):  # a resumed run mid-epoch keeps that epoch's clustering
                train_step.assignments = cluster(objective, mem_emb, mem_idx, n_total, seed, epoch)
                train_step.epoch_step = 0
            t_end = time.time()
            for waves, idxs in loader.epoch(epoch, start_batch if first else 0, rng_state if first else None):
                waves, idxs = dist.share(waves), dist.share(idxs)
                data_time = time.time() - t_end
                aug_state, loss = train_step(aug_state, torch.from_numpy(waves).to(dev), torch.from_numpy(idxs).to(dev))
                batch_time = time.time() - t_end
                t_end = time.time()
                if buf.push(epoch, train_step.step, loss, batch_time, data_time):
                    log.info("epoch %d step %d loss %.4f", epoch, train_step.step, buf.last_loss)
                    if guard.should_stop():  # the epoch-end save below runs on break; the resume is exact
                        log.warning("SIGTERM: stopping at step %d for the preemption save", train_step.step)
                        done = True
                        break
                if max_steps and train_step.step >= max_steps:
                    done = True
                    break
            buf.flush()
            save()
            if done:
                break
    return objective, train_step.step, ckpt_dir
