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

Data parallel across processes (one per card, started by torchrun or the
``AUDIOSSL_*`` environment, parallel/launch.py): the loop joins the group
the launcher describes (NCCL on the card, gloo on the CPU), reads the
manifest's rank-strided share (``host_shard=(rank, world)``) at
``batch_size // world`` clips a step (a batch the world does not divide is
rounded down to a multiple of it, as in JAX), and each step's gradients and
loss are the group's means (train/step.py). Rank 0 writes the checkpoints,
the stats and the exports; the checkpoint's augmentation state holds every
process's mixup bank and RunningNorm in one world-sized layout (leading dim
``world``, JAX's ``P(DATA_AXIS)`` aug state), and a resume at another world
size raises, as JAX's restore does. ``run.world_size`` (0: the group's size)
must equal the group's size.

Which trainer runs which parallelism knob (``check_parallel_knobs``): this
one runs ``pretrain.tp`` (SS-MAST), ``run.fsdp`` (SS-MAST) and
``run.zero_optimizer`` (any objective, elementwise optimizers); the
fine-tune runs ``run.fsdp``; DECAR and DeepCluster run none, and the
fine-tune no ``pretrain.tp`` or ``run.zero_optimizer``: the JAX trainers
have no such path (where JAX ignores a knob, the port refuses it).

Tensor parallel (``pretrain.tp: M``, JAX's ``model`` mesh axis, SS-MAST on
MAST only): the world is a (world // M) x M grid (parallel/dist.py); the
query tower, the EMA key tower and the AdamW moments hold 1/M of every
qkv, attn.proj and MLP weight on each rank of a model group
(parallel/tp_mvit.py). The config is left as given: JAX's loop writes
``fused_attention: off`` and ``pool_impl: unrolled`` into it (into the
caller's dict) for its partitioner, and the port acts on neither key. The
batch is split over the
data axis only: each model group reads one ``host_shard`` of
``batch_size // (world // M)`` clips and its ranks draw alike (the
generator's seed and the loader's come from the data index); gradients are
averaged over the data axis. JAX's checks stay (MAST only; not with
``zero_optimizer`` or ``fsdp``; the world divisible by M; stateless
augmentation). Rank 0 writes the dense checkpoint (parameters, key tower,
moments and queue gathered over the model axis, as orbax writes JAX's
global arrays): a run resumes at the same tp, and its encoder export loads
at tp = 1.

Fully sharded (``run.fsdp``, parallel/fsdp.py): the query tower, the EMA
key tower, the MoCo queue, the gradients and the AdamW moments hold this
rank's piece of every leaf JAX's ``tree_shardings`` shards; each MViT
block (and each tower's other weights) gathers its weights around its
forward, and its backward reduce-scatters the gradients, so the step
all-reduces only the leaves that stay whole.
JAX's checks stay (not with ``pretrain.tp`` or ``zero_optimizer``;
stateless augmentation, its ValueError naming ``run.fsdp``); ``remat`` is
refused (the gathered weights go after the forward), and so is an objective
that names no gathering units (only SS-MAST does; no config of the others
is stateless). The config is left as given (JAX writes ``fused_attention:
off`` into it; the port's attention kernels stay on). Rank 0 writes the
dense checkpoint and export; a resume cuts the dense state for this rank,
and the export loads at world 1.

ZeRO (``run.zero_optimizer``, train/zero.py): the parameters stay whole;
the optimizer holds this rank's flat slice of every parameter, the step
reduce-scatters the gradients in place of the all-reduce and all-gathers
the updated slices. SGD, Adam and AdamW only (JAX's
``assert_zero_compatible``). The checkpoint holds the moments as [world,
k] rows, and a resume at another world raises.
"""
from __future__ import annotations

import contextlib
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
from audiossl_tpu_torch.models.convert import shard_state_dict
from audiossl_tpu_torch.objectives import init_objective, objective_class
from audiossl_tpu_torch.ops.stats import RunningNormState
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel import tp as tpar
from audiossl_tpu_torch.parallel.launch import maybe_init_distributed
from audiossl_tpu_torch.parallel.tp_mvit import mvit_spec, shard_mvit_
from audiossl_tpu_torch.train import checkpoint as ckpt
from audiossl_tpu_torch.train.optim import build_optimizer, warmup_cosine
from audiossl_tpu_torch.train.preemption import PreemptionGuard
from audiossl_tpu_torch.train.step import TrainStep
from audiossl_tpu_torch.train.zero import assert_zero_compatible, build_zero_optimizer

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
            if self.stats_file is not None:  # None off rank 0
                print(json.dumps({"epoch": epoch, "step": step, "train_loss": loss, "batch_time": bt,
                                  "data_time": dt, **extra}), file=self.stats_file)
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


def check_parallel_knobs(config: dict[str, Any], tp_runs: bool = False, fsdp_runs: bool = False,
                         zero_runs: bool = False) -> int:
    """The JAX trainer's checks of ``pretrain.tp``, ``run.fsdp`` and
    ``run.zero_optimizer`` (audiossl_tpu/train/loop.py:117-160, 216-220):
    first its ValueErrors (tp needs a MAST encoder; tp + zero, fsdp + tp and
    fsdp + zero exclude each other), then NotImplementedError for a knob
    the calling trainer does not run (``tp_runs``, ``fsdp_runs``,
    ``zero_runs``): train_upstream runs all three, the fine-tune fsdp;
    the JAX DECAR and DeepCluster trainers have none of these paths, and the
    JAX fine-tune no tp or ZeRO one (it ignores ``run.zero_optimizer``). A
    config with no ``pretrain`` section (the fine-tune's) has no tp.
    Returns tp (1 when unset)."""
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
    if tp > 1 and not tp_runs:
        raise NotImplementedError("pretrain.tp > 1 is run by train_upstream (SS-MAST) only: this trainer has no "
                                  "tensor-parallel path, in the JAX package either")
    if fsdp and not fsdp_runs:
        raise NotImplementedError("run.fsdp is run by train_upstream (SS-MAST) and the MAST fine-tune only: this "
                                  "trainer has no fully sharded path, in the JAX package either")
    if zero and not zero_runs:
        raise NotImplementedError("run.zero_optimizer is run by train_upstream only: this trainer has no ZeRO path "
                                  "in the JAX package (JAX's fine-tune, DECAR and DeepCluster trainers ignore the "
                                  "flag; the port refuses it)")
    return max(tp, 1)


def check_fsdp(pre: dict[str, Any], objective_cls) -> None:
    """``run.fsdp``'s own checks, before any data is read: JAX's stateless
    augmentation (loop.py:244-256, naming the knob), then the port's
    refusals of ``remat`` and of an objective with no gathering units."""
    cfg = AugmentConfig.from_dict(pre)
    if cfg.normalization == "mean_var" or cfg.mixup_ratio is not None or cfg.kmix_ratio is not None:
        raise ValueError("run.fsdp requires stateless augmentation (normalization: precomputed/l2 and no "
                         "mixup/Kmix memory bank): the ring-bank and RunningNorm state are shaped for the "
                         "shard_map step")
    refuse_fsdp_remat(pre)
    if not getattr(objective_cls, "fsdp_units", None):
        raise NotImplementedError(f"run.fsdp is ported for SS-MAST: {objective_cls.__name__} names no gathering "
                                  "units (ROADMAP.md Queue 1)")


def refuse_fsdp_remat(section: dict[str, Any]) -> None:
    """``remat`` under ``run.fsdp`` raises: the gathered weights go after a
    unit's forward, and a rematerialised block would need them again."""
    if bool(section.get("remat", False)):
        raise NotImplementedError("run.fsdp with remat: the gathered weights are released after the forward, and a "
                                  "rematerialised block would need them again")


def shard_objective_(objective) -> "fsdp.Shards":
    """The objective's parameters and its ``fsdp_buffers`` cut to this
    rank's pieces, gathered around each forward of its ``fsdp_units``; the
    layout is kept as the objective's ``fsdp_shards``."""
    from audiossl_tpu_torch.parallel import fsdp

    objective.fsdp_shards = fsdp.shard_(objective, objective.fsdp_units, objective.fsdp_buffers)
    return objective.fsdp_shards


def check_world_size(run: dict[str, Any]) -> int:
    """``run.world_size`` against the process group: 0 (or absent) means the
    group's size, 1 with no group (JAX: every visible device); any other
    value must equal it. Returns the world size."""
    want, have = int(run.get("world_size", 0) or 0), dist.world()
    if want and want != have:
        raise ValueError(f"run.world_size is {want} but the process group has {have} process(es); start {want} "
                         "processes (torchrun --nproc_per_node, or the AUDIOSSL_* environment) or set "
                         "run.world_size: 0")
    return have


def join_group(run: dict[str, Any], device: torch.device, tp: int = 1, knob: str = "pretrain.tp") -> int:
    """Join the process group a launcher describes (parallel/launch.py),
    check ``run.world_size`` and lay the group out as a (world // tp) x tp
    grid (JAX's ValueError, naming ``knob``, when tp does not divide it);
    the world size."""
    maybe_init_distributed(device)
    world = check_world_size(run)
    if world % tp:
        raise ValueError(f"{world} devices not divisible by {knob}={tp}")
    dist.set_tp(tp)
    return world


def global_batch(batch: int, world: int) -> int:
    """``batch`` rounded down to a multiple of the world size (at least one
    clip a process), with JAX's warning (loop.py:163-166)."""
    if batch % world:
        batch = world * max(1, batch // world)
        log.warning("batch_size adjusted to %d to divide %d processes", batch, world)
    return batch


def aug_state_dict(state: AugmentState) -> dict[str, Any]:
    out: dict[str, Any] = {}
    if state.mixup is not None:
        out["mixup"] = {"bank": state.mixup.bank, "fill": state.mixup.fill, "ptr": state.mixup.ptr}
    if state.running_norm is not None:
        rn = state.running_norm
        out["running_norm"] = {"n": rn.n, "mean": rn.mean, "var": rn.var, "max_update": rn.max_update}
    return out


def world_aug_state(state: AugmentState) -> dict[str, Any]:
    """Every data index's augmentation state in one world-sized layout (a
    collective: each tensor stacked in rank order along a new leading dim,
    each count a [world] int64 tensor; JAX's ``P(DATA_AXIS)`` aug state)."""
    dev = state.mixup.bank.device if state.mixup is not None else \
        state.running_norm.mean.device if state.running_norm is not None else torch.device("cpu")
    out: dict[str, Any] = {"world": dist.dp_world()}
    for name, fields in aug_state_dict(state).items():
        out[name] = {k: dist.all_gather(torch.as_tensor(v, device=dev)[None]) for k, v in fields.items()}
    return out


def aug_state_from_world(d: dict[str, Any], device: torch.device) -> AugmentState:
    """This process's row of a world-sized augmentation state; raises for a
    checkpoint of another world size, as JAX's restore of a ``P(DATA_AXIS)``
    array of another length does."""
    world, r = int(d["world"]), dist.dp_rank()
    if world != dist.dp_world():
        raise ValueError(f"the checkpoint holds the augmentation state of {world} process(es), this run has "
                         f"{dist.dp_world()}: resume at the world size it was saved at (JAX's restore refuses too)")
    return aug_state_from_dict({name: {k: v[r] for k, v in fields.items()}
                                for name, fields in d.items() if name != "world"}, device)


def aug_state_from_dict(d: dict[str, Any], device: torch.device) -> AugmentState:
    mix = d.get("mixup")
    rn = d.get("running_norm")
    return AugmentState(
        mixup=MixupBankState(mix["bank"].to(device), int(mix["fill"]), int(mix["ptr"])) if mix else None,
        running_norm=RunningNormState(int(rn["n"]), rn["mean"].to(device), rn["var"].to(device), int(rn["max_update"]))
        if rn else None,
    )


def gather_generators(generator: torch.Generator) -> list[torch.Tensor]:
    """Every data index's generator state in order (a collective), each a
    tensor of its own: ``Generator.set_state`` reads a view's storage from
    its start, so a row of the gathered tensor would give rank 1 rank 0's
    bytes and more."""
    st = generator.get_state()
    return [s.clone() for s in dist.all_gather(st[None].to(generator.device)).cpu()] if dist.data_active() else [st]


def stats_log(path: str):
    """``path`` opened for appending on rank 0; elsewhere a context that
    yields None (the metrics are the group's, written once)."""
    if dist.rank() != 0:
        return contextlib.nullcontext(None)
    return open(path, "a", buffering=1)


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
    dev = resolve_device(device)
    tp = check_parallel_knobs(config, tp_runs=True, fsdp_runs=True, zero_runs=True)
    run, pre = config["run"], config["pretrain"]
    fsdp, zero = bool(run.get("fsdp", False)), bool(run.get("zero_optimizer", False))
    opt_name = str(run.get("optimizer", "sgd"))
    if fsdp:
        check_fsdp(pre, objective_class(upstream))
    if zero:
        assert_zero_compatible(opt_name)
    world = join_group(config["run"], dev, tp)
    config = copy.deepcopy(config)
    run, pre = config["run"], config["pretrain"]
    n_data = world // tp  # the batch is split over the data axis only
    batch = global_batch(int(run["batch_size"]), n_data)
    frontend = build_frontend(pre["input"])
    clip = cfgmod.clip_samples(config)
    loader = ManifestLoader(
        input_csv, batch_size=batch // n_data, clip_samples=clip, sample_rate=frontend.sample_rate,
        labeled=objective_class(upstream).labeled, num_workers=int(run.get("num_dataloader_workers", 8)), seed=seed,
        wire_dtype=str(run.get("wire_dtype", "int16")), on_error=str(run.get("data_on_error", "raise")),
        host_shard=(dist.dp_rank(), n_data) if n_data > 1 else None,
    )
    normalization = str(pre.get("normalization", "mean_var"))
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=loader.num_samples,
                               centroids=kmix_centroids(pre))
    steps_per_epoch = max(len(loader), 1)
    pre["steps_per_epoch"] = steps_per_epoch  # SS-MAST's momentum schedule reads it
    objective = init_objective(upstream, config, seed, dev).train()
    shards = None
    if tp > 1:  # the seeded dense weights, cut to this rank's shards before the optimizer sees them
        shard_mvit_(objective)
    elif fsdp:  # the same, over the data axis
        shards = shard_objective_(objective)

    epochs = int(run.get("epochs", 1))
    lr = float(run.get("learning_rate", 0.03))
    if run.get("lr_schedule") == "warmup_cosine":
        lr = warmup_cosine(lr, epochs * steps_per_epoch, 10 * steps_per_epoch)
    trained = [p for p in objective.parameters() if p.requires_grad]
    optimizer, scheduler = (build_zero_optimizer if zero else build_optimizer)(
        opt_name, trained, lr, **(run.get("optimizer_args") or {}))
    generator = torch.Generator(device=dev).manual_seed(dist.rank_seed(seed))
    aug_state = pipeline.init_state(frontend.n_mels, frontend.num_frames(clip), dev)
    if tp > 1 and (aug_state.mixup is not None or aug_state.running_norm is not None):
        raise ValueError("pretrain.tp requires stateless augmentation (normalization: precomputed/l2 and no "
                         "mixup/Kmix memory bank): the ring-bank and RunningNorm state are shaped for the "
                         "shard_map step")
    names = [n for n, p in objective.named_parameters() if p.requires_grad]  # the optimizer's order
    step, position = 0, None
    if load_checkpoint:
        saved = ckpt.load_checkpoint(load_checkpoint)
        obj_sd, opt_sd = saved["objective"], saved["optimizer"]
        if tp > 1 or shards is not None:  # the dense checkpoint cut to this rank's shards (fsdp: pieces)
            spec, rank, n = (mvit_spec, dist.tp_rank(), tp) if tp > 1 else (shards.spec, dist.dp_rank(),
                                                                            dist.dp_world())
            obj_sd = shard_state_dict(obj_sd, spec, rank, n)
            opt_sd = tpar.map_optimizer_state(opt_sd, names, lambda v, k: shard_state_dict({k: v}, spec, rank, n)[k])
        objective.load_state_dict(obj_sd)
        optimizer.load_state_dict(opt_sd)
        if scheduler is not None:
            scheduler.load_state_dict(saved["scheduler"])
        aug_state = aug_state_from_world(saved["augment"], dev)
        generator.set_state(saved["generator"][dist.dp_rank()])
        step, position = int(saved["step"]), saved["loader"]
        if position is not None:
            position = {**position, "rng": saved["loader_rngs"][dist.dp_rank()]}
        log.info("resumed from %s at step %d", load_checkpoint, step)
    train_step = TrainStep(objective, pipeline, frontend, optimizer, generator, scheduler, normalization,
                           layout=shards or (optimizer if zero else None))

    save_path = run.get("save_path", "./runs/" + upstream)
    ckpt_dir = save_path + "_chkp"
    if dist.rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
    keep_last = int(run.get("keep_checkpoints", 0)) or None

    def save() -> None:
        # collectives: every process's augmentation, generator and window-rng
        # state; under tp the dense state from every rank's shards, under
        # fsdp from every rank's pieces; under ZeRO the moments' rows
        augment, generators = world_aug_state(aug_state), gather_generators(generator)
        loader_rngs = dist.gather_objects(None if loader.position is None else loader.position["rng"])
        obj_sd, opt_sd = objective.state_dict(), optimizer.state_dict()
        if tp > 1:
            obj_sd, export = tpar.dense_state_dict(obj_sd, mvit_spec), tpar.dense_state_dict(
                objective.export_state_dict(), mvit_spec)
            opt_sd = tpar.map_optimizer_state(opt_sd, names, lambda v, n: tpar.gather_from_ranks(v, mvit_spec(n)))
        elif shards is not None:
            obj_sd, opt_sd = shards.dense_state_dict(obj_sd), shards.dense_optimizer_state(opt_sd, names)
            export = objective.export_state_dict(obj_sd)
        else:
            export = objective.export_state_dict()
        if dist.rank() == 0:
            state = {
                "objective": obj_sd,
                "optimizer": opt_sd,
                "scheduler": scheduler.state_dict() if scheduler is not None else None,
                "augment": augment,
                "generator": generators,
                "loader": loader.position,
                "loader_rngs": loader_rngs,
                "step": step,
                "config": config,
            }
            ckpt.save_checkpoint(ckpt_dir, step, state, export, config, keep_last)
        dist.barrier()  # every rank returns with the checkpoint on disk (a resume may follow in the same processes)

    start_epoch, start_batch, rng_state = 0, 0, None
    if position is not None:
        start_epoch, start_batch, rng_state = position["epoch"], position["batch"], position["rng"]
        if start_batch >= steps_per_epoch:
            start_epoch, start_batch, rng_state = start_epoch + 1, 0, None
    best_loss = float("inf")
    done = preempted = False
    with stats_log(os.path.join(ckpt_dir, "stats.jsonl")) as stats_file, PreemptionGuard() as guard:
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
