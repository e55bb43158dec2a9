"""Supervised MAST fine-tuning: multi-label BCE on AudioSet-style data (port
of ``audiossl_tpu.train.finetune_mast``).

The reference's extras/mast_new story: the AudiosetDataset input pipeline
(waveform mixup -> Kaldi fbank -> SpecMask -> (x - mean) / (2 std) -> noise,
dataloader.py:98-212) feeding a supervised MViT classifier, lambda-weighted
multi-hot labels under mixup (dataloader.py:148-160), a LayerNorm + Linear
head (src/encoder/mast.py:93), BCEWithLogits (mvit/models/losses.py:38),
AdamW with per-layer LR decay, no-decay groups and gradient clipping
(train/layer_decay.py), and per-epoch mAP / AUC / d' (utilities/stats.py).

On the card the fbank runs the dense-rows kernel in Kaldi mode (one launch
a microbatch and an eval batch) and MViT's 24 blocks the rel-pos attention
kernels (per microbatch 24 forwards, 24 dq and 24 dk/dv; per eval batch 24
forwards). ``run.grad_accum_steps: A`` splits each batch into A microbatches
(train/accum.py), each drawing its own mixup partners, masks, noise and drop
path; the gradients are averaged in f32 before the one optimizer update.

Every stochastic input takes its draws as tensors (``StepDraws``): a step
samples them from the run's ``torch.Generator`` (mixup, mask, noise, then
drop path inside the forward), or takes them from its caller.

The checkpoint (``state/<step>.pt``) holds the model, the optimizer, the
generator, the loader's position and the step, so a resumed run takes the
same steps as one never stopped (the JAX trainer restarts the epoch from its
first batch and replays what it had done). ``encoder/<step>.pt`` is the MAST
trunk in the reference layout, which ``serve.export --checkpoint`` and
``train_downstream --checkpoint`` load as they load SS-MAST's. SIGTERM stops
the epoch at the log cadence; its save is the epoch-end one, without eval.

    python -m audiossl_tpu_torch.train.finetune_mast --train_json train.json \\
        --label_csv labels.csv [--eval_json eval.json] [-c configs/mast_ft.yaml] \\
        [--load_checkpoint DIR] [--max_steps N] [--epochs N] [--batch_size N] \\
        [--grad_accum_steps A] [--fsdp] [--save_path PATH] [--device cuda|cpu]

Data parallel across processes (torchrun or the ``AUDIOSSL_*`` environment,
parallel/launch.py), as JAX's ``shard_map`` step: each process reads its
rank-strided share of the datafile (``host_shard``) at ``batch_size //
world`` clips, draws from its own generator, and the step's gradients and
loss are the group's means (JAX finetune_mast.py:242-246). The eval loader
is sharded the same way and the scores come back to every process in the
datafile's order (JAX :269); the sharded order is padded by wrapping to a
multiple of the world size, so at world W the eval metrics count the first
(−N mod W) clips twice. Rank 0 writes the checkpoints and the stats.

Fully sharded (``--fsdp`` / ``run.fsdp``, parallel/fsdp.py; JAX
finetune_mast.py:204-236): the classifier's parameters, their gradients
and the AdamW moments hold this rank's piece of every leaf JAX's
``tree_shardings`` shards; each MViT block, and the classifier's other
weights, are gathered around each forward (training and eval), each
backward reduce-scatters its gradients as
the data axis's mean, the leaves that stay whole take the all-reduce, the
layer-decay groups act on the pieces, and the clip reads the global norm of
the whole gradient (train/layer_decay.py). Rank 0 writes the dense
checkpoint and export; a resume cuts them for this rank. Under ``remat``
each block's recompute gathers its weights again (parallel/fsdp.py).
``run.zero_optimizer`` is refused: JAX's fine-tune has no ZeRO path (it
ignores the flag), nor a tensor-parallel one.
"""
from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import no_tf32, resolve_device
from audiossl_tpu_torch.data.augment import mast_noise, sample_mast_noise
from audiossl_tpu_torch.data.multilabel import multilabel_loader
from audiossl_tpu_torch.frontend import FrontendSpec
from audiossl_tpu_torch.frontend.fbank import WaveMixDraws, batch_waveform_mixup, sample_wave_mixup
from audiossl_tpu_torch.models.convert import mvit_reference_layout, shard_state_dict
from audiossl_tpu_torch.models.mast import MASTEncoder
from audiossl_tpu_torch.objectives.api import flax_init_
from audiossl_tpu_torch.ops.masking import MaskDraws, sample_mask_draws, spec_mask
from audiossl_tpu_torch.ops.stats import precomputed_norm
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel.fsdp import shard_ as fsdp_shard_
from audiossl_tpu_torch.parallel.tp import map_optimizer_state
from audiossl_tpu_torch.train import checkpoint as ckpt
from audiossl_tpu_torch.train.accum import microbatched_value_and_grad, set_grads
from audiossl_tpu_torch.train.layer_decay import adamw_layer_decay
from audiossl_tpu_torch.train.loop import (MetricsBuffer, check_parallel_knobs, finish_saves, gather_generators,
                                           global_batch, join_group, stats_log)
from audiossl_tpu_torch.train.preemption import PreemptionGuard
from audiossl_tpu_torch.utils.metrics import auc_roc, d_prime, mean_average_precision

log = logging.getLogger("audiossl_tpu_torch.finetune_mast")

MVIT_DEPTH = {"tiny": 10, "small": 16, "base": 24}
FSDP_UNITS = ("", "mast.blocks.*")  # run.fsdp gathers each MViT block, and the rest of the classifier


class MASTClassifier(nn.Module):
    """MAST trunk + the reference's mlp_head: LayerNorm (eps 1e-5, f32) ->
    Linear in the pooled features' dtype (f32) (src/encoder/mast.py:93).
    ``compute_dtype=None`` is the exact f32 trunk."""

    def __init__(self, num_classes: int, input_fdim: int = 128, input_tdim: int = 1024, model_size: str = "base",
                 remat: bool = False, droppath_rate: float | None = None,
                 compute_dtype: torch.dtype | None = torch.bfloat16):
        super().__init__()
        self.mast = MASTEncoder(input_fdim, input_tdim, model_size, remat=remat, compute_dtype=compute_dtype,
                                droppath_rate=droppath_rate)
        self.head_norm = nn.LayerNorm(self.mast.embed_dim, eps=1e-5)
        self.head = nn.Linear(self.mast.embed_dim, num_classes)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.mast.cfg.compute_dtype or torch.float32

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                drop: list[torch.Tensor] | None = None) -> torch.Tensor:
        """[B, 1, F, T] -> [B, classes] logits. In training mode drop path
        takes ``drop`` (U(0, 1) [B] draws, two a block, in order) or draws
        from ``generator``."""
        z = self.mast(x, generator, draws=None if drop is None else iter(drop))
        z = F.layer_norm(z.float(), self.head_norm.normalized_shape, self.head_norm.weight, self.head_norm.bias,
                         self.head_norm.eps)
        with no_tf32():
            return F.linear(z, self.head.weight, self.head.bias)


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch BCEWithLogitsLoss(reduction='mean') over all elements, in the
    stable form max(l, 0) - l t + log1p(exp(-|l|))."""
    return torch.mean(logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs())))


def mixup_waves_and_labels(waves: torch.Tensor, targets: torch.Tensor,
                           draws: WaveMixDraws) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample-pairing mixup with the lambda-weighted label combination
    (dataloader.py:148-160): every wave mean-centred, and where the gate is
    on, wave and targets mixed with the partner's at lambda ~ Beta(10, 10)."""
    lam = draws.lam[:, None].to(targets.dtype)
    mixed_t = lam * targets + (1.0 - lam) * targets[draws.partner]
    return batch_waveform_mixup(waves, draws), torch.where(draws.gate[:, None], mixed_t, targets)


class InputDraws(NamedTuple):
    """SpecMask's spans (None without it) and MAST noise's scale [B], U(0, 1)
    field [B, 1, F, T] and time shift [B] (None without it)."""

    mask: MaskDraws | None
    noise: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None


class StepDraws(NamedTuple):
    """The random numbers of one microbatch: the waveform mixup's (None
    without it), the input's, and drop path's U(0, 1) [B] draws (None: drawn
    from the generator in the forward)."""

    wave: WaveMixDraws | None
    inp: InputDraws
    drop: list[torch.Tensor] | None = None


def frontend_spec(ft: dict[str, Any]) -> FrontendSpec:
    """The Kaldi fbank of ``finetune.input``, padded or cut to target_length."""
    inp = ft["input"]
    return FrontendSpec(kind="fbank", n_mels=int(inp.get("n_mels", 128)),
                        sample_rate=int(inp.get("sampling_rate", 16000)), target_length=int(inp["target_length"]))


def sample_input_draws(ft: dict[str, Any], b: int, generator: torch.Generator) -> InputDraws:
    """The input's draws for B clips (SpecMask, then MAST noise), each where on."""
    spec = frontend_spec(ft)
    f, t = spec.n_mels, spec.target_length
    fm, tm = int(ft.get("freqm", 0)), int(ft.get("timem", 0))
    mask = sample_mask_draws(b, f, t, fm, tm, generator) if fm or tm else None
    noise = sample_mast_noise(b, (1, f, t), generator) if bool(ft["input"].get("noise", False)) else None
    return InputDraws(mask, noise)


def sample_step_draws(ft: dict[str, Any], b: int, generator: torch.Generator) -> StepDraws:
    """One microbatch's mixup and input draws; drop path draws later, in the forward."""
    rate = float(ft["input"].get("mixup", 0.0) or 0.0)
    wave = sample_wave_mixup(b, rate, generator) if rate > 0.0 else None
    return StepDraws(wave, sample_input_draws(ft, b, generator))


def prepare_input(ft: dict[str, Any], waves: torch.Tensor, train: bool, draws: InputDraws | None = None,
                  frontend: FrontendSpec | None = None) -> torch.Tensor:
    """waves [B, L] -> normalized fbank views [B, 1, F, T] (the layout of
    the port's MASTEncoder), in JAX's order (dataloader.py:186-207): the
    fbank (the rows kernel on the card, the plain version on the CPU), padded
    or cut to target_length; SpecMask (training only); (x - mean) / (2
    std), after the mask, so masked bins sit at (0 - mean) / (2 std); MAST
    noise (training only)."""
    x = (frontend or frontend_spec(ft))(waves)[:, None]
    if train and draws is not None and draws.mask is not None:
        x = spec_mask(x, draws.mask)
    ns = ft["norm_stats"]
    x = precomputed_norm(x, float(ns["mean"]), 2.0 * float(ns["std"]))
    if train and draws is not None and draws.noise is not None:
        x = mast_noise(x, *draws.noise)
    return x


def to_float_waves(waves: torch.Tensor) -> torch.Tensor:
    """The loader's PCM16 wire format back to f32 (f32 passes through)."""
    return waves.float() / 32768.0 if waves.dtype == torch.int16 else waves


class FinetuneStep:
    """``step(waves, targets, draws=None) -> loss``: per microbatch mixup,
    input, forward with drop path, BCE, backward; then one layer-decay AdamW
    update. ``draws`` is a list of A ``StepDraws`` (default: sampled from
    ``generator``). An f32 model runs with TF32 off. ``layout`` (fsdp's
    ``Shards``) picks the gradients the step all-reduces, None every
    parameter's."""

    def __init__(self, model: MASTClassifier, optimizer: torch.optim.Optimizer, ft: dict[str, Any],
                 generator: torch.Generator, accum: int = 1, layout=None):
        self.model, self.optimizer, self.ft, self.generator = model, optimizer, ft, generator
        self.layout = layout
        self.frontend = frontend_spec(ft)
        self.accum = accum
        self.params = [p for p in model.parameters() if p.requires_grad]

    def precision(self):
        return no_tf32() if self.model.compute_dtype == torch.float32 else contextlib.nullcontext()

    def inputs(self, waves: torch.Tensor, targets: torch.Tensor, draws: StepDraws) -> tuple[torch.Tensor, torch.Tensor]:
        """One microbatch's mixup and input: (views [b, 1, F, T], targets)."""
        waves = to_float_waves(waves)
        if draws.wave is not None:
            waves, targets = mixup_waves_and_labels(waves, targets, draws.wave)
        return prepare_input(self.ft, waves, True, draws.inp, self.frontend), targets

    def forward_loss(self, x: torch.Tensor, targets: torch.Tensor, drop: list[torch.Tensor] | None) -> torch.Tensor:
        return bce_logits(self.model(x, self.generator, drop), targets)

    def loss_and_grads(self, waves: torch.Tensor, targets: torch.Tensor,
                       draws: list[StepDraws] | None = None) -> torch.Tensor:
        """The microbatch-averaged loss, its gradients left on the parameters."""

        def micro_loss(batch, j):
            w, t = batch
            d = draws[j] if draws is not None else sample_step_draws(self.ft, w.shape[0], self.generator)
            x, t = self.inputs(w, t, d)
            return self.forward_loss(x, t, d.drop)

        with self.precision():
            loss, grads = microbatched_value_and_grad(micro_loss, self.accum)(self.params, (waves, targets))
        set_grads(self.params, grads)
        # once, after the last microbatch; under fsdp the pieces' gradients came
        # reduce-scattered out of each backward, and only the whole leaves remain
        dist.all_reduce_grads_(self.params if self.layout is None else self.layout.grads_to_all_reduce(self.params))
        return dist.all_reduce_mean(loss)

    def __call__(self, waves: torch.Tensor, targets: torch.Tensor, draws: list[StepDraws] | None = None) -> torch.Tensor:
        loss = self.loss_and_grads(waves, targets, draws)
        self.optimizer.step()
        return loss

    @torch.no_grad()
    def scores(self, waves: torch.Tensor) -> torch.Tensor:
        """Eval-mode sigmoid scores [B, classes] (no mask, no noise)."""
        was = self.model.training
        self.model.eval()
        with self.precision():
            out = torch.sigmoid(self.model(prepare_input(self.ft, to_float_waves(waves), False, None, self.frontend)))
        self.model.train(was)
        return out


def build_classifier(ft: dict[str, Any], n_classes: int) -> MASTClassifier:
    """The classifier the ``finetune`` section describes, uninitialised;
    ``compute_dtype: f32`` gives the exact trunk, anything else bf16."""
    inp = ft["input"]
    return MASTClassifier(
        n_classes, int(inp.get("n_mels", 128)), int(inp["target_length"]), str(ft.get("model_size", "base")),
        remat=bool(ft.get("remat", False)),
        droppath_rate=float(ft["droppath_rate"]) if ft.get("droppath_rate") is not None else None,
        compute_dtype=None if ft.get("compute_dtype") == "f32" else torch.bfloat16,
    )


def init_classifier(ft: dict[str, Any], n_classes: int, seed: int, device: torch.device) -> MASTClassifier:
    """``build_classifier`` at flax's initialisation drawn from
    ``torch.Generator().manual_seed(seed)`` (built on the meta device, so no
    draw touches the global generator)."""
    with torch.device("meta"):
        model = build_classifier(ft, n_classes)
    model = model.to_empty(device="cpu")
    flax_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def eval_scores(step: FinetuneStep, loader, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """Sigmoid scores and targets over the eval loader (its short last batch
    as it is: each clip's score does not depend on the batch); across
    processes every rank-strided share, interleaved back into the padded
    global order and cut to the datafile's clips, so that the wrapped tail
    counts once, as JAX drops its padding's scores."""
    scores, targets = [], []
    for waves, t in loader.epoch(0):
        scores.append(step.scores(torch.from_numpy(waves).to(device)).float().cpu().numpy())
        targets.append(np.asarray(t))
    s, t = np.concatenate(scores), np.concatenate(targets)
    if dist.active():
        parts = dist.gather_objects((s, t))
        s = np.stack([p[0] for p in parts], 1).reshape(-1, s.shape[1])
        t = np.stack([p[1] for p in parts], 1).reshape(-1, t.shape[1])
        s, t = s[:loader.num_samples], t[:loader.num_samples]
    return s, t


def evaluate(step: FinetuneStep, loader, device: torch.device) -> dict[str, float]:
    """mAP, AUC and d' of ``eval_scores``."""
    s, t = eval_scores(step, loader, device)
    auc = auc_roc(s, t)
    return {"mAP": mean_average_precision(s, t), "AUC": auc, "d_prime": d_prime(auc)}


def train_finetune_mast(
    config: dict[str, Any],
    train_json: str,
    label_csv: str,
    eval_json: str | None = None,
    load_checkpoint: str | None = None,
    max_steps: int | None = None,
    seed: int = 31,
    device: str | torch.device = "cuda",
):
    """Fine-tune on ``train_json`` -> (model, last epoch's stats, checkpoint
    directory). ``config`` is not changed."""
    dev = resolve_device(device)
    check_parallel_knobs(config, fsdp_runs=True)
    fsdp = bool(config["run"].get("fsdp", False))
    world = join_group(config["run"], dev)
    config = copy.deepcopy(config)
    run, ft = config["run"], config["finetune"]
    batch = global_batch(int(run["batch_size"]), world) // world  # this process's share
    inp = ft["input"]
    sr = int(inp.get("sampling_rate", 16000))
    clip = int(float(inp.get("length_wave", 10.0)) * sr)
    workers = int(run.get("num_dataloader_workers", 8))
    shard = (dist.rank(), world) if world > 1 else None
    loader, n_classes = multilabel_loader(train_json, label_csv, batch, clip, sr, num_workers=workers, seed=seed,
                                          on_error=str(run.get("data_on_error", "raise")), host_shard=shard)
    eval_loader = None
    if eval_json:
        eval_loader, _ = multilabel_loader(eval_json, label_csv, batch, clip, sr, shuffle=False, drop_last=False,
                                           num_workers=workers, host_shard=shard)
    accum = max(1, int(run.get("grad_accum_steps", 1)))
    if batch % accum:
        raise ValueError(f"per-chip batch {batch} not divisible by grad_accum_steps {accum}")

    model = init_classifier(ft, n_classes, seed, dev).train()
    # the seeded dense weights cut before the optimizer sees them, gathered block by block
    shards = fsdp_shard_(model, FSDP_UNITS) if fsdp else None
    model_size = str(ft.get("model_size", "base"))
    optimizer = adamw_layer_decay(
        model.named_parameters(), float(run.get("learning_rate", 5e-4)), depth=MVIT_DEPTH[model_size],
        layer_decay=float(run.get("layer_decay", 0.75)), weight_decay=float(run.get("weight_decay", 0.05)),
        clip_grad_norm=float(run.get("clip_grad_norm", 1.0)), shards=shards,
    )
    name_of = {id(p): n for n, p in model.named_parameters()}
    names = [name_of[id(p)] for g in optimizer.param_groups for p in g["params"]]  # the optimizer's order
    generator = torch.Generator(device=dev).manual_seed(dist.rank_seed(seed))
    step, position = 0, None
    if load_checkpoint:
        saved = ckpt.load_checkpoint(load_checkpoint)
        if len(saved["generator"]) != world:
            raise ValueError(f"the checkpoint was written by {len(saved['generator'])} process(es), this run has "
                             f"{world}: resume at the world size it was saved at")
        model_sd, opt_sd = saved["model"], saved["optimizer"]
        if shards is not None:  # the dense checkpoint cut to this rank's pieces
            rank, n = dist.dp_rank(), dist.dp_world()
            model_sd = shard_state_dict(model_sd, shards.spec, rank, n)
            opt_sd = map_optimizer_state(opt_sd, names, lambda v, k: shard_state_dict({k: v}, shards.spec, rank, n)[k])
        model.load_state_dict(model_sd)
        optimizer.load_state_dict(opt_sd)
        generator.set_state(saved["generator"][dist.rank()])
        step, position = int(saved["step"]), saved["loader"]
        if position is not None:
            position = {**position, "rng": saved["loader_rngs"][dist.rank()]}
        log.info("resumed from %s at step %d", load_checkpoint, step)
    train_step = FinetuneStep(model, optimizer, ft, generator, accum, layout=shards)

    ckpt_dir = run.get("save_path", "./runs/mast_ft") + "_chkp"
    if dist.rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
    keep_last = int(run.get("keep_checkpoints", 0)) or None

    def save() -> None:
        generators = gather_generators(generator)  # collectives; under fsdp the dense state too
        loader_rngs = dist.gather_objects(None if loader.position is None else loader.position["rng"])
        model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
        if shards is not None:
            model_sd, opt_sd = shards.dense_state_dict(model_sd), shards.dense_optimizer_state(opt_sd, names)
        if dist.rank() != 0:
            return
        state = {"model": model_sd, "optimizer": opt_sd, "generator": generators,
                 "loader": loader.position, "loader_rngs": loader_rngs, "step": step, "config": config}
        export = mvit_reference_layout({k[len("mast."):]: v for k, v in model_sd.items() if k.startswith("mast.")})
        ckpt.save_checkpoint(ckpt_dir, step, state, export, config, keep_last)

    steps_per_epoch = max(len(loader), 1)
    start_epoch, start_batch, rng_state = 0, 0, None
    if position is not None:
        start_epoch, start_batch, rng_state = position["epoch"], position["batch"], position["rng"]
        if start_batch >= steps_per_epoch:
            start_epoch, start_batch, rng_state = start_epoch + 1, 0, None
    epochs = int(run.get("epochs", 1))
    stats: dict = {}
    done = preempted = False
    with stats_log(os.path.join(ckpt_dir, "stats.jsonl")) as stats_file, PreemptionGuard() as guard:
        buf = MetricsBuffer(int(run.get("log_every", 10)), stats_file)
        for epoch in range(start_epoch, epochs):
            first = epoch == start_epoch
            buf.reset_avg()
            t0 = t_end = time.time()
            for waves, targets in loader.epoch(epoch, start_batch if first else 0, rng_state if first else None):
                data_time = time.time() - t_end
                loss = train_step(torch.from_numpy(waves).to(dev), torch.from_numpy(targets).to(dev))
                step += 1
                batch_time = time.time() - t_end
                t_end = time.time()
                if buf.push(epoch, step, loss, batch_time, data_time):
                    log.info("epoch %d step %d loss %.4f", epoch, step, buf.last_loss)
                    if guard.should_stop():  # the epoch-end save below runs on break, without eval
                        log.warning("SIGTERM: stopping at step %d for the preemption save", step)
                        done = preempted = True
                        break
                if max_steps and step >= max_steps:
                    done = True
                    break
            buf.flush()
            stats = {"epoch": epoch, "train_loss": buf.avg_loss, "epoch_time_s": time.time() - t0}
            if eval_loader is not None and not preempted:
                stats.update(evaluate(train_step, eval_loader, dev))
            log.info("%s", stats)
            if stats_file is not None:
                print(json.dumps(stats), file=stats_file)
            save()
            if done:
                break
    finish_saves()
    return model, stats, ckpt_dir


def main(argv: list[str] | None = None):
    import argparse

    from audiossl_tpu_torch.config import load_config

    p = argparse.ArgumentParser(allow_abbrev=False, description="Supervised MAST multi-label fine-tuning")
    p.add_argument("--train_json", required=True, help="AudioSet-style datafile JSON")
    p.add_argument("--label_csv", required=True, help="CSV with index,mid,display_name")
    p.add_argument("--eval_json", default=None)
    p.add_argument("-c", "--config", default=None, help="YAML (defaults to configs/mast_ft.yaml)")
    p.add_argument("--load_checkpoint", default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--grad_accum_steps", type=int, default=None,
                   help="microbatches per optimizer update (memory lever)")
    p.add_argument("--fsdp", action="store_true",
                   help="fully shard params/grads/AdamW moments over the data axis (run.fsdp)")
    p.add_argument("--save_path", default=None, help="override config run.save_path")
    p.add_argument("--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    config = load_config(args.config, "mast_ft")
    for key in ("epochs", "batch_size", "grad_accum_steps", "save_path"):
        if getattr(args, key) is not None:
            config["run"][key] = getattr(args, key)
    if args.fsdp:
        config["run"]["fsdp"] = True
    _, stats, ckpt_dir = train_finetune_mast(
        config, args.train_json, args.label_csv, eval_json=args.eval_json,
        load_checkpoint=args.load_checkpoint, max_steps=args.max_steps, device=args.device,
    )
    print(f"checkpoints written to {ckpt_dir}; final stats: {stats}")
    return stats, ckpt_dir


if __name__ == "__main__":
    main()
