"""Downstream linear probe and fine-tune (port of
``audiossl_tpu.downstream.probe``; reference: train_downstream.py).

A frozen or fine-tuned encoder with a linear head on labelled clips: the
log-mel frontend at ``downstream.input.n_mels`` on clips of ``run.duration``
seconds (a LAPE task's own duration for a registry task), Adam at
``run.lr``, cross-entropy, test (and valid) accuracy after every epoch, and
one JSON line of stats per epoch in ``<exp_dir>/<task>/downstream_stats.txt``
as in JAX; the accuracy plot is best-effort, as in JAX.

Every encoder sees the librosa log-mel at ``downstream.input.n_mels``,
whatever ``downstream.input.type`` says, as in the JAX probe.

``--checkpoint`` hands a port pretraining run's encoder over: the newest
``encoder/<step>.pt`` under the checkpoint directory, in the reference
layout, is turned into the port's layout for the encoder type and
transplanted (``models.surgery.load_pretrained_encoder``): tensors of equal
shape copy. Where the shapes differ — a MAST or AST encoder pretrained at
another input shape, SS-MAST's 128 x 1024 fbank probed at 64 mels x 1 s —
the cross-shape surgery adapts the rel-pos tables and
the positional embedding from the upstream run's input shape, read from
its ``config.yaml`` as JAX reads it, and logs "cross-shape encoder
transplant". The probe never trains from weights that are partly random:
a load that leaves any tensor of the encoder unfilled (a checkpoint of
another width, or with fewer blocks) raises (JAX keeps such tensors at
random; ROADMAP.md Queue 3).
``freeze`` trains the head only, while the encoder stays in training mode,
so that its BatchNorm statistics still update as in the reference
(utils.py:223-227), and MAST still draws its drop path, as JAX does.

HF-hosted tasks (speech_commands) load through ``data/hf.py`` when no CSVs
are given. The CUDA kernels run on the card (log-mel, block 1 in training
mode, the attention kernels), their plain versions with ``device="cpu"``.

Data parallel across processes (torchrun or the ``AUDIOSSL_*`` environment,
parallel/launch.py), as JAX's single-host probe splits each batch over its
``data`` mesh: every process reads the same global batches and takes its
contiguous share (rows ``rank·B/W`` up to ``(rank+1)·B/W``), the BatchNorms
are SyncBN, and the step's gradients and loss are the group's means (JAX
probe.py:283-284); the eval accuracy counts every process's share. Rank 0
writes the stats.

Tensor parallel (``downstream.tp: M``, JAX probe.py:107-147,236-283; AST
only): the world is a (world // M) x M grid (parallel/dist.py), the batch
is split over its data axis only, the AST encoder is head-sharded over the
model axis (parallel/tp_ast.py: each rank runs H/M heads through the
attention kernels, a 1/M share of every qkv, attn.proj and MLP weight and
of their Adam moments) and the linear head is replicated. A checkpoint's
encoder loads whole and is sharded after. The loss and the gradients are
means over the data axis's global batch; eval runs on the same grid;
``--freeze`` keeps the frozen shards.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

import torch

from audiossl_tpu_torch import resolve_device
from audiossl_tpu_torch.config import encoder_section
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.downstream.model import DownstreamModel
from audiossl_tpu_torch.frontend import build_frontend, logmel_features
from audiossl_tpu_torch.frontend.stft import LogMelConfig
from audiossl_tpu_torch.models import surgery
from audiossl_tpu_torch.models.surgery import newest_encoder
from audiossl_tpu_torch.objectives.unfused import cross_entropy
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel.tp_ast import shard_ast_
from audiossl_tpu_torch.train.checkpoint import wait_until_finished
from audiossl_tpu_torch.train.loop import global_batch, join_group, stats_log
from audiossl_tpu_torch.utils.metrics import Accuracy, AverageMeter

log = logging.getLogger("audiossl_tpu_torch.downstream")

SEED = 0  # the head's and encoder's random initial weights


def build_loaders(config: dict[str, Any], args: dict[str, Any]):
    """(train, valid or None, test, clip samples): a LAPE registry task's
    loaders, or the CSVs of ``--train_csv`` / ``--test_csv`` / ``--valid_csv``
    (columns ``wav`` and ``label``)."""
    from audiossl_tpu_torch.downstream.tasks import build_task_loaders, get_task

    ds = config["downstream"]
    sr = int(ds["input"]["sampling_rate"])
    train_csv, test_csv, valid_csv = args.get("train_csv"), args.get("test_csv"), args.get("valid_csv")
    task_name = str(args.get("task", ""))
    batch = int(config["run"]["batch_size"])
    workers = int(config["run"].get("num_dataloader_workers", 8))
    balanced = bool(ds.get("balanced_sampling", False))
    if not train_csv:
        from audiossl_tpu_torch.data.hf import HFLoader, hf_available

        if hf_available(task_name):
            clip = int(float(config["run"].get("duration", 1)) * sr)
            train = HFLoader(task_name, "train", batch, clip, sr, shuffle=True, drop_last=True, seed=1,
                             balanced=balanced)
            test = HFLoader(task_name, "test", batch, clip, sr)
            try:  # speech_commands carries a validation split, evaluated every epoch
                valid = HFLoader(task_name, "validation", batch, clip, sr)
            except (ValueError, KeyError, FileNotFoundError) as e:
                log.warning("HF task %s: validation split unavailable, skipping per-epoch validation (%s: %s)",
                            task_name, type(e).__name__, e)
                valid = None
            return train, valid, test, clip
    task = get_task(task_name)
    if task is not None:
        return build_task_loaders(task, batch, sr, workers=workers, data_root=args.get("data_root"),
                                  train_csv=train_csv, test_csv=test_csv, valid_csv=valid_csv, balanced=balanced)
    if not (train_csv and test_csv):
        raise ValueError(f"task {task_name!r} is no LAPE registry task: pass --train_csv and --test_csv")
    clip = int(float(config["run"].get("duration", 1)) * sr)
    common = dict(labeled=True, file_col="wav", num_workers=workers)
    train = ManifestLoader(train_csv, batch, clip, sr, shuffle=True, seed=1, balanced=balanced, **common)
    test = ManifestLoader(test_csv, batch, clip, sr, shuffle=False, drop_last=False, labels_map=train.label_to_id,
                          **common)
    valid = None
    if valid_csv:
        valid = ManifestLoader(valid_csv, batch, clip, sr, shuffle=False, drop_last=False,
                               labels_map=train.label_to_id, **common)
    return train, valid, test, clip


def upstream_input_hw(ckpt_dir: str, n_mels: int) -> tuple[int, int] | None:
    """(frames, mels) of the upstream run's input, from its ``config.yaml``:
    ``target_length``, else the frontend's frame count for ``length_wave``;
    the mels default to the probe's ``n_mels`` (JAX's rule,
    audiossl_tpu/downstream/probe.py:166-183). None without a config."""
    path = os.path.join(ckpt_dir, "config.yaml")
    if not os.path.exists(path):
        return None
    import yaml

    with open(path) as f:
        inp = encoder_section(yaml.safe_load(f)).get("input") or {}  # a pretraining run, or a MAST fine-tune
    frames = int(inp.get("target_length") or 0)
    if not frames:
        fe = build_frontend(inp)
        frames = fe.num_frames(int(float(inp.get("length_wave", 0.95)) * fe.sample_rate))
    return frames, int(inp.get("n_mels", n_mels))


def load_encoder(model: DownstreamModel, ckpt_dir: str, input_hw: tuple[int, int]) -> str:
    """Load the checkpoint's newest encoder into ``model.encoder``, built for
    ``input_hw`` = (frames, mels), in the port's layout: equal shapes copy,
    and a MAST or AST pretrained at another input shape takes the
    cross-shape surgery. Raises unless every tensor of the encoder was
    copied or adapted. Returns the file it read."""
    wait_until_finished()  # a save of this process still in flight is on disk first
    enc_type = model.encoder_type
    src_hw = upstream_input_hw(ckpt_dir, input_hw[1]) or input_hw
    stats: dict = {}
    sd = surgery.load_pretrained_encoder(ckpt_dir, model.encoder.state_dict(), enc_type, src_hw, input_hw,
                                         prefix_tokens=2 if enc_type == "AST" else 0, stats=stats)
    path = newest_encoder(ckpt_dir)
    if stats["kept_fresh"] or stats["missing"]:
        raise ValueError(f"the encoder surgery from {path} left {stats['kept_fresh'] + stats['missing']} tensors of "
                         f"the probe's {enc_type} at random ({stats}): another model size or width?")
    model.encoder.load_state_dict(sd, strict=True)
    if stats["adapted"]:
        log.info("cross-shape encoder transplant (pos/rel-pos surgery) applied: %s -> %s, %s", src_hw, input_hw, stats)
    return path


def build_model(config: dict[str, Any], num_classes: int, n_frames: int) -> DownstreamModel:
    """The probe's DownstreamModel from the config, with seeded random weights."""
    ds = config["downstream"]
    enc = ds["base_encoder"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return DownstreamModel(
            n_mels=int(ds["input"]["n_mels"]), d=int(enc["output_dim"]), num_classes=num_classes,
            finetune_layer=int(ds.get("finetune_layer", -1)), encoder_type=str(enc.get("type", "AudioNTT2020Task6")),
            input_tdim=n_frames, model_size=str(enc.get("model_size", "base")),
            patch_drop=float(enc.get("patch_drop", 0.0)),
        )


def features(waves: torch.Tensor, mel_cfg: LogMelConfig) -> torch.Tensor:
    """[B, L] waves -> [B, 1, n_mels, T] log-mel (the kernel on the card)."""
    return logmel_features(waves, mel_cfg)[:, None]


def probe_step(model: DownstreamModel, optimizer: torch.optim.Optimizer, mel_cfg: LogMelConfig, waves: torch.Tensor,
               labels: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """One training step on device tensors (this process's share of the
    batch); returns the loss (on the device), the group's mean."""
    loss = cross_entropy(model(features(waves, mel_cfg), generator), labels)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    dist.all_reduce_grads_(model.parameters())
    optimizer.step()
    return dist.all_reduce_mean(loss.detach())


@torch.no_grad()
def evaluate(model: DownstreamModel, loader, mel_cfg: LogMelConfig, dev: torch.device) -> float:
    """Accuracy over one pass of ``loader`` in eval mode (every clip once,
    across processes each in one process's share)."""
    model.eval()
    acc = Accuracy()
    for waves, labels in loader.epoch(0):
        waves, labels = dist.share(waves), dist.share(labels)
        if len(labels):
            logits = model(features(torch.from_numpy(waves).to(dev), mel_cfg))
            acc.update(logits.argmax(dim=1).cpu().numpy() == labels)
    model.train()
    if not dist.data_active():
        return acc.avg
    hits = dist.all_reduce_sum(torch.tensor([acc.correct, acc.total], dtype=torch.float64, device=dev))
    return float(hits[0] / hits[1].clamp_min(1.0))


def run_downstream(config: dict[str, Any], args: dict[str, Any], device: str | torch.device = "cuda") -> dict[str, Any]:
    """Train and evaluate the probe; returns the best test accuracy, the
    per-epoch test accuracies, the per-step losses and the model."""
    ds = config["downstream"]
    tp = max(1, int(ds.get("tp", 0) or 0))
    if tp > 1 and str(ds["base_encoder"].get("type")) != "AST":
        raise ValueError("downstream.tp requires base_encoder.type: AST (head-sharded plain-ViT attention, "
                         f"parallel/tp_ast.py); got {ds['base_encoder'].get('type')!r}")
    dev = resolve_device(device)
    n_data = join_group(config["run"], dev, tp, "downstream.tp") // tp
    if n_data > 1:  # the global batch, a multiple of the data axis's size
        batch = global_batch(int(config["run"]["batch_size"]), n_data)
        config = {**config, "run": {**config["run"], "batch_size": batch}}
    train_loader, valid_loader, test_loader, clip = build_loaders(config, args)
    num_classes = len(train_loader.label_to_id)
    mel_cfg = LogMelConfig(sample_rate=int(ds["input"]["sampling_rate"]), n_mels=int(ds["input"]["n_mels"]))
    model = build_model(config, num_classes, mel_cfg.num_frames(clip))
    if args.get("checkpoint"):
        path = load_encoder(model, args["checkpoint"], (mel_cfg.num_frames(clip), mel_cfg.n_mels))
        log.info("loaded pretrained encoder from %s", path)
    if tp > 1:
        shard_ast_(model.encoder)
    model = model.to(dev).train()

    freeze = bool(args.get("freeze") or config["run"].get("freeze", False))
    if freeze:
        model.encoder.requires_grad_(False)
    optimizer = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=float(config["run"].get("lr", 1e-3)))
    generator = torch.Generator(dev).manual_seed(dist.rank_seed(7))

    exp_root = os.path.join(str(args.get("exp_dir", "./exp")), str(args.get("task", "task")))
    if dist.rank() == 0:
        os.makedirs(exp_root, exist_ok=True)
    epochs = int(config["run"].get("epochs", 100))
    test_acc_hist, step_losses = [], []
    with stats_log(os.path.join(exp_root, "downstream_stats.txt")) as stats_file:
        for epoch in range(epochs):
            t0 = time.time()
            losses = AverageMeter()
            for waves, labels in train_loader.epoch(epoch):
                waves, labels = dist.share(waves), dist.share(labels)
                loss = probe_step(model, optimizer, mel_cfg, torch.from_numpy(waves).to(dev),
                                  torch.from_numpy(labels).to(dev), generator)
                step_losses.append(float(loss))
                losses.update(step_losses[-1], len(labels))
            test_acc = evaluate(model, test_loader, mel_cfg, dev)
            test_acc_hist.append(test_acc)
            stats = {"epoch": epoch, "Train_loss": losses.avg, "Test_Accuracy": test_acc,
                     "Best_Test_Acc": max(test_acc_hist), "epoch_time_s": time.time() - t0}
            if valid_loader is not None:
                stats["Valid_Accuracy"] = evaluate(model, valid_loader, mel_cfg, dev)
            log.info("%s", stats)
            if stats_file is not None:
                print(json.dumps(stats), file=stats_file)
    if dist.rank() != 0:
        return {"best_test_acc": max(test_acc_hist), "history": test_acc_hist, "losses": step_losses, "model": model,
                "num_classes": num_classes}
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(range(1, len(test_acc_hist) + 1), test_acc_hist, label="test accuracy", marker="x")
        plt.legend()
        plt.savefig(os.path.join(exp_root, "accuracy.png"))
        plt.close()
    except Exception:  # plotting is best-effort, as in JAX
        pass
    return {"best_test_acc": max(test_acc_hist), "history": test_acc_hist, "losses": step_losses, "model": model,
            "num_classes": num_classes}
