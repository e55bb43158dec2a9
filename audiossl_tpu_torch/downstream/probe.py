"""Downstream linear probe and fine-tune (port of
``audiossl_tpu.downstream.probe``; reference: train_downstream.py).

A frozen or fine-tuned encoder with a linear head on labelled clips: the
log-mel frontend at ``downstream.input.n_mels`` on clips of ``run.duration``
seconds (a LAPE task's own duration for a registry task), Adam at
``run.lr``, cross-entropy, test (and valid) accuracy after every epoch, and
one JSON line of stats per epoch in ``<exp_dir>/<task>/downstream_stats.txt``
as in JAX; the accuracy plot is best-effort, as in JAX.

``--checkpoint`` hands a port pretraining run's encoder over: the newest
``encoder/<step>.pt`` under the checkpoint directory loads into the encoder
strictly. A shape mismatch (an encoder pretrained at another input length)
raises: the cross-shape surgery is not ported (ROADMAP.md Queue 1, item 8),
and the probe never falls back to random weights. ``freeze`` trains the
head only, while the encoder stays in training mode, so that its BatchNorm
statistics still update as in the reference (utils.py:223-227).

One process on one device: the CUDA kernels on the card (log-mel, block 1
in training mode, the attention kernels), their plain versions with
``device="cpu"``. Not ported: HF-hosted tasks (``data/hf.py``) and
``downstream.tp``.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

import torch

from audiossl_tpu_torch import resolve_device
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.downstream.model import DownstreamModel
from audiossl_tpu_torch.frontend import logmel_features
from audiossl_tpu_torch.frontend.stft import LogMelConfig
from audiossl_tpu_torch.objectives.unfused import cross_entropy
from audiossl_tpu_torch.utils.metrics import Accuracy, AverageMeter

log = logging.getLogger("audiossl_tpu_torch.downstream")

# the tasks the JAX package reads from HF datasets when no CSVs are given (data/hf.py)
HF_TASKS = ("speech_commands_v1", "speech_commands_v2", "speech_commands_v235")
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
    if not train_csv and task_name in HF_TASKS:
        raise NotImplementedError(f"HF-hosted task {task_name!r} is not ported yet (data/hf.py, ROADMAP.md Queue 1, "
                                  "item 1); pass --train_csv and --test_csv")
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


def newest_encoder(ckpt_dir: str) -> str:
    """The path of the newest ``encoder/<step>.pt`` of a checkpoint directory."""
    enc_dir = os.path.join(ckpt_dir, "encoder")
    steps = sorted(int(n[:-3]) for n in os.listdir(enc_dir) if n.endswith(".pt") and n[:-3].isdigit()) \
        if os.path.isdir(enc_dir) else []
    if not steps:
        raise FileNotFoundError(f"no encoder/<step>.pt under {ckpt_dir}")
    return os.path.join(enc_dir, f"{steps[-1]}.pt")


def load_encoder(model: DownstreamModel, ckpt_dir: str) -> str:
    """Load the checkpoint's newest encoder into ``model.encoder`` strictly;
    returns the file it read."""
    path = newest_encoder(ckpt_dir)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    try:
        model.encoder.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise ValueError(
            f"the encoder in {path} does not match the probe's {model.encoder_type} (another input shape or "
            "width?); the cross-shape surgery, models/surgery.py, is not ported yet (ROADMAP.md Queue 1, item 8)"
        ) from e
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
    """One training step on device tensors; returns the loss (on the device)."""
    loss = cross_entropy(model(features(waves, mel_cfg), generator), labels)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def evaluate(model: DownstreamModel, loader, mel_cfg: LogMelConfig, dev: torch.device) -> float:
    """Accuracy over one pass of ``loader`` in eval mode (every clip once)."""
    model.eval()
    acc = Accuracy()
    for waves, labels in loader.epoch(0):
        logits = model(features(torch.from_numpy(waves).to(dev), mel_cfg))
        acc.update(logits.argmax(dim=1).cpu().numpy() == labels)
    model.train()
    return acc.avg


def run_downstream(config: dict[str, Any], args: dict[str, Any], device: str | torch.device = "cuda") -> dict[str, Any]:
    """Train and evaluate the probe; returns the best test accuracy, the
    per-epoch test accuracies, the per-step losses and the model."""
    if int(config["downstream"].get("tp", 0) or 0) > 1:
        raise NotImplementedError("downstream.tp is not ported yet (ROADMAP.md Queue 1, item 9)")
    dev = resolve_device(device)
    train_loader, valid_loader, test_loader, clip = build_loaders(config, args)
    num_classes = len(train_loader.label_to_id)
    ds = config["downstream"]
    mel_cfg = LogMelConfig(sample_rate=int(ds["input"]["sampling_rate"]), n_mels=int(ds["input"]["n_mels"]))
    model = build_model(config, num_classes, mel_cfg.num_frames(clip))
    if args.get("checkpoint"):
        log.info("loaded pretrained encoder from %s", load_encoder(model, args["checkpoint"]))
    model = model.to(dev).train()

    freeze = bool(args.get("freeze") or config["run"].get("freeze", False))
    if freeze:
        model.encoder.requires_grad_(False)
    optimizer = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=float(config["run"].get("lr", 1e-3)))
    generator = torch.Generator(dev).manual_seed(7)

    exp_root = os.path.join(str(args.get("exp_dir", "./exp")), str(args.get("task", "task")))
    os.makedirs(exp_root, exist_ok=True)
    epochs = int(config["run"].get("epochs", 100))
    test_acc_hist, step_losses = [], []
    with open(os.path.join(exp_root, "downstream_stats.txt"), "a", buffering=1) as stats_file:
        for epoch in range(epochs):
            t0 = time.time()
            losses = AverageMeter()
            for waves, labels in train_loader.epoch(epoch):
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
            print(json.dumps(stats), file=stats_file)
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
