"""DeepCluster-v1 trainer: k-means pseudo-labels each epoch, uniform-cluster
sampling and classification CE (port of
``audiossl_tpu.train.deepcluster_loop``).

The reference's epoch mode (extras/delores-s/main_back.py + clustering.py
Kmeans + utils.py:105-148 UnifLabelSampler + utils.py:69-95
compute_features). Each epoch:

  1. eval-mode features of every clip, in manifest order: the frame-mean
     of AudioNTT's output on the raw log-mel (no augmentation, no norm);
  2. PCA-whitening, L2 and k-means (objectives/clustering.py, the faiss
     transcription), draws from ``np.random.default_rng(seed + epoch)``;
  3. an epoch of indices drawn uniformly over the clusters;
  4. a fresh top layer (N(0, 1/d) weights from
     ``torch.Generator().manual_seed(seed + 100 + epoch)``, zero bias) with
     its momentum reset (``reset_subtree_opt_state``), then CE steps on
     single un-augmented views with SGD (lr ``run.learning_rate``, 0.05;
     momentum 0.9; coupled weight decay 1e-5; main_back.py:54-59). A tail
     batch shorter than B is dropped.

On the card a feature batch launches the log-mel kernel once and no block-1
kernel (block 1's kernels are training-only); a step launches the log-mel
kernel and block 1's forward, backward sums and weight kernels once each.
The checkpoint at each epoch's end (and at ``max_steps``) records the next
epoch (the same epoch after a SIGTERM stop at the log cadence), the step, the encoder, the optimizer, the generator and the
sampler's rng; a resumed run starts that epoch from its feature pass and
does not restore the top layer, which each epoch makes anew (the reference
deletes it from checkpoints, main_back.py:68-72).

Data parallel across processes as the JAX trainer shards its feature pass
and step over the ``data`` mesh (torchrun or the ``AUDIOSSL_*``
environment, parallel/launch.py): every process reads the global batches
and embeds or trains on its contiguous share; the features are gathered
in manifest order, rank 0's clustering is broadcast, and the step's
gradients and loss are the group's means. Rank 0 writes the checkpoints,
with every process's generator.

``pretrain.tp``, ``run.fsdp`` and ``run.zero_optimizer`` raise
NotImplementedError (``train.loop.check_parallel_knobs``): the JAX trainer
has no such path.
"""
from __future__ import annotations

import copy
import logging
import os
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import config as cfgmod
from audiossl_tpu_torch import no_tf32, resolve_device
from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.frontend import build_frontend
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6
from audiossl_tpu_torch.objectives.api import flax_init_
from audiossl_tpu_torch.objectives.clustering import Kmeans, uniform_label_epoch
from audiossl_tpu_torch.objectives.delores_s import DTYPES
from audiossl_tpu_torch.objectives.unfused import cross_entropy
from audiossl_tpu_torch.train import checkpoint as ckpt
from audiossl_tpu_torch.train.decar_loop import waves_to_device
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.train.loop import (MetricsBuffer, check_parallel_knobs, finish_saves, gather_generators,
                                           global_batch, join_group, stats_log)
from audiossl_tpu_torch.train.optim import sgd_torch
from audiossl_tpu_torch.train.preemption import PreemptionGuard
from audiossl_tpu_torch.train.step import TrainStep

log = logging.getLogger("audiossl_tpu_torch.deepcluster")


class DeepClusterNet(nn.Module):
    """AudioNTT -> frame-mean -> f32 top layer: [B, 1, F, T] ->
    (features [B, d], logits [B, K]). ``loss`` is an objective's (the CE of
    view 1's logits against the batch's pseudo-labels), so ``TrainStep``
    drives it."""

    def __init__(self, n_mels: int, d: int, n_clusters: int, compute_dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.3):
        super().__init__()
        self.encoder = AudioNTT2020Task6(n_mels=n_mels, d=d, compute_dtype=compute_dtype, dropout_rate=dropout_rate)
        self.top_layer = nn.Linear(d, n_clusters)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.encoder.compute_dtype

    def features(self, v: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.encoder(v, generator).mean(dim=1)

    def forward(self, v: torch.Tensor, generator: torch.Generator | None = None):
        emb = self.features(v, generator)
        with no_tf32():
            return emb, F.linear(emb, self.top_layer.weight, self.top_layer.bias)

    def loss(self, v1: torch.Tensor, v2: torch.Tensor | None = None, generator: torch.Generator | None = None,
             labels: torch.Tensor | None = None) -> torch.Tensor:
        """CE of view 1's logits against ``labels`` (view 2 is not used)."""
        if labels is None:
            raise ValueError("DeepCluster-v1 trains on pseudo-labelled batches: loss() needs the labels")
        return cross_entropy(self(v1, generator)[1], labels)

    @torch.no_grad()
    def reset_top_layer_(self, weight: torch.Tensor) -> None:
        """A fresh top layer: ``weight`` [K, d] and a zero bias."""
        self.top_layer.weight.copy_(weight)
        self.top_layer.bias.zero_()


def top_layer_draw(d: int, n_clusters: int, seed: int) -> torch.Tensor:
    """The top layer's weight [K, d], N(0, 1) / sqrt(d) from a CPU generator."""
    return torch.randn((n_clusters, d), generator=torch.Generator().manual_seed(seed)) / float(np.sqrt(d))


def reset_subtree_opt_state(optimizer: torch.optim.Optimizer, module: nn.Module) -> None:
    """Zero the optimizer state (SGD's momentum buffers) of ``module``'s
    parameters: the re-initialised head's momentum starts again, the
    encoder's is kept (the reference builds the top layer's optimizer anew
    each epoch)."""
    for p in module.parameters():
        for v in optimizer.state.get(p, {}).values():
            if isinstance(v, torch.Tensor):
                v.zero_()


def build_net(pre: dict[str, Any], seed: int, device: torch.device) -> DeepClusterNet:
    """The encoder at flax's initialisation from ``seed`` (as
    ``init_objective``), the top layer from ``seed + 1``."""
    enc = pre["base_encoder"]
    d = int(enc.get("output_dim", 2048))
    with torch.device("meta"):
        net = DeepClusterNet(int(pre["input"]["n_mels"]), d, int(pre.get("num_clusters", 10)),
                             DTYPES[str(enc.get("compute_dtype") or "bfloat16")],
                             float(enc["dropout"]) if enc.get("dropout") is not None else 0.3)
    net = net.to_empty(device="cpu")
    flax_init_(net, torch.Generator().manual_seed(seed))
    net.reset_top_layer_(top_layer_draw(d, net.top_layer.out_features, seed + 1))
    return net.to(device)


@torch.no_grad()
def feature_pass(net: DeepClusterNet, loader: ManifestLoader, frontend, epoch: int, dev: torch.device) -> torch.Tensor:
    """Eval-mode features [N, d] of every clip in manifest order; across
    processes each embeds its share of every batch and the shares are
    gathered in rank order (JAX's sharded embed step)."""
    net.eval()
    feats = []
    for waves, _ in loader.epoch(epoch, order=np.arange(loader.num_samples)):
        part = net.features(frontend(waves_to_device(dist.share(waves), dev))[:, None])
        feats += [p.to(dev) for p in dist.gather_objects(part.cpu())] if dist.active() else [part]
    net.train()
    return torch.cat(feats)


def train_deepcluster_v1(
    config: dict[str, Any],
    input_csv: str,
    load_checkpoint: str | None = None,
    max_steps: int | None = None,
    seed: int = 31,
    device: str | torch.device = "cuda",
):
    """DeepCluster-v1 pretraining on ``input_csv`` -> (net, final step,
    checkpoint directory, the last epoch's cluster ids [N] or None)."""
    dev = resolve_device(device)
    world = join_group(config["run"], dev)
    check_parallel_knobs(config)
    config = copy.deepcopy(config)
    run, pre = config["run"], config["pretrain"]
    batch = global_batch(int(run["batch_size"]), world)  # every process reads it and trains on its share
    frontend = build_frontend(pre["input"])
    loader = ManifestLoader(
        input_csv, batch_size=batch, clip_samples=cfgmod.clip_samples(config), sample_rate=frontend.sample_rate,
        shuffle=False, drop_last=False,  # the order comes from uniform_label_epoch; features embed every clip
        num_workers=int(run.get("num_dataloader_workers", 8)), seed=seed,
        wire_dtype=str(run.get("wire_dtype", "int16")), on_error=str(run.get("data_on_error", "raise")),
    )
    n_total = loader.num_samples
    net = build_net(pre, seed, dev).train()
    n_clusters, d = net.top_layer.out_features, net.top_layer.in_features
    optimizer = sgd_torch(net.parameters(), float(run.get("learning_rate", 0.05)), momentum=0.9, weight_decay=1e-5)
    generator = torch.Generator(device=dev).manual_seed(dist.rank_seed(seed))
    # no augmentation and no norm (the config has none): both views are the raw log-mel
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=n_total)
    aug_state = pipeline.init_state(frontend.n_mels, frontend.num_frames(loader.clip_samples), dev)
    train_step = TrainStep(net, pipeline, frontend, optimizer, generator, None, str(pre.get("normalization", "none")))
    order_rng = np.random.default_rng(seed)
    start_epoch, step = 0, 0
    if load_checkpoint:
        saved = ckpt.load_checkpoint(load_checkpoint)
        net.encoder.load_state_dict(saved["encoder"])  # the top layer is made anew each epoch
        optimizer.load_state_dict(saved["optimizer"])
        if len(saved["generator"]) != world:
            raise ValueError(f"the checkpoint was written by {len(saved['generator'])} process(es), this run has "
                             f"{world}: resume at the world size it was saved at")
        generator.set_state(saved["generator"][dist.rank()])
        order_rng.bit_generator.state = saved["order_rng"]
        start_epoch, step = int(saved["epoch"]), int(saved["step"])
        log.info("resumed from %s at epoch %d step %d", load_checkpoint, start_epoch, step)

    ckpt_dir = run.get("save_path", "./runs/decar_v1") + "_chkp"
    if dist.rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
    keep_last = int(run.get("keep_checkpoints", 0)) or None
    labels = None
    done = preempted = False
    with stats_log(os.path.join(ckpt_dir, "stats.jsonl")) as stats_file, PreemptionGuard() as guard:
        buf = MetricsBuffer(int(run.get("log_every", 10)), stats_file)
        for epoch in range(start_epoch, int(run.get("epochs", 1))):
            feats = feature_pass(net, loader, frontend, epoch, dev)
            km = Kmeans(n_clusters, pca_dim=min(128, d), seed=seed + epoch)
            km_loss = km.cluster(feats)
            labels = np.full((n_total,), -1, np.int64)
            for c, members in enumerate(km.images_lists):
                labels[np.asarray(members, np.int64)] = c
            if dist.active():  # rank 0's clustering on every process (the JAX trainer clusters once, on the host)
                labels, km_loss = dist.gather_objects((labels, km_loss))[0]
                km.images_lists = [np.flatnonzero(labels == c).tolist() for c in range(n_clusters)]
            log.info("epoch %d: k-means objective %.6g over %d clips, %d non-empty of %d clusters",
                     epoch, km_loss, n_total, sum(1 for m in km.images_lists if m), n_clusters)
            order = uniform_label_epoch(km.images_lists, n_total, order_rng)
            labels_dev = torch.from_numpy(labels).to(dev)
            net.reset_top_layer_(top_layer_draw(d, n_clusters, seed + 100 + epoch).to(dev))
            reset_subtree_opt_state(optimizer, net.top_layer)
            t_end = time.time()
            for b, (waves, _) in enumerate(loader.epoch(epoch, order=order)):
                if len(waves) < batch:
                    continue  # the tail batch
                data_time = time.time() - t_end
                y = labels_dev[torch.from_numpy(dist.share(order[b * batch:(b + 1) * batch])).to(dev)]
                aug_state, loss = train_step(aug_state, torch.from_numpy(dist.share(waves)).to(dev), y)
                step += 1
                batch_time = time.time() - t_end
                t_end = time.time()
                if buf.push(epoch, step, loss.detach(), batch_time, data_time, kmeans_loss=km_loss):
                    log.info("epoch %d step %d loss %.4f", epoch, step, buf.last_loss)
                    if guard.should_stop():  # the epoch-end save below runs on break
                        log.warning("SIGTERM: stopping at step %d for the preemption save", step)
                        done = preempted = True
                        break
                if max_steps and step >= max_steps:
                    done = True
                    break
            buf.flush()
            # a preempted epoch records `epoch`, not epoch + 1: DeepCluster is
            # epoch-granular (features -> k-means -> CE), so a resume re-runs
            # the interrupted epoch rather than skip its remaining steps
            generators = gather_generators(generator)  # a collective
            if dist.rank() == 0:
                state = {"epoch": epoch if preempted else epoch + 1, "step": step, "encoder": net.encoder.state_dict(),
                         "optimizer": optimizer.state_dict(), "generator": generators,
                         "order_rng": order_rng.bit_generator.state, "config": config}
                ckpt.save_checkpoint(ckpt_dir, step, state, net.encoder.state_dict(), config, keep_last)
            if done:
                break
    finish_saves()
    return net, step, ckpt_dir, labels
