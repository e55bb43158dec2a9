"""audiossl_tpu_torch — the PyTorch / CUDA port of audiossl_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find. It imports torch, numpy, scipy and yaml, and
never jax, flax or anything of ``audiossl_tpu``: where it needs a host-side
helper from there (mel filterbank, WAV decode, config loading) it keeps its
own copy.

Every TPU kernel on a ported path becomes a kernel written by hand for
Hopper (``csrc/``, built at first use by ``kernels.py``). Each kernel has a
plain PyTorch version beside it; a wrapper takes the plain version only for
a tensor on the CPU, and on a CUDA tensor launches the kernel or raises.

Ported so far (the serving slice, DeLoRes-S pretraining, SS-MAST pretraining,
the downstream probe with AST, the SS-MAST checkpoint served and probed,
DeLoRes-M, SLICER and UnFuSeD pretraining, the clustering family, the
supervised MAST fine-tune, data parallelism across processes with its host
data, tensor, sharded-state, pipeline, expert and sequence parallelism):
  config.py           YAML config loading
  data/wav.py         WAV decode / resample / write
  data/pipeline.py    ManifestLoader: CSV manifest -> windowed wave batches,
                      labelled and class-balanced, host_shard, tar rows
  data/tar.py         tar-shard manifests (shard.tar::member rows, write_shards)
  data/native.py      the C++ batch WAV loader (csrc/wavloader.cpp, g++)
  data/hf.py          HFLoader: the HF-hosted speech_commands tasks
  data/multilabel.py  AudioSet-style JSON datafile + label CSV -> multi-hot loader
  data/norm_stats.py  feature mean / std over a manifest (CLI)
  data/augment.py     RunningNorm, MixupBYOLA ring bank, Kmix, MixGaussianNoise,
                      RandomResizeCrop, SpecMask, precomputed-norm views and
                      MAST noise
  frontend/           log-mel and Kaldi fbank: plain versions + the Hopper
                      log-mel and dense-rows kernels; waveform mixup; the
                      sequence-parallel log-mel (sp.py)
  ops/                windowing, running norm, bicubic crop-resize, masking,
                      block 1 (conv-BN-ReLU-pool) with its three Hopper
                      kernels, rel-pos attention with its three Hopper kernels
  ops/tokens.py       PatchDrop (AST)
  models/audiontt.py  AudioNTT2020Task6, eval and training paths
  models/mvit.py      MViTv2; models/mast.py: MAST and MASTWithHead
  models/ast.py       AST (plain ViT), its attention on the same kernels
  models/efficientnet.py  EfficientNet-B0
  models/surgery.py   cross-shape checkpoint surgery (pos / rel-pos resize)
  models/heads.py     Barlow projector and loss, SLICER's cluster head,
                      UnFuSeD's classifier
  models/convert.py   flax variables -> reference state_dicts (AudioNTT, MAST,
                      AST, EfficientNet) and whole objective states
                      (DeLoRes-M, SLICER, UnFuSeD, DECAR-v2, DeepCluster-v1)
                      and the MAST fine-tune's classifier;
                      reference <-> port layouts
  objectives/         DeLoRes-S, DeLoRes-M, SLICER, UnFuSeD (labelled
                      batches), SS-MAST (MoCo queue, EMA key encoder), DECAR-v2
                      (prototypes, memory bank), the clustering toolbox
                      (PCA-whitening, k-means, kNN, PIC), make_pseudo_labels,
                      the DINO loss
  parallel/           launch.py: joining a process group (torchrun, AUDIOSSL_*,
                      SLURM); dist.py: the collectives and groups of every
                      axis; tp*.py: tensor parallelism; fsdp.py: sharded
                      state; pipeline.py, pipeline_ast.py: GPipe; moe.py:
                      the Switch MoE; ring.py: ring attention
  train/              optimizers (SGD, Adam, AdamW, LARS, LARC, layer-decay
                      AdamW), train step, gradient accumulation, checkpoints,
                      loop, the SIGTERM guard; the DECAR-v2, DeepCluster-v1
                      and supervised MAST fine-tune trainers
                      (python -m audiossl_tpu_torch.train.finetune_mast)
  train_upstream.py   pretraining CLI
  downstream/         DownstreamModel (AudioNTT, EfficientNet, MAST, AST), the
                      LAPE task registry, the linear probe / fine-tune,
                      extract_features
  train_downstream.py downstream probe CLI
  utils/metrics.py    AverageMeter, Accuracy, NMI, mAP, AUC, d-prime
  serve/export.py     waveform -> embedding serving behind the log-mel or the
                      fbank, artifact, CLI
"""
from __future__ import annotations

import contextlib

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default) raises when
    no CUDA device is present: the port never carries on silently on the
    CPU unless the caller asked for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (expected 'cuda' or 'cpu')")
    return dev


@contextlib.contextmanager
def no_tf32():
    """IEEE f32 for cuDNN convs and cuBLAS matmuls inside the block (cuDNN
    convs default to TF32 on the card); restores the caller's settings after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
