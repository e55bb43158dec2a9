#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (audiossl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, started
together), holds each against its plain PyTorch version on the card, and
drives the port's main paths at full width with seeded weights:

  * serving: WAV requests -> Hopper log-mel kernel -> AudioNTT-2048 ->
    embedding;
  * training: DeLoRes-S pretraining through the ``train_upstream`` entry
    point (configs/delores_s.yaml, B=256, bf16) for 3 steps, whose views
    come from the log-mel kernel and whose block 1 runs the three block-1
    kernels; its exported encoder then serves one batch, and one f32 step
    on the card is held against the same step on the CPU plain path.

  * SS-MAST pretraining (slice 3) through ``train_upstream`` at the
    config's full width (configs/ssmast.yaml as it stands: MViTv2-B,
    128 x 1024 fbank, B=64, bf16) for 3 steps, whose fbank runs
    the dense-rows kernel and whose 24 attention blocks run the rel-pos
    attention kernels (forward in the query and the key pass, both backward
    kernels); its exported MAST trunk then embeds, and one f32 MAST-tiny
    step on the card is held against the CPU.

  * the log-mel dispatcher (slice 4): ``frontend.logmel_features`` on a
    config that is not ``ct_eligible`` (n_fft = 400) launches the rows
    kernel in librosa mode once and matches the plain log_mel; each
    attention kernel (the forward since slice 5) run twice gives the same
    bits.

Slice 5 redesigned the log-mel kernel (in-kernel framing in front of a
shared-memory FFT, for every power-of-two n_fft) and the bf16 attention
forward (tensor-core tiles); the checks above hold them as before, with
log-mel cases at the narrow-filter widths (n_fft 256 with 64 mels, 1024
with 128).

  * the downstream probe and AST-base (slice 6): the linear probe
    (``train_downstream --freeze``) on the DeLoRes-S run's checkpoint at
    configs/downstream.yaml as it stands; the attention kernels at
    AST-base's (384, 1214, 64) with no bias (the forward and dq streamed
    over keys), a ragged 1500 and 64 n + 1 keys; AST-base fine-tuning
    through ``train_downstream`` at 128 mels x 1025 frames, B=32, 3 steps
    and one eval batch; an f32 AST-tiny step at 1214 tokens on the card
    against the CPU. The build's ptxas report must show no attention
    kernel spilling, the log-mel kernel is held at both paths' shapes, and
    the f32 DeLoRes-S step gate runs 12 batches.

  * block 1's backward passes on bf16 tensor-core tiles (slice 7): the
    ptxas report of block1.cu is held to no spill as well, each backward
    pass run twice must give the same bits, and each backward pass's two
    launches (the main kernel and the ordered sum of the blocks' partials)
    are timed apart by torch.profiler.

  * block 1's forward on bf16 tensor-core tiles (slice 8): the forward run
    twice must give the same bits at every case, and the block's other
    forward half, the batch statistics (plain torch, as on the TPU it is
    XLA), is timed by graph replay beside the kernels.

  * the SS-MAST checkpoint put to use (slice 9), on phase 10's run:
    MAST-B served behind the Kaldi fbank kernel from that checkpoint
    (``serve.export --checkpoint``, 1024 frames, bf16, a fixed batch of
    64, requests of 1, 7, 64 and 65 clips: per batch one rows launch and 24
    attention forwards), AST-base behind the fbank with seeded weights (12
    streamed forwards a batch), each against f32 on the card and f32 on
    the CPU; the attention kernels at every shape of MAST-B on the probe's
    9 x 5 token grid (Lq from 45 down to 2); the MAST-B probe on that
    checkpoint through ``train_downstream`` at 64 mels x 1 s, B=32 (the
    cross-shape transplant logged; frozen 1 log-mel and 24 attention
    forwards a step and no backward, then fine-tuned with 24 + 24 backward
    launches a step); and ``extract_features`` on the card against the CPU
    (log-mel, and the embeddings of phase 7's DeLoRes-S checkpoint).

  * the rest of the AudioNTT objective family (slice 10): DeLoRes-M,
    SLICER and UnFuSeD pretraining through ``train_upstream`` on their
    configs as they stand (B=256, bf16, AudioNTT-2048, the 65536-key queue;
    UnFuSeD on a manifest with a ``label`` column of ids 0-98) for 3 steps
    each. Per step the log-mel kernel launches once and block 1's forward /
    backward-sums / backward-weight kernels 2/1/1 (DeLoRes-M: the key pass
    takes the forward with no backward), 4/2/2 (SLICER: two directions) and
    1/1/1 (UnFuSeD). The queue pointer must advance by B (DeLoRes-M) or 2B
    (SLICER) a step and the key encoder move; each exported encoder serves;
    each objective passes the f32 step gate (12 batches of B=8 card vs CPU,
    the key encoder, queue and pointer after the step as well) and has its
    step timed at B=256 (clips/s, split, busy share).

  * the clustering family (slice 11), on 1280 distinct 1 s clips of 16
    generating classes: DECAR-v2 through ``train_decar`` on
    configs/decar_v2.yaml as it stands (B=256, AudioNTT-512, 1024
    prototypes, LARC) for 2 epochs / 7 steps (one log-mel launch per
    memory-bank batch, then 1/2/1/1 a step; both clusterings assign every
    clip and leave the prototypes equal to the centroids), DeepCluster-v1
    through ``train_deepcluster_v1`` on configs/decar_v1.yaml (d=2048, 512
    clusters) for 3 steps (one log-mel launch per feature batch, then
    1/1/1/1 a step; its k-means objective printed), ``make_pseudo_labels``
    on phase 7's DeLoRes-S checkpoint (585 clusters; the NMI of its labels
    against the generating classes printed) and DeLoRes-S with Kmix on its
    centroids (a copy of configs/delores_s_kmix.yaml, 3 steps, 1/2/2/2 a
    step, the ranked partner search taking over after the first push); the
    f32 step gate of both new steps (DECAR's bank rows as well), their step
    times at B=256, and the seconds of one DECAR clustering and one
    memory-bank pass.

  * the supervised MAST fine-tune (slice 12), on AudioSet-style data (32
    distinct 10 s WAVs, a 527-class label CSV, train and eval JSONs): the
    fine-tune through its CLI on configs/mast_ft.yaml as it stands (MAST-B,
    128 x 1024 fbank, B=64, bf16, mixup, SpecMask, norm and noise on) for 3
    steps and an eval of 65 clips (per step 1 Kaldi rows launch, 24
    attention forwards, 24 dq and 24 dk/dv; per eval batch 1 and 24; mAP
    and AUC in [0, 1]), its export served behind the fbank; the same at
    --grad_accum_steps 2 (2 / 48 / 48 / 48 a step); SS-MAST at
    pretrain.grad_accum_steps 2 (1 / 96 / 48 / 48 a step); an f32 MAST-tiny
    step card vs CPU with every augmentation on (1e-2 faults refused) and
    accumulating 2 against 1 on the card; the step's clips/s, split, busy
    share and peak memory, and eval clips/s.

  * data parallelism and its host data (slice 13): the native WAV loader,
    built with g++ from the port's csrc/wavloader.cpp, decodes as the NumPy
    path does and gives its batches where no crop is drawn; DeLoRes-S trains
    3 steps through the CLI on a tar-sharded manifest (data/tar.py), on the
    native path, the loaders' default (1/2/2/2 a step). Two gloo ranks share
    the card (NCCL refuses two ranks on one GPU; the script, not the
    package, chooses gloo): DeLoRes-S at full width, B=256 as 2 x 128, one
    step held against one process's on the same views and dropout masks, in
    bf16 within 4 times the distance of one process on the same rows in
    another order, in f32 within 1e-5 on the loss and the parameters and
    that band of the f32 yardstick on the gradient, which two planted
    faults (SyncBN on local moments, a gradient sum for the mean) must
    fail, with exact launches and collectives a rank; train_upstream at world 2
    (2 steps, the checkpoint's world-sized augmentation state); SS-MAST on
    configs/ssmast.yaml at world 2 (32 clips a rank, 2 steps), then with
    shuffle-BN (1 step), each checkpoint's queue holding both ranks' keys in
    rank order. Last, NCCL at world 1 through ``maybe_init_distributed()``
    from torchrun-style env gives the bits of no process group.

  * tensor parallelism (slice 14): the attention kernels at each rank's
    AST-base shape under downstream.tp 2 ([192, 1214, 64], 6 of the 12
    heads, no bias), f32 and bf16, against their plain versions and timed;
    then gloo ranks sharing the card (the script, not the package, chooses
    gloo): f32 gates, MAST tiny's SS-MAST step and a 4-head AST's step at
    1214 tokens, at tp 2 and at dp 2 x tp 2 against one process within 4
    times one process's distance from itself on the same rows in another
    order (plus f32 round-off), which two planted faults (the all-reduce
    after a row-parallel layer with a summed backward, the gradients
    averaged over the whole world) must fail; SS-MAST at pretrain.tp 2
    through train_upstream on a copy of configs/ssmast.yaml (B=64, bf16,
    MViTv2-B, 2 steps: 1 / 48 / 24 / 24 launches a step a rank, half of
    every qkv, attention proj and MLP weight and of their moments a rank,
    the peak memory a rank beside one process's), a resume of its dense
    checkpoint at tp 2, and its export served at tp 1 behind the fbank;
    AST-base at downstream.tp 2 through train_downstream (B=32, 1214 tokens,
    2 steps and an eval batch, 1 / 12 / 12 / 12 a step a rank and 1 / 12 an
    eval batch; with --freeze 1 / 12 / 0 / 0); each rank's step time and busy
    share (gloo through the host, not a multi-GPU rate).

  * sharded training state over the data axis (slice 15), gloo ranks
    sharing the card: f32 gates at world 2 against one process on the same
    rows, with the same yardstick (SS-MAST on MAST tiny under run.fsdp, its
    whole gradients; under run.zero_optimizer, its AdamW update; the MAST
    tiny fine-tune under fsdp with the clip engaged, its gradients and the
    clip's global norm), which three planted faults (the gradients'
    reduce-scatter as a sum, the whole leaves counted twice in the clip's
    norm, a ZeRO slice one row off) must fail; SS-MAST on a copy of
    configs/ssmast.yaml with run.fsdp (B=64 as 32 a rank, bf16, MViTv2-B, 3
    steps: 1 / 48 / 24 / 24 launches a step a rank, each piece and moment as
    JAX's fsdp_spec cuts the leaf, the queue split on K) with a resume of
    its dense checkpoint and its export served at world 1; the same with
    run.zero_optimizer (2 steps, each moment a flat half); the fine-tune with
    --fsdp through finetune_mast.main on configs/mast_ft.yaml (3 steps, 1 /
    24 / 24 / 24 a step a rank, and an eval); each rank's peak memory beside
    one fresh process's at a rank's batch (B=32), and the collectives a step
    a rank by kind.

  * the parallelism library (pipeline, expert, sequence): first a probe of which gloo
    operations take CUDA tensors, in two processes of its own
    (all_to_all_single does; point-to-point does not, and its refusal can
    end the process, so parallel/dist.py stages it through the host); then
    one spawn of two gloo ranks sharing the card: AST-base pipelined over 2
    stages (B = 8 as 4 microbatches, bf16 attention, 24 forward launches a
    rank) against one process; the vit_block stack at AST-base's widths
    (12 blocks, 1214 tokens, f32 attention) forward and backward through
    the GPipe schedule (24 / 24 / 24 a rank) against the sequential stack,
    which the planted summed output backward must fail; the Switch MoE at d
    768, hidden 3072, E = 8, 2 x 1214 tokens a rank, at capacity 379 and 94,
    against the dense one-process computation; 61.44 s clips through the sp
    log-mel (one launch a rank) and the blockwise AST with ring attention
    against world 1, and 10 s clips' sp log-mel against the one-process
    kernel frame for frame.

It checks the outputs, times each kernel, its plain version and a library
composition (every kernel as CUDA graph replays, block 1's since slice 7;
the attention at MAST-B's shapes and at AST-base's), serving (AudioNTT,
and MAST-B and AST-base behind the fbank) and training (DeLoRes-S,
DeLoRes-M, SLICER, UnFuSeD, DECAR-v2, DeepCluster-v1, SS-MAST, the AST-base
fine-tune, the MAST-B probe), and prints:

  * the card's name and power limit as nvidia-smi gives them;
  * one {"kernels": [...]} JSON line (launches on the main paths, error
    against the plain version, times and the bound of each kernel);
  * as the last line {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it exits non-zero at once. Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CLIP = 15200  # 0.95 s at 16 kHz, the serving clip (configs/delores_s.yaml)
SERVE_BATCH = 256
REQUESTS = (1, 7, 256, 300)
TOL_KERNEL = 1e-3  # the librosa log-mel contract
TOL_BF16 = 5e-2  # bf16 serving vs f32 on the card, relative to max|f32|
TOL_F32 = 1e-3  # f32 on the card vs the CPU path, relative to max(1, max|cpu|)
# block 1, set from the first runs (NVIDIA H100 80GB HBM3, 700 W), which measured
# 6.4e-8, 1.9e-6 and 4.0e-6 against these bounds:
TOL_B1_F32 = 1e-5  # forward, f32: kernel vs plain, relative to max(1, max|plain|)
TOL_B1_SUMS = 1e-5  # backward passes: kernel vs plain, relative to max|plain|
TOL_B1_GRAD = 1e-4  # dW, dbias, dgamma, dbeta of FusedBlock1: card vs CPU, relative
# f32 training step, card vs CPU on the same views, over STEP_BATCHES batches
# of B=8: the loss, relative, in every batch; all gradients as one vector,
# relative in norm, and each tensor in norm, relative to its own norm (+ 1e-2
# of the largest); the worst element of each tensor, max|d| / max|ref|. A
# ReLU, max-pool or temporal-max routing that flips at round-off moves this
# model's f32 gradients by up to 1e-2 in norm at any batch size (measured
# on the CPU alone at B = 8 to 256), in some batches and not others: a flip is
# a chance event of one batch, a fault of the port shows in every batch, or in
# most. So at least STEP_PASS batches must pass every gradient bound at once,
# and every batch the loss (continuous); f32_step_check shows that a gradient
# scaled by 1 + 1e-2 fails, in every batch or in two of three. (The flips
# showed in 4-8 of 12 batches of B = 8 on the CPU, in 3 of 12 on the card.)
TOL_STEP_LOSS = 1e-5
TOL_STEP = 1e-3
TOL_STEP_TENSOR = 5e-2
STEP_BATCHES = 12
STEP_PASS = STEP_BATCHES // 2
STEP_FAULT = 1e-2
TRAIN_STEPS = 3
TRAIN_SEED = 31  # train_upstream's default seed: the runs' initial weights
# launches a step of log_mel_fused / block1_fwd / block1_bwd_sums /
# block1_bwd_weight through train_upstream: one log-mel; block 1's forward
# in every query and key pass, its backward passes once for each query pass
NTT_KERNELS = ("log_mel_fused", "block1_fwd", "block1_bwd_sums", "block1_bwd_weight")
TRAIN_LAUNCHES = {
    "delores_s": (1, 2, 2, 2),  # both views through one encoder
    "delores_m": (1, 2, 1, 1),  # the query pass on view 1, the key pass (no backward) on view 2
    "slicer": (1, 4, 2, 2),  # two directions, each a query and a key pass
    "unfused": (1, 1, 1, 1),  # view 1 only
    "decar_v2": (1, 2, 1, 1),  # view 1's pass (no gradient) and view 2's
    "decar_v1": (1, 1, 1, 1),  # one un-augmented view
    "delores_s_kmix": (1, 2, 2, 2),  # DeLoRes-S with Kmix partners
}
QUEUE_BATCHES = {"delores_m": 1, "slicer": 2}  # batches of keys enqueued a step
# gradients the f32 step gate must refuse when scaled by 1 + STEP_FAULT in
# every batch; the first also in two batches of three only
STEP_FAULTS = {
    "delores_s": ("encoder.features_1.0.weight", "encoder.features_1.1.weight", "encoder.features_1.1.bias",
                  "encoder.fc.0.weight", "projector.projector.3.weight"),
    "delores_m": ("encoder.encoder.features_1.0.weight", "encoder.encoder.features_1.1.weight"),
    "slicer": ("encoder.encoder.features_1.0.weight", "encoder.encoder.features_1.1.weight"),
    "unfused": ("encoder.features_1.0.weight", "encoder.features_1.1.weight"),
    "decar_v2": ("net.encoder.features_1.0.weight", "net.encoder.features_1.1.weight"),
    "decar_v1": ("encoder.features_1.0.weight", "encoder.features_1.1.weight"),
}
TOL_EMA = 1e-6  # the key encoder's parameters after the EMA, card vs CPU, relative to max(1, max|ref|)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor
# FLOP/s, bf16 dense tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12


def device_kernels_us(averages) -> dict[str, float]:
    """Device microseconds by kernel from ``prof.key_averages()``, without
    the profiler's ranges over device work (``Optimizer.step#...``), whose
    device time is their kernels' again."""
    return {e.key: e.self_device_time_total for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` captured once in a CUDA graph and replayed
    ``iters`` times, by CUDA events. The host's launch gaps drop out: at the
    small attention shapes an eager loop of the plain or the library version
    is bound by the host, and its time would be the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, iters)
    del graph
    return ms


def logmel_flops(cfg, n_frames_total: int, mel_nnz: int) -> float:
    """f32 operations the log-mel function needs (an FMA counts two), not
    what any one design spends: per frame the window multiply, a real
    n_fft-point FFT at 2.5 N log2 N, power and + EPS64 over the n_fft/2 + 1
    bins, one multiply-add per nonzero filterbank entry, + EPS32 and the log."""
    n = cfg.n_fft
    per_frame = n + 2.5 * n * math.log2(n) + 4 * (n // 2 + 1) + 2 * mel_nnz + 2 * cfg.n_mels
    return n_frames_total * per_frame


def sine_requests(n: int, rng: np.random.Generator, tmp: str, wav) -> np.ndarray:
    """[n, CLIP] waves decoded from sine WAVs written and read through data/wav.py."""
    t = np.arange(CLIP) / 16000.0
    paths = []
    for i in range(8):
        f0 = 110.0 * 2 ** (i / 2)
        x = 0.5 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t)
        paths.append(os.path.join(tmp, f"sine{i}.wav"))
        wav.write_wav(paths[-1], x.astype(np.float32))
    clips = np.stack([wav.load_wave(p) for p in paths])
    if clips.shape != (8, CLIP):
        raise RuntimeError(f"WAV round trip gave {clips.shape}, expected (8, {CLIP})")
    gains = rng.uniform(0.2, 1.0, (n, 1))
    noise = 0.01 * rng.standard_normal((n, CLIP))
    return (gains * clips[np.arange(n) % 8] + noise).astype(np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from audiossl_tpu_torch import config as cfgmod
    from audiossl_tpu_torch import kernels
    from audiossl_tpu_torch.data import wav
    from audiossl_tpu_torch.frontend import build_frontend, fused_stft
    from audiossl_tpu_torch.frontend.mel import mel_filterbank
    from audiossl_tpu_torch.frontend.stft import EPS32, EPS64, LogMelConfig, log_mel
    from audiossl_tpu_torch.models.audiontt import random_state_dict
    from audiossl_tpu_torch.serve.export import ServingEncoder, build_embedder, save_artifact

    t_start = time.perf_counter()

    def stamp(phase: int) -> None:  # where the script's 1200 s go
        print(f"phase timer: through phase {phase} at {time.perf_counter() - t_start:.1f} s", flush=True)

    # phase 1: the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print("card (nvidia-smi name, power.limit):")
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    # phase 2: build every kernel from the checkout, one nvcc per source started
    # together (nvcc's ptxas report goes to stderr)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    for name, seconds in kernels.load_all().items():
        print(f"build: {kernels.SOURCES[name]} built and loaded in {seconds:.1f} s")
    ptxas_check(kernels)
    stamp(2)

    # phase 3: the kernel against its plain version, both f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    default = LogMelConfig()
    # the narrow-filter widths and the Cooley-Tukey design draw from a
    # generator of their own, so that the data of the phases after this one
    # (drawn from rng) stays what it was before these cases were added
    narrow = np.random.default_rng(1)
    # the shapes of the two downstream paths (the AST-base fine-tune, 1025
    # frames at 128 mels; the AudioNTT probe, 101 frames), from generators of
    # their own as well
    ast_gen, probe_gen = np.random.default_rng(2), np.random.default_rng(3)
    # the sequence-parallel frontend's shapes (phase 46): a rank's slice plus
    # the n_fft - hop halo, framed with center=False, of the 61.44 s clips and
    # of the 10 s clips after pad_for_sp; from a generator of their own too
    sp_gen, halo, unit = np.random.default_rng(4), default.n_fft - default.hop, default.hop * PAR_WORLD
    sp_long = SP_CLIP // PAR_WORLD + halo
    sp_10s = -(-(SP_FRAMES_CLIP + default.n_fft) // unit) * unit // PAR_WORLD + halo
    cases = [
        ("[256, 15200] hop 160", (SERVE_BATCH, CLIP), default, rng),
        ("[5, 12345] hop 160", (5, 12345), default, rng),
        ("[8, 15200] hop 100", (8, CLIP), LogMelConfig(hop=100), rng),
        ("[8, 15200] n_fft 256 hop 64, 64 mels (single-bin filters)", (8, CLIP), LogMelConfig(n_fft=256, hop=64), narrow),
        ("[8, 15200] 128 mels (two-bin filters)", (8, CLIP), LogMelConfig(n_mels=128), narrow),
        ("[4, 15200] n_fft 768, 32 mels", (4, CLIP), LogMelConfig(n_fft=768, n_mels=32), narrow),
        (f"[{AST_BATCH}, {AST_CLIP}] 128 mels (the AST-base fine-tune)", (AST_BATCH, AST_CLIP),
         LogMelConfig(n_mels=128), ast_gen),
        ("[32, 16000] (the AudioNTT probe)", (32, 16000), default, probe_gen),
        (f"[2, {sp_long}] center=False (sp long audio, a rank)", (2, sp_long), LogMelConfig(center=False), sp_gen),
        (f"[2, {sp_10s}] center=False (the 10 s sp clips, a rank)", (2, sp_10s), LogMelConfig(center=False), sp_gen),
    ]
    kernel_err = 0.0
    for label, shape, cfg, gen in cases:
        w = torch.from_numpy((0.5 * gen.standard_normal(shape)).astype(np.float32)).to(dev)
        got = fused_stft.log_mel_fused(w, cfg)
        want = log_mel(w, cfg)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"log-mel kernel {label}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
        err = float((got - want).abs().max())
        print(f"log_mel kernel ({fused_stft.log_mel_design(cfg)} design) vs plain, {label}: max|d| = {err:.3e} "
              f"(tol {TOL_KERNEL})")
        if not err <= TOL_KERNEL:
            raise RuntimeError(f"log-mel kernel disagrees with its plain version at {label}: {err}")
        kernel_err = max(kernel_err, err)

    # phase 4: serving at full width (64 mels, 0.95 s, AudioNTT d=2048, bf16)
    pre = cfgmod.load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "delores_s.yaml"))
    frontend = build_frontend(pre["pretrain"]["input"])
    clip = cfgmod.clip_samples(pre)
    if clip != CLIP or frontend.n_mels != 64:
        raise RuntimeError(f"configs/delores_s.yaml no longer gives {CLIP}-sample clips of 64 mels: {clip}, {frontend}")
    d = int(pre["pretrain"]["base_encoder"]["output_dim"])
    sd = random_state_dict(frontend.n_mels, d, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        pool = sine_requests(max(REQUESTS), rng, tmp, wav)
        art = os.path.join(tmp, "enc.pt")
        save_artifact(build_embedder(sd, frontend, clip, torch.bfloat16, dev), art)
        enc = ServingEncoder(art, bucket=64, device=dev)
    fused_stft.log_mel_fused.launches = 0
    outs = {}
    for n in REQUESTS:
        outs[n] = enc(pool[:n])
    launches = fused_stft.log_mel_fused.launches
    for n, out in outs.items():
        if out.shape != (n, d) or not np.isfinite(out).all():
            raise RuntimeError(f"serving batch {n}: shape {out.shape} or non-finite values")
    print(f"serving: batches {list(REQUESTS)} -> [n, {d}] finite; log-mel kernel launches = {launches}")
    if launches <= 0:
        raise RuntimeError("the serving path did not launch the log-mel kernel")

    emb32 = build_embedder(sd, frontend, clip, torch.float32, dev)
    with torch.inference_mode():
        e32 = emb32(torch.from_numpy(pool[:SERVE_BATCH]).to(dev)).cpu().numpy()
    e16 = outs[SERVE_BATCH]
    rel = float(np.abs(e16 - e32).max() / np.abs(e32).max())
    print(f"serving bf16 vs f32 on the card, batch {SERVE_BATCH}: max|d| / max|f32| = {rel:.3e} (tol {TOL_BF16})")
    if not rel <= TOL_BF16:
        raise RuntimeError(f"bf16 serving embedding strays from f32: {rel}")
    cpu32 = build_embedder(sd, frontend, clip, torch.float32, "cpu")
    with torch.inference_mode():
        ecpu = cpu32(torch.from_numpy(pool[:7])).numpy()
    err_cpu = float(np.abs(e32[:7] - ecpu).max())
    scale = max(1.0, float(np.abs(ecpu).max()))
    print(f"serving f32 card vs CPU plain path, 7 clips: max|d| = {err_cpu:.3e} (tol {TOL_F32 * scale:.3e})")
    if not err_cpu <= TOL_F32 * scale:
        raise RuntimeError(f"f32 serving on the card disagrees with the CPU path: {err_cpu}")

    # phase 5: times at the serving shape, beside the card, as CUDA graph
    # replays (an eager loop at this size times the host)
    cfg = default
    w = torch.from_numpy((0.5 * rng.standard_normal((SERVE_BATCH, CLIP))).astype(np.float32)).to(dev)
    window = torch.hann_window(cfg.n_fft, periodic=True, device=dev)
    mfb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)).to(dev)

    def library():  # torch.stft (cuFFT) -> power -> mel matmul -> log: a yardstick only
        spec = torch.stft(w, cfg.n_fft, cfg.hop, window=window, center=True, pad_mode="reflect", return_complex=True)
        return torch.log(torch.matmul(mfb, spec.real.square() + spec.imag.square() + EPS64) + EPS32)

    lib_err = float((library() - log_mel(w, cfg)).abs().max())
    ms = graph_ms(lambda: fused_stft.log_mel_fused(w, cfg))
    plain_ms = graph_ms(lambda: log_mel(w, cfg))
    library_ms = graph_ms(library)
    n_frames = cfg.num_frames(CLIP)
    flops = logmel_flops(cfg, SERVE_BATCH * n_frames, int(torch.count_nonzero(mfb)))
    design = fused_stft.design_flops(cfg, SERVE_BATCH * n_frames)
    nbytes = 4 * (SERVE_BATCH * CLIP + SERVE_BATCH * cfg.n_mels * n_frames)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[{card}] log-mel [256, 15200], {fused_stft.log_mel_design(cfg)} design: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library (torch.stft) {library_ms:.4f} ms (max|d| vs plain {lib_err:.2e}); "
          f"bound {bound_ms:.4f} ms (function {flops / 1e9:.4f} GFLOP -> {t_ops:.4f} ms, "
          f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms); the kernel's design does "
          f"{design / 1e9:.2f} GFLOP -> {design / PEAK_F32 * 1e3:.4f} ms; all CUDA graph replays")

    emb16 = enc.embedder
    with torch.inference_mode():
        feats = emb16.features(w)
        frontend_ms = cuda_ms(lambda: emb16.features(w))
        encoder_ms = cuda_ms(lambda: emb16.model(feats))
        serve_ms = cuda_ms(lambda: emb16(w))
    batch_np = pool[:SERVE_BATCH]
    enc(batch_np)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        enc(batch_np)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"[{card}] serving B={SERVE_BATCH} bf16, device-resident: {serve_ms:.4f} ms/batch = "
          f"{SERVE_BATCH / serve_ms * 1e3:.1f} clips/s (frontend {frontend_ms:.4f} ms, encoder {encoder_ms:.4f} ms)")
    print(f"[{card}] serving B={SERVE_BATCH} through ServingEncoder (numpy in/out, host clock): "
          f"{host_ms:.4f} ms/batch = {SERVE_BATCH / host_ms * 1e3:.1f} clips/s")

    stamp(5)
    # phase 6: block 1's kernels against their plain versions
    b1_err, grad_errs = block1_checks(dev)

    # phase 7: the training main path through train_upstream, counts from 0
    ntt_tmp = tempfile.TemporaryDirectory()  # its checkpoint feeds extract_features in phase 17
    counts = training_run("delores_s", pool, wav, ntt_tmp.name, dev)
    # the linear probe on the run's checkpoint (downstream.yaml as it stands), counts from 0
    probe_counts = audiontt_probe_run(ntt_tmp.name, wav, dev)
    step_err = f32_step_check("delores_s", pool, dev)

    stamp(7)
    # phase 8: times at the training shape, beside the card
    b1_times = block1_times(dev, card)
    train_times("delores_s", pool, dev, card)

    stamp(8)
    # phase 9: the SS-MAST slice's kernels against their plain versions
    attn_err = attention_checks(dev)
    rows_err = rows_checks(dev)

    # phase 10: the SS-MAST main path through train_upstream, counts from 0;
    # then one f32 step on the card against the CPU
    mast_tmp = tempfile.TemporaryDirectory()  # its checkpoint and WAVs serve slice 9's phases 15-17
    mast_counts = ssmast_training_run(mast_tmp.name, wav, dev)
    mast_step_err = ssmast_f32_step_check(dev)

    # phase 11: the log-mel dispatcher on a config that is not ct_eligible,
    # counts from 0 (the rows kernel in librosa mode, the dense design); each
    # attention kernel run twice gives the same bits
    dispatch = dispatcher_check(dev)
    attention_determinism(dev)

    stamp(11)
    # phase 12: times at the SS-MAST shapes, beside the card
    attn_times = attention_times(dev, card)
    rows_t = rows_times(dev, card)
    ssmast_train_times(dev, card, pool)

    stamp(12)
    # phase 13: the AST slice: the attention kernels at AST-base's 1214 tokens
    # (the streamed designs) against their plain versions, equal bits twice;
    # the AST-base fine-tune through train_downstream, counts from 0; an f32
    # AST-tiny step on the card against the CPU
    ast_err = ast_attention_checks(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ast_counts = ast_finetune_run(tmp, wav, dev)
    ast_step_err = ast_f32_step_check(dev)

    # phase 14: times at AST-base's shape, beside the card
    ast_times = ast_attention_times(dev, card)
    ast_train_times(dev, card)

    stamp(14)
    # phase 15 (slice 9): MAST-B served behind the fbank from phase 10's
    # SS-MAST checkpoint (serve.export --checkpoint), then AST-base behind
    # the fbank with seeded weights (serve.export --config --seed), counts
    # from 0 for each
    ssmast_ckpt = os.path.join(mast_tmp.name, "ssmast_chkp")
    pool9 = slice9_requests(mast_tmp.name, wav, max(SLICE9_REQUESTS))
    with tempfile.TemporaryDirectory() as tmp:
        mast_serve = fbank_serving_run("MAST-B", ["--checkpoint", ssmast_ckpt], pool9, 24, tmp, dev, card)
        ast_serve = fbank_serving_run("AST-base", ["--config", ast_serving_config(tmp), "--seed", "0"], pool9,
                                      AST_DEPTH, tmp, dev, card)

    # phase 16: the attention kernels at every shape of the MAST-B probe
    # (9 x 5 tokens) against their plain versions; the probe on the SS-MAST
    # checkpoint through train_downstream, frozen then fine-tuned, counts
    # from 0 for each; its step times
    probe9_err = mast_probe_attention_checks(dev)
    with tempfile.TemporaryDirectory() as tmp:
        mast_probe_counts = mast_probe_run(ssmast_ckpt, mast_tmp.name, tmp, dev)
        mast_probe_t = mast_probe_times(ssmast_ckpt, dev, card, tmp)

    # phase 17: extract_features on the card against the CPU, log-mel and
    # the embeddings of phase 7's DeLoRes-S checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        extract = extract_features_run(os.path.join(ntt_tmp.name, "delores_s_chkp"), mast_tmp.name, tmp, dev)
    mast_tmp.cleanup()

    stamp(17)
    # phases 18-20 (slice 10): DeLoRes-M, SLICER and UnFuSeD through
    # train_upstream on their configs as they stand, counts from 0 for each;
    # the f32 step gate of each; each step's times at B=256, beside the card
    slice10_counts, slice10_step_err = {}, {}
    for name in ("delores_m", "slicer", "unfused"):
        with tempfile.TemporaryDirectory() as tmp:
            slice10_counts[name] = training_run(name, pool, wav, tmp, dev)
        slice10_step_err[name] = f32_step_check(name, pool, dev)
        train_times(name, pool, dev, card)

    stamp(20)
    # phases 21-24 (slice 11): the clustering family on a manifest of distinct
    # clips. Phase 21: DECAR-v2 and DeepCluster-v1 through their trainers on
    # their configs as they stand, counts from 0 for each
    cluster_tmp = tempfile.TemporaryDirectory()
    csv11, classes11 = write_distinct_manifest(cluster_tmp.name, wav)
    slice11_counts = {"decar_v2": decar_run(csv11, pool, cluster_tmp.name, dev),
                      "decar_v1": deepcluster_run(csv11, classes11, pool, cluster_tmp.name, dev)}
    # phase 22: make_pseudo_labels on phase 7's DeLoRes-S checkpoint, then
    # DeLoRes-S with Kmix on its centroids, counts from 0 for each
    kmix = pseudo_label_kmix_run(os.path.join(ntt_tmp.name, "delores_s_chkp"), csv11, classes11, pool,
                                 cluster_tmp.name, dev)
    ntt_tmp.cleanup()
    slice11_counts.update(make_pseudo_labels=kmix["make_pseudo_labels"], delores_s_kmix=kmix["delores_s_kmix"])
    # phase 23: the f32 step gate of each new step; phase 24: times, beside the card
    slice11_step_err = {name: f32_step_check(name, pool, dev) for name in ("decar_v2", "decar_v1")}
    for name in ("decar_v2", "decar_v1"):
        train_times(name, pool, dev, card)
    cluster_t = clustering_times(csv11, dev, card)
    cluster_tmp.cleanup()

    stamp(24)
    # phases 25-28 (slice 12): the supervised MAST fine-tune on AudioSet-style
    # data. Phase 25: the attention kernels at its shapes against their plain
    # versions; the fine-tune through its CLI on configs/mast_ft.yaml as it
    # stands and its eval, counts from 0, then its export served
    ft_attn_err = finetune_attention_checks(dev)
    ft_tmp = tempfile.TemporaryDirectory()
    ft_data = audioset_style_data(ft_tmp.name, wav, int(finetune_config()["run"]["batch_size"]))
    ft_run = finetune_run(ft_data, ft_tmp.name, dev, card)
    # phase 26: the fine-tune at grad_accum_steps 2, and SS-MAST at
    # pretrain.grad_accum_steps 2, counts from 0 for each
    ft_accum = finetune_accum_run(ft_data, ft_tmp.name, dev)
    with tempfile.TemporaryDirectory() as tmp:
        ssmast_accum = ssmast_accum_run(tmp, wav, dev)
    # phase 27: the f32 fine-tune step gate; phase 28: times, beside the card
    ft_step_err = finetune_f32_step_check(dev)
    ft_times = finetune_times(dev, card, ft_data["clips"])
    ft_tmp.cleanup()
    slice12 = {"finetune_launches": ft_run["counts"], "finetune_accum_launches": ft_accum,
               "ssmast_accum_launches": ssmast_accum}

    stamp(28)
    # phases 29-32 (slice 13): host data and data parallelism. Phase 29: the
    # native loader and a tar-sharded DeLoRes-S run through the CLI, counts
    # from 0; phases 30-31: two gloo ranks on this card, DeLoRes-S (one step
    # against one process, then train_upstream at world 2) and SS-MAST with
    # and without shuffle-BN, counts from 0 in each rank; phase 32: NCCL at
    # world 1 from torchrun-style env gives the bits of no group
    with tempfile.TemporaryDirectory() as tmp:
        tar_run = native_tar_run(wav, tmp, dev)
    with tempfile.TemporaryDirectory() as tmp:
        ddp = ddp_runs(pool, wav, tmp, dev, card)
    nccl = nccl_world_one_check(pool, dev)
    slice13 = {"tar_native_launches": tar_run["counts"],
               "ddp_delores_s_step_launches_per_rank": ddp["delores_s_counts_per_rank"],
               "ddp_delores_s_loop_launches_per_rank": ddp["delores_s_loop_counts_per_rank"],
               "ddp_ssmast_launches_per_rank": ddp["ssmast"]["counts_per_rank"],
               "ddp_ssmast_shuffle_launches_per_rank": ddp["ssmast_shuffle"]["counts_per_rank"]}

    stamp(32)
    # phases 33-37 (slice 14): tensor parallelism. Phase 33: the attention
    # kernels at each rank's shape under downstream.tp 2 against their plain
    # versions, and their times there; phases 34-36: gloo ranks sharing the
    # card, the f32 gates at tp 2 and at dp 2 x tp 2 against one process
    # (each planted fault caught), SS-MAST pretrain.tp 2 through
    # train_upstream (launches a rank, shards, peak memory, a resume, the
    # export served at tp 1), AST-base downstream.tp 2 through
    # train_downstream (fine-tuned and frozen); phase 37: each rank's step
    # time and busy share, beside the card
    tp_attn_err = tp_attention_checks(dev)
    ast_tp_times = ast_attention_times(dev, card, AST_TP_SHAPE)
    with tempfile.TemporaryDirectory() as tmp:
        tp = tp_runs(wav, tmp, dev, card)
    slice14 = {"tp_ssmast_launches_per_rank": tp["ssmast_launches_per_rank"],
               "tp_ast_launches_per_rank": tp["ast_launches_per_rank"],
               "tp_ast_freeze_launches_per_rank": tp["ast_freeze_launches_per_rank"],
               "tp_export_served_launches": tp["served_launches"]}

    stamp(37)
    # phases 38-41 (slice 15): sharded training state over the data axis, gloo
    # ranks sharing the card. Phase 38: the f32 gates at world 2 against one
    # process (SS-MAST under fsdp and under ZeRO, the fine-tune under fsdp
    # with the clip engaged; each planted fault caught); phase 39: SS-MAST
    # run.fsdp through train_upstream (launches and pieces a rank, peak
    # memory, a resume, the dense export served at world 1); phase 40: SS-MAST
    # run.zero_optimizer (moments a rank); phase 41: the fine-tune --fsdp
    # through its CLI entry, with its eval; one fresh process's peaks at a
    # rank's batch beside them
    with tempfile.TemporaryDirectory() as tmp:
        shard = shard_runs(wav, tmp, dev, card)
    slice15 = {key: shard[key] for key in ("fsdp_ssmast_launches_per_rank", "zero_ssmast_launches_per_rank",
                                           "fsdp_finetune_launches_per_rank")}
    stamp(41)
    # phases 42-46: the parallelism library modules (pipeline, MoE, ring, sp), two gloo ranks
    # sharing the card. Phase 42: the gloo probe (which operations take CUDA
    # tensors; printed first); 43: AST-base pipelined over 2 stages (pp-serve)
    # against one process; 44: the vit_block stack's forward and backward
    # through the schedule (pp-train), the f32 gate and its planted fault;
    # 45: the Switch MoE (ep) against the dense computation, with and
    # without drops; 46: the 61.44 s long-audio path (sp log-mel + ring
    # attention) against world 1, and the 10 s sp log-mel frame for frame
    with tempfile.TemporaryDirectory() as tmp:
        par = parallel_lib_runs(tmp, dev, card)
    slice16 = {key: par[key] for key in ("pp_serve_launches_per_rank", "pp_train_launches_per_rank",
                                         "sp_long_audio_launches_per_rank", "sp_frames_launches_per_rank")}
    stamp(46)

    # phase 25: the kernel line
    entries = [{
        "name": "log_mel_fused",
        "route": "cuda",
        "source": "audiossl_tpu_torch/csrc/log_mel.cu",
        "replaces": "audiossl_tpu/frontend/pallas_stft.py:442",
        "also_replaces": ["audiossl_tpu/frontend/pallas_stft.py:292"],
        "launches": launches,
        "train_launches": counts["log_mel_fused"],
        "probe_launches": probe_counts["log_mel_fused"],
        "ast_launches": ast_counts["log_mel_fused"],
        "mast_probe_launches": {mode: c["log_mel_fused"] for mode, c in mast_probe_counts.items()},
        "extract_launches": {kind: e["launches"] for kind, e in extract.items()},
        **{f"{name}_launches": c["log_mel_fused"] for name, c in slice10_counts.items()},
        **{f"{name}_launches": c["log_mel_fused"] for name, c in slice11_counts.items()},
        **{key: c["log_mel_fused"] for key, c in slice12.items()},
        **{key: c["log_mel_fused"] for key, c in slice13.items()},
        **{key: c["log_mel_fused"] for key, c in slice14.items()},
        **{key: c["log_mel_fused"] for key, c in slice15.items()},
        **{key: c["log_mel_fused"] for key, c in slice16.items()},
        "max_abs_err": kernel_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "design": fused_stft.log_mel_design(cfg),
        "design_gflop": design / 1e9,
    }]
    for name, line in (("block1_fwd", 174), ("block1_bwd_sums", 216), ("block1_bwd_weight", 235)):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "audiossl_tpu_torch/csrc/block1.cu",
            "replaces": f"audiossl_tpu/ops/block1.py:{line}",
            "launches": counts[name],
            "probe_launches": probe_counts[name],
            **{f"{objective}_launches": c[name] for objective, c in slice10_counts.items()},
            **{f"{run}_launches": c[name] for run, c in slice11_counts.items() if run != "make_pseudo_labels"},
            **{key: c[name] for key, c in slice12.items()},
            **{key: c[name] for key, c in slice13.items()},
            **{key: c[name] for key, c in slice14.items()},
            **{key: c[name] for key, c in slice15.items()},
            **{key: c[name] for key, c in slice16.items()},
            "max_abs_err": b1_err[name],
            **b1_times[name],
        })
    for name in ATTN_KERNELS:
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "audiossl_tpu_torch/csrc/attention.cu",
            "replaces": "audiossl_tpu/ops/attention.py:" + ("88" if name == "rel_attention_fwd" else "95"),
            "launches": mast_counts[name],
            "ast_launches": ast_counts[name],
            "mast_serve_launches": mast_serve["counts"][name],
            "ast_serve_launches": ast_serve["counts"][name],
            "mast_probe_launches": {mode: c[name] for mode, c in mast_probe_counts.items()},
            **{key: c[name] for key, c in slice12.items()},
            **{key: c[name] for key, c in slice13.items()},
            **{key: c[name] for key, c in slice14.items()},
            **{key: c[name] for key, c in slice15.items()},
            **{key: c[name] for key, c in slice16.items()},
            "max_abs_err": max(attn_err[name], ast_err[name], probe9_err[name], ft_attn_err[name], tp_attn_err[name]),
            "ast_tp_max_abs_err": tp_attn_err[name],
            "mast_probe_max_abs_err": probe9_err[name],
            "finetune_max_abs_err": ft_attn_err[name],
            **attn_times[name],
            "times_are": "summed over the 24 blocks of one SS-MAST step at B=64, bf16",
            "ast": ast_times[name],
            "ast_tp_per_rank": ast_tp_times[name],
        })
    for name, line in (("fused_rows_kaldi", 533), ("fused_rows_librosa", 99)):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "audiossl_tpu_torch/csrc/fused_rows.cu",
            "replaces": f"audiossl_tpu/frontend/pallas_stft.py:{line}",
            # Kaldi: the SS-MAST run; librosa: logmel_features at n_fft = 400
            "launches": mast_counts[name] if name == "fused_rows_kaldi" else dispatch["launches"],
            "mast_serve_launches": mast_serve["counts"][name],
            "ast_serve_launches": ast_serve["counts"][name],
            **{key: c[name] for key, c in slice12.items()},
            **{key: c[name] for key, c in slice13.items()},
            **{key: c[name] for key, c in slice14.items()},
            **{key: c[name] for key, c in slice15.items()},
            **{key: c[name] for key, c in slice16.items()},
            "max_abs_err": max(rows_err[name], dispatch["max_abs_err"]) if name == "fused_rows_librosa" else rows_err[name],
            **rows_t[name],
        })
    serving9 = {label: {k: v for k, v in run.items() if k != "counts"} for label, run in
                (("mast_b_fbank", mast_serve), ("ast_base_fbank", ast_serve))}
    print(json.dumps({"kernels": entries, "block1_grad_rel_err": grad_errs, "f32_step_rel_err": step_err,
                      **{f"{name}_f32_step_rel_err": e for name, e in slice10_step_err.items()},
                      **{f"{name}_f32_step_rel_err": e for name, e in slice11_step_err.items()},
                      "clustering_times": cluster_t, "pseudo_label_nmi": kmix["nmi"],
                      "ssmast_f32_step_rel_err": mast_step_err, "ast_f32_step_rel_err": ast_step_err,
                      "fbank_serving": serving9, "mast_probe_times": mast_probe_t,
                      "extract_features_err": {kind: e["max_abs_err"] for kind, e in extract.items()},
                      "finetune_f32_step_rel_err": ft_step_err, "finetune_times": ft_times,
                      "finetune_eval": {k: ft_run["stats"][k] for k in ("mAP", "AUC", "d_prime")},
                      "finetune_serving": {k: v for k, v in ft_run["serve"].items() if k != "counts"},
                      "data_parallel": {k: v for k, v in ddp.items() if not k.endswith("_per_rank")},
                      "tar_native": {k: v for k, v in tar_run.items() if k != "counts"}, "nccl_world_one": nccl,
                      "tensor_parallel": {k: v for k, v in tp.items() if not k.endswith(("_per_rank", "_launches"))},
                      "sharded_state": {k: v for k, v in shard.items() if not k.endswith(("_per_rank", "_launches"))},
                      "parallelism_library": {k: v for k, v in par.items() if not k.endswith("_launches_per_rank")}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
    return 0


def bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(v, 1e-30))) - 7)


def block1_case(shape, dtype, dev, seed, ties=False):
    """x [B, 1, F, T], weight, bias, gamma, beta (f32) and a cotangent dp.
    With ``ties``: constant patches give exact positive ties inside windows,
    and every third channel a large negative shift (windows of ReLU zeros)."""
    b, f, t = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 1, f, t)).astype(np.float32)
    if ties:
        x[:, :, : f // 2, : t // 2] = 0.75
    w = (0.3 * rng.standard_normal((64, 1, 3, 3))).astype(np.float32)
    bias, beta = (0.1 * rng.standard_normal((2, 64))).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    if ties:
        beta[::3] = -5.0
    dp = rng.standard_normal((b, 64, f // 2, t // 2)).astype(np.float32)
    t_ = lambda a, dt=torch.float32: torch.from_numpy(a).to(dev, dt)
    return t_(x, dtype), t_(w), t_(bias), t_(gamma), t_(beta), t_(dp, dtype)


def block1_checks(dev) -> tuple[dict[str, float], dict[str, float]]:
    """Each block-1 kernel against its plain version on the card, and the
    gradients of FusedBlock1 on the card against the same Function on the
    CPU (plain versions). Returns the kernels' largest |error| and the
    largest relative gradient errors by dtype."""
    from audiossl_tpu_torch.ops import block1

    cases = [
        ("[256, 1, 64, 96] f32", (256, 64, 96), torch.float32, False),
        ("[256, 1, 64, 96] bf16", (256, 64, 96), torch.bfloat16, False),
        ("[3, 1, 16, 20] f32", (3, 16, 20), torch.float32, False),
        ("[3, 1, 16, 20] bf16", (3, 16, 20), torch.bfloat16, False),
        ("[16, 1, 64, 96] f32, ties + ReLU-zero windows", (16, 64, 96), torch.float32, True),
        ("[16, 1, 64, 96] bf16, ties + ReLU-zero windows", (16, 64, 96), torch.bfloat16, True),
    ]
    errs = {"block1_fwd": 0.0, "block1_bwd_sums": 0.0, "block1_bwd_weight": 0.0}
    grad_errs = {"f32": 0.0, "bf16": 0.0}
    for i, (label, shape, dtype, ties) in enumerate(cases):
        x, w, bias, gamma, beta, dp = block1_case(shape, dtype, dev, seed=i, ties=ties)
        mean, var = block1.batch_stats(x, w, bias)
        istd = torch.rsqrt(var + block1.BN_EPS)
        a = gamma * istd
        k = [torch.full((64,), v, device=dev) for v in (1.1, -0.02, 0.003)]  # k1, k2, k3
        params = block1.pack_params(w, bias, a, beta - mean * a, *k, dtype=dtype)
        pairs = {
            "block1_fwd": (block1.block1_fwd(x, params), block1.block1_fwd_plain(x, params)),
            "block1_bwd_sums": (block1.block1_bwd_sums(x, dp, params), block1.block1_bwd_sums_plain(x, dp, params)),
            "block1_bwd_weight": (block1.block1_bwd_weight(x, dp, params), block1.block1_bwd_weight_plain(x, dp, params)),
        }
        # deterministic: each kernel run again gives the same bits
        again = {"block1_fwd": block1.block1_fwd(x, params),
                 "block1_bwd_sums": block1.block1_bwd_sums(x, dp, params),
                 "block1_bwd_weight": block1.block1_bwd_weight(x, dp, params)}
        torch.cuda.synchronize()
        for name, out in again.items():
            if not torch.equal(out, pairs[name][0]):
                raise RuntimeError(f"{name} at {label}: a second run gave other bits")
        for name, (got, want) in pairs.items():
            got, want = got.float(), want.float()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {label}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            if name == "block1_fwd":
                tol = TOL_B1_F32 * max(1.0, scale) if dtype == torch.float32 else bf16_ulp(scale)
            else:
                tol = TOL_B1_SUMS * scale
            print(f"{name} kernel vs plain, {label}: max|d| = {err:.3e} (tol {tol:.3e}, max|plain| {scale:.3e})")
            if not err <= tol:
                raise RuntimeError(f"{name} disagrees with its plain version at {label}: {err} > {tol}")
            errs[name] = max(errs[name], err)
        if i in (0, 1, 2, 4):  # gradients through the autograd Function, card against CPU
            outs = []
            for d in (dev, "cpu"):
                ps = [p.detach().to(d).requires_grad_() for p in (w, bias, gamma, beta)]
                pooled, _, _ = block1.fused_block1(x.to(d), *ps)
                pooled.backward(dp.to(d))
                outs.append([p.grad.cpu() for p in ps])
            for name, got, want in zip(("dW", "dbias", "dgamma", "dbeta"), *outs):
                # the exact dbias is 0 (bias before batch-statistics BN): its
                # round-off is held against the size of dW instead
                scale = float(want.abs().max()) if name != "dbias" else float(outs[1][0].abs().max())
                rel = float((got - want).abs().max()) / scale
                print(f"FusedBlock1 {name}, card vs CPU plain, {label}: max|d| / max|ref| = {rel:.3e} (tol {TOL_B1_GRAD})")
                if not rel <= TOL_B1_GRAD:
                    raise RuntimeError(f"FusedBlock1 {name} on the card disagrees with the CPU plain path at {label}: {rel}")
                key = "f32" if dtype == torch.float32 else "bf16"
                grad_errs[key] = max(grad_errs[key], rel)
    return errs, grad_errs


def write_manifest(pool_dir: str, wav, n_rows: int, n_labels: int | None = None) -> str:
    """16 two-second sine WAVs and a manifest of ``n_rows`` rows cycling over
    them; with ``n_labels``, a ``label`` column of ids cycling over 0 ..
    n_labels - 1."""
    t = np.arange(32000) / 16000.0
    files = []
    for i in range(16):
        f0 = 100.0 * 2 ** (i / 4)
        files.append(os.path.join(pool_dir, f"train{i}.wav"))
        wav.write_wav(files[-1], (0.4 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2.7 * f0 * t)).astype(np.float32))
    csv = os.path.join(pool_dir, "manifest.csv")
    with open(csv, "w") as f:
        if n_labels is None:
            f.write("files\n" + "".join(f"{files[r % 16]}\n" for r in range(n_rows)))
        else:
            f.write("files,label\n" + "".join(f"{files[r % 16]},{r % n_labels}\n" for r in range(n_rows)))
    return csv


def ntt_config(name: str) -> dict:
    """configs/<name>.yaml as it stands."""
    from audiossl_tpu_torch import config as cfgmod

    return cfgmod.load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", f"{name}.yaml"))


def step_model(name: str, cfg: dict, dev):
    """The model a step of ``name`` trains, seed 0, in training mode: the
    objective, or DeepCluster-v1's encoder + top layer."""
    if name == "decar_v1":
        from audiossl_tpu_torch.train.deepcluster_loop import build_net

        return build_net(cfg["pretrain"], 0, dev).train()
    from audiossl_tpu_torch.objectives import init_objective

    return init_objective(name, cfg, seed=0, device=dev).train()


def step_labels(name: str, pre: dict, b: int, rng: np.random.Generator):
    """A batch's labels for an f32 step of ``name``: UnFuSeD's and
    DeepCluster-v1's class ids, DECAR's cluster targets [heads, b] (the first
    clip's ignored, -100), else None."""
    if name == "unfused":
        return torch.from_numpy(rng.integers(0, int(pre["task_label"]), b))
    if name == "decar_v1":
        return torch.from_numpy(rng.integers(0, int(pre["num_clusters"]), b))
    if name == "decar_v2":
        heads = [int(k) for k in pre["nmb_prototypes"]]
        targets = np.stack([rng.integers(0, k, b) for k in heads])
        targets[:, 0] = -100
        return torch.from_numpy(targets)
    return None


def training_run(name, pool, wav, tmp, dev) -> dict[str, int]:
    """Pretraining of the AudioNTT objective ``name`` through train_upstream on
    its config as it stands (full width) for TRAIN_STEPS steps, counts from
    0; checks the losses, the launches per step (TRAIN_LAUNCHES; no other
    kernel), a MoCo objective's queue pointer and key encoder, and that the
    exported encoder serves. Returns the launch counts of the run."""
    from audiossl_tpu_torch import config as cfgmod
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.objectives import objective_class
    from audiossl_tpu_torch.serve.export import build_embedder
    from audiossl_tpu_torch.train.loop import train_upstream

    config = ntt_config(name)
    batch = int(config["run"]["batch_size"])
    n_labels = int(config["pretrain"]["task_label"]) if objective_class(name).labeled else None
    csv = write_manifest(tmp, wav, batch * TRAIN_STEPS, n_labels)
    config["run"].update(save_path=os.path.join(tmp, name), epochs=1)
    reset_launches()
    t0 = time.perf_counter()
    obj, step, ckpt_dir = train_upstream(config, csv, name, max_steps=TRAIN_STEPS, seed=TRAIN_SEED, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    with open(os.path.join(ckpt_dir, "stats.jsonl")) as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    d = int(config["pretrain"]["base_encoder"]["output_dim"])
    print(f"training: train_upstream {name}, B={batch}, d={d}, bf16, {step} steps in {seconds:.1f} s (set-up and "
          f"loading included); losses {losses}; launches {({k: counts[k] for k in NTT_KERNELS})}")
    if step != TRAIN_STEPS or len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{name} training took {step} steps with losses {losses}")
    expect_counts(f"training {name}, {TRAIN_STEPS} steps", counts,
                  {k: n * TRAIN_STEPS for k, n in zip(NTT_KERNELS, TRAIN_LAUNCHES[name])})
    if name in QUEUE_BATCHES:
        moco_check(name, obj, config, batch)
    sd = torch.load(os.path.join(ckpt_dir, "encoder", f"{step}.pt"), map_location="cpu", weights_only=True)
    frontend = build_frontend(config["pretrain"]["input"])
    emb = build_embedder(sd, frontend, cfgmod.clip_samples(config), torch.bfloat16, dev)
    with torch.inference_mode():
        out = emb(torch.from_numpy(pool[:SERVE_BATCH]).to(dev))
    if out.shape != (SERVE_BATCH, d) or not torch.isfinite(out).all():
        raise RuntimeError(f"the trained {name} encoder's export served {tuple(out.shape)} or non-finite values")
    print(f"training: {name}'s exported encoder/{step}.pt serves [{SERVE_BATCH}, {CLIP}] -> [{SERVE_BATCH}, {d}], finite")
    return counts


def moco_check(name, obj, config, batch) -> None:
    """After the run: the queue pointer advanced by QUEUE_BATCHES[name]
    batches a step, and the key encoder moved from where it started (the
    run's seeded initial state, rebuilt on the CPU) and differs from the
    query encoder."""
    from audiossl_tpu_torch.objectives import init_objective

    want = QUEUE_BATCHES[name] * batch * TRAIN_STEPS % obj.num_negatives
    start = init_objective(name, config, seed=TRAIN_SEED)
    with torch.no_grad():
        moved = max(float((k.cpu() - k0).abs().max())
                    for k, k0 in zip(obj.encoder_k.parameters(), start.encoder_k.parameters()))
        apart = max(float((k - q).abs().max()) for k, q in zip(obj.encoder_k.parameters(), obj.encoder.parameters()))
    print(f"training: {name} queue pointer {int(obj.queue_ptr)} (expected {want}); key encoder moved by max|d| "
          f"{moved:.3e} from its start, {apart:.3e} from the query encoder")
    if int(obj.queue_ptr) != want or not moved > 0.0 or not apart > 0.0:
        raise RuntimeError(f"{name}'s MoCo state after {TRAIN_STEPS} steps: pointer {int(obj.queue_ptr)} (expected "
                           f"{want}), key encoder moved {moved}, apart from the query encoder {apart}")


def f32_step_check(name, pool, dev, b: int = 8) -> dict[str, float]:
    """f32 steps of the AudioNTT objective ``name`` (its config, f32, dropout
    0) at full width on the card against the same steps on the CPU plain
    path, from the same weights, waves, draws (and labels), on STEP_BATCHES
    batches of ``b`` clips: the views (frontend and augmentation) are
    compared, then the loss and every gradient on the CPU's views, and a
    MoCo objective's state after the step (key encoder parameters within
    TOL_EMA, its BatchNorm statistics and the queue within TOL_F32, the
    pointer equal). At least STEP_PASS batches must pass every gradient
    bound at once (a routing flip at round-off is a chance event of a batch;
    a fault shows in all of them, or in most), the other bounds every batch.
    Then the gate is shown to refuse the card's gradients with each tensor
    of STEP_FAULTS[name] scaled by 1 + STEP_FAULT in every batch (for
    DeLoRes-S block 1's conv weight, BN scale and BN shift, and two later
    layers), and the first (block 1's conv weight) scaled so in two batches
    of three only."""
    import copy

    from audiossl_tpu_torch import no_tf32
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.train.step import prepare_views

    cfg = ntt_config(name)
    pre = cfg["pretrain"]
    pre["base_encoder"].update(compute_dtype="float32", dropout=0.0)
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    n_frames = frontend.num_frames(CLIP)
    init = step_model(name, cfg, torch.device("cpu"))
    runs = []  # per batch: view error, (loss, gradients) on the card and on the CPU
    moco_errs = []  # per batch: the key encoder's parameters, its statistics and the queue, card vs CPU
    bank_errs = []  # per batch (DECAR): view 1's embeddings, the bank's new rows, card vs CPU
    for k in range(STEP_BATCHES):
        waves = torch.from_numpy(pool[k * b:(k + 1) * b])
        labels = step_labels(name, pre, b, np.random.default_rng(7 + k))
        views = []
        for d in (dev, torch.device("cpu")):
            state = pipeline.init_state(frontend.n_mels, n_frames, d)
            draws = pipeline.sample_draws(state, b, frontend.n_mels, n_frames, torch.Generator().manual_seed(5 + k))
            draws = tuple(type(v)(*(t.to(d) if t is not None else None for t in v)) for v in draws)
            views.append(prepare_views(pipeline, frontend, "mean_var", state, waves.to(d), draws)[1:])
        view_err = max(float((c.cpu() - r).abs().max()) / max(1.0, float(r.abs().max())) for c, r in zip(*views))
        results, states, banks = [], [], []
        for d in (dev, torch.device("cpu")):
            obj = copy.deepcopy(init).to(d)
            vs, lbl = [v.to(d) for v in views[1]], None if labels is None else labels.to(d)
            with no_tf32():
                if hasattr(obj, "step_loss"):  # DECAR: the loss, and view 1's embeddings for the bank
                    loss, bank = obj.step_loss(*vs, lbl)
                    banks.append(bank.cpu())
                else:
                    loss = obj.loss(*vs, labels=lbl)
                loss.backward()
            results.append((loss.item(), {n: p.grad.cpu() for n, p in obj.named_parameters() if p.requires_grad}))
            states.append({n: v.cpu() for n, v in obj.state_dict().items() if n.startswith(("encoder_k.", "queue"))})
        runs.append((view_err, *results))
        if banks:
            bank_errs.append(float((banks[0] - banks[1]).abs().max()) / max(1.0, float(banks[1].abs().max())))
        if states[1]:
            card, cpu = states
            rel = lambda n: float((card[n].float() - cpu[n].float()).abs().max()) / max(1.0, float(cpu[n].abs().max()))
            params = {n for n, _ in init.encoder_k.named_parameters()}
            moco_errs.append({
                "key_params": max(rel(n) for n in card if n[len("encoder_k."):] in params),
                "key_stats": max(rel(n) for n in card if "running" in n),
                "queue": rel("queue"), "pointer": int(card["queue_ptr"]) - int(cpu["queue_ptr"]),
            })
    flat = lambda g: torch.cat([v.flatten() for v in g.values()])

    def errors(g, ref):
        """(all gradients in norm, {tensor: in norm}, {tensor: worst element}) of g against ref."""
        largest = max(float(v.norm()) for v in ref.values())
        scale = max(float(v.abs().max()) for v in ref.values())
        # the exactly-zero gradients (conv biases before batch-statistics BN) are
        # round-off on both sides, ~1e-7 of the largest in norm: 1e-3 of the
        # largest in norm covers them and is below every other tensor (the
        # smallest, ~7e-3, would still show a 1e-2 fault at 8.7e-3)
        norm = {n: float((g[n] - r).norm()) / (float(r.norm()) + 1e-3 * largest) for n, r in ref.items()}
        elem = {n: float((g[n] - r).abs().max()) / (float(r.abs().max()) + 1e-2 * scale) for n, r in ref.items()}
        return float((flat(g) - flat(ref)).norm() / flat(ref).norm()), norm, elem

    def gate(fault: str | None = None, spared=()) -> tuple[bool, dict]:
        """Whether STEP_PASS batches pass every gradient bound at once, with
        ``fault``'s card gradient scaled by 1 + STEP_FAULT in every batch but
        those in ``spared``; the batches' errors and the best of each bound."""
        per_batch = []
        for k, (_, (_, g_card), (_, g_cpu)) in enumerate(runs):
            if fault is not None and k not in spared:
                g_card = dict(g_card, **{fault: g_card[fault] * (1.0 + STEP_FAULT)})
            per_batch.append(errors(g_card, g_cpu))
        names = list(runs[0][2][1])
        passing = sum(1 for w, t, e in per_batch
                      if w <= TOL_STEP and max(t.values()) <= TOL_STEP and max(e.values()) <= TOL_STEP_TENSOR)
        best = {"gradients": min(w for w, _, _ in per_batch),
                "tensor_norm": {n: min(t[n] for _, t, _ in per_batch) for n in names},
                "tensor_worst": {n: min(e[n] for _, _, e in per_batch) for n in names}}
        return passing >= STEP_PASS, dict(best, per_batch=per_batch, passing=passing)

    view_errs = [r[0] for r in runs]
    loss_errs = [abs(card[0] - cpu[0]) / abs(cpu[0]) for _, card, cpu in runs]
    ok, best = gate()
    worst_tensor = max(best["tensor_norm"], key=best["tensor_norm"].get)
    print(f"f32 {name} step B={b}, {STEP_BATCHES} batches, views (log-mel kernel, RunningNorm, mixup, crop) card vs CPU: "
          f"worst max|d| / max(1, max|ref|) = {max(view_errs):.3e} (tol {TOL_F32}); losses relative, worst "
          f"{max(loss_errs):.3e} (tol {TOL_STEP_LOSS})")
    print(f"f32 {name} step per batch, gradients in norm / worst tensor in norm / worst element: "
          + "; ".join(f"{w:.2e} / {max(t.values()):.2e} / {max(e.values()):.2e}" for w, t, e in best["per_batch"]))
    print(f"f32 {name} step, the best batch for each bound: gradients in norm {best['gradients']:.3e} (tol {TOL_STEP}); "
          f"each tensor in norm, worst {worst_tensor} {best['tensor_norm'][worst_tensor]:.3e} (tol {TOL_STEP}); "
          f"worst element {max(best['tensor_worst'].values()):.3e} (tol {TOL_STEP_TENSOR}); "
          f"batches passing every bound: {best['passing']}/{STEP_BATCHES} (at least {STEP_PASS})")
    moco = {key: max(abs(e[key]) for e in moco_errs) for key in moco_errs[0]} if moco_errs else {}
    if moco:
        print(f"f32 {name} step, MoCo state after the step card vs CPU, worst of {STEP_BATCHES} batches: key encoder "
              f"parameters {moco['key_params']:.3e} (tol {TOL_EMA}), its BN statistics {moco['key_stats']:.3e} and "
              f"the queue {moco['queue']:.3e} (tol {TOL_F32}), pointers equal: {moco['pointer'] == 0}")
    moco_ok = not moco or (moco["key_params"] <= TOL_EMA and moco["key_stats"] <= TOL_F32
                           and moco["queue"] <= TOL_F32 and moco["pointer"] == 0)
    if bank_errs:
        print(f"f32 {name} step, the bank's new rows (view 1's embeddings) card vs CPU: worst of {STEP_BATCHES} "
              f"batches max|d| / max(1, max|ref|) = {max(bank_errs):.3e} (tol {TOL_F32})")
        moco["bank"] = max(bank_errs)
    bank_ok = not bank_errs or max(bank_errs) <= TOL_F32
    if not (max(view_errs) <= TOL_F32 and max(loss_errs) <= TOL_STEP_LOSS and ok and moco_ok and bank_ok):
        raise RuntimeError(f"the f32 {name} training step on the card disagrees with the CPU path: views "
                           f"{max(view_errs)}, losses {max(loss_errs)}, {best['passing']} of {STEP_BATCHES} batches "
                           f"passing every gradient bound (at least {STEP_PASS}); MoCo state or bank {moco}")
    faults = [(tensor, ()) for tensor in STEP_FAULTS[name]]
    faults.append((STEP_FAULTS[name][0], tuple(range(0, STEP_BATCHES, 3))))  # spares one batch in three
    caught = {}
    for tensor, spared in faults:
        passed, fb = gate(tensor, spared)
        where = f"in {STEP_BATCHES - len(spared)} of {STEP_BATCHES} batches" if spared else "in every batch"
        caught[f"{tensor} {where}"] = fb["passing"]
        print(f"f32 {name} step gate with the card's {tensor} gradient scaled by 1 + {STEP_FAULT} {where}: best batch "
              f"{fb['tensor_norm'][tensor]:.3e} in norm (tol {TOL_STEP}); {fb['passing']}/{STEP_BATCHES} batches "
              f"passing every bound: {'refused' if not passed else 'PASSED'}")
        if passed:
            raise RuntimeError(f"the f32 {name} step gate does not catch {tensor}'s gradient scaled by 1 + "
                               f"{STEP_FAULT} {where}")
    return {"views": max(view_errs), "loss": max(loss_errs), "gradients": best["gradients"],
            "worst_tensor_norm": best["tensor_norm"][worst_tensor], "worst_element": max(best["tensor_worst"].values()),
            "batches_passing": best["passing"], "injected_faults_batches_passing": caught, **moco}


def kernel_split(fn, iters: int = 20) -> dict[str, float]:
    """Mean device ms of each CUDA kernel that ``fn()`` launches, from
    torch.profiler over ``iters`` eager calls (each kernel's own duration,
    so the host's gaps between launches do not count); {} if the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key): e.self_device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def block1_times(dev, card, stats: bool = True) -> dict[str, dict]:
    """ms, plain_ms, library_ms and the bound of each block-1 kernel at one
    training view ([256, 1, 64, 96] bf16), each a CUDA graph replay
    (graph_ms): the kernel 20 replays, the plain version 5, the cuDNN
    composition's forward, and its backward as the graph of forward and
    backward less the forward's. Each backward pass's two launches (the
    main kernel and the ordered sum of the blocks' partials) are timed
    apart by torch.profiler (``kernel_split``). With ``stats``, also the
    batch statistics (``block1.batch_stats``, the other half of the block's
    forward) by graph replay, as ``batch_stats_ms`` of the forward."""
    import torch.nn.functional as F

    from audiossl_tpu_torch.ops import block1

    b, f, t, c = 256, 64, 96, 64
    x, w, bias, gamma, beta, dp = block1_case((b, f, t), torch.bfloat16, dev, seed=9)
    mean, var = block1.batch_stats(x, w, bias)
    istd = torch.rsqrt(var + block1.BN_EPS)
    a = gamma * istd
    k = [0.5 + 0.1 * torch.ones(c, device=dev)] * 3
    params = block1.pack_params(w, bias, a, beta - mean * a, *k, dtype=torch.bfloat16)

    # library yardstick: cuDNN bf16 conv -> batch norm -> ReLU -> max-pool, and its autograd backward
    wl, bl, gl, el = (p.clone().requires_grad_() for p in (w.to(torch.bfloat16), bias.to(torch.bfloat16), gamma, beta))

    def composition():
        y = F.conv2d(x, wl, bl, padding=1)
        y = F.batch_norm(y, None, None, gl, el, training=True)
        return F.max_pool2d(F.relu(y), 2, 2)

    def composition_fwd_bwd():
        return torch.autograd.grad(composition(), (wl, bl, gl, el), dp)

    lib_fwd = graph_ms(composition)
    lib_bwd = graph_ms(composition_fwd_bwd) - lib_fwd
    fns = {
        "block1_fwd": (lambda: block1.block1_fwd(x, params), lambda: block1.block1_fwd_plain(x, params), lib_fwd, 9),
        "block1_bwd_sums": (lambda: block1.block1_bwd_sums(x, dp, params),
                            lambda: block1.block1_bwd_sums_plain(x, dp, params), lib_bwd, 9),
        "block1_bwd_weight": (lambda: block1.block1_bwd_weight(x, dp, params),
                              lambda: block1.block1_bwd_weight_plain(x, dp, params), lib_bwd, 18),
    }
    out = {}
    pooled_bytes = 2 * b * c * (f // 2) * (t // 2)
    for name, (kernel, plain, lib_ms, macs) in fns.items():
        ms = graph_ms(kernel)
        plain_ms = graph_ms(plain, iters=5)
        # each input read once, each output written once; 2 FLOP per MAC at the bf16 rate
        out_f32 = {"block1_fwd": 0, "block1_bwd_sums": 2, "block1_bwd_weight": 10}[name]
        nbytes = 2 * b * f * t + pooled_bytes + 4 * c * (block1.N_PARAMS + out_f32)
        flops = 2.0 * macs * b * c * f * t
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib_ms}
        split = ""
        if name != "block1_fwd":
            launches = kernel_split(kernel)
            out[name]["launch_ms"] = launches
            split = ("; its launches (torch.profiler, eager): "
                     + (", ".join(f"{k} {v:.4f} ms" for k, v in launches.items()) if launches else "not measured"))
        print(f"[{card}] {name} [256, 1, 64, 96] bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms ({'forward' if name == 'block1_fwd' else 'whole backward'} of the "
              f"cuDNN conv -> batch norm -> ReLU -> max-pool composition); bound {max(t_bytes, t_ops):.4f} ms "
              f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms at the "
              f"bf16 rate, {flops / PEAK_F32 * 1e3:.4f} ms as f32 FFMA); all CUDA graph replays{split}")
    if stats:
        stats_ms = graph_ms(lambda: block1.batch_stats(x, w, bias))
        out["block1_fwd"]["batch_stats_ms"] = stats_ms
        print(f"[{card}] block1.batch_stats [256, 1, 64, 96] bf16 (plain torch: the [192, 192] Gram matrix and its "
              f"quadratic forms): {stats_ms:.4f} ms, CUDA graph replay; with the kernel the block's forward "
              f"{stats_ms + out['block1_fwd']['ms']:.4f} ms")
    return out


def train_times(name, pool, dev, card, b: int = 256) -> None:
    """train_clips_per_sec of the AudioNTT objective ``name`` at B=256, bf16,
    its config's full width, on device-resident waves (and labels): the
    median of 3 windows of 10 steps on the host clock (each window ends in
    a synchronize), the step split by CUDA events, and the device's busy
    share of 3 steps by torch.profiler."""
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.train.optim import build_optimizer, sgd_torch
    from audiossl_tpu_torch.train.step import TrainStep

    cfg = ntt_config(name)
    pre = cfg["pretrain"]
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    obj = step_model(name, cfg, dev)
    params = [p for p in obj.parameters() if p.requires_grad]
    gen = torch.Generator(dev).manual_seed(0)
    if name == "decar_v2":  # its own step: LARC, the frozen prototypes, the bank refreshed (train/decar_loop.py)
        from audiossl_tpu_torch.train.decar_loop import DecarStep

        opt, _ = build_optimizer("larc", params, float(cfg["run"]["learning_rate"]), momentum=0.9,
                                 weight_decay=1e-6, trust_coefficient=0.001, clip=False)
        n = 5 * b
        assignments = torch.randint(0, obj.nmb_prototypes[0], (1, n), generator=gen, device=dev)
        step = DecarStep(obj, pipeline, frontend, opt, gen, None, "mean_var",
                         torch.zeros((n, obj.feat_dim), device=dev), torch.full((n,), -1, device=dev), assignments)
        labels = torch.arange(b, device=dev)  # dataset indices
    elif name == "decar_v1":  # SGD lr 0.05, momentum 0.9, decay 1e-5 on the raw log-mel (train/deepcluster_loop.py)
        step = TrainStep(obj, pipeline, frontend, sgd_torch(params, 0.05, 0.9, 1e-5), gen, None, "none")
        labels = torch.randint(0, int(pre["num_clusters"]), (b,), generator=gen, device=dev)
    else:
        step = TrainStep(obj, pipeline, frontend, sgd_torch(params, 0.03), gen)
        labels = torch.from_numpy(np.arange(b) % int(pre["task_label"])).to(dev) if obj.labeled else None
    state = pipeline.init_state(frontend.n_mels, frontend.num_frames(CLIP), dev)
    waves = torch.from_numpy(pool[:b]).to(dev)
    for _ in range(3):
        state, loss = step(state, waves, labels)
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(10):
            state, loss = step(state, waves, labels)
        torch.cuda.synchronize()
        rates.append(10 * b / (time.perf_counter() - t0))
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"{name} training loss became {loss.item()}")
    parts = {"frontend+augment": 0.0, "forward+backward": 0.0, "optimizer": 0.0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(10):
        ev[0].record()
        state, v1, v2 = step.views(state, waves)
        ev[1].record()
        step.loss_and_grads(v1, v2, labels)
        ev[2].record()
        step.update()
        ev[3].record()
        torch.cuda.synchronize()
        for part, e0, e1 in zip(parts, ev[:3], ev[1:]):
            parts[part] += e0.elapsed_time(e1) / 10
    print(f"[{card}] training {name} B={b} bf16 d={pre['base_encoder']['output_dim']}: train_clips_per_sec "
          f"{float(np.median(rates)):.1f} (median of windows {[round(r, 1) for r in rates]}); step split "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))

    # device time by kernel over 3 steps, and the device's busy share of the
    # window's host-clock time (the profiler's own overhead included)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state, loss = step(state, waves, labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us = device_kernels_us(prof.key_averages())
    busy = sum(kernels_us.values())
    if not busy:
        print(f"[{card}] training {name} profile: no device time recorded (not measured)")
        return
    aten = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")) / 3
    print(f"[{card}] training {name} profile, 3 steps: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"({busy / wall_us:.1%}); {len(kernels_us)} kernels, {aten:.0f} aten calls a step; by device time per step:")
    for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 3e3:9.4f} ms  {us / busy:6.1%}  {name[:110]}")


# ---------------------------------------------------------------- SS-MAST (MViTv2-B)

MAST_CLIP = 160000  # 10 s at 16 kHz (configs/ssmast.yaml)
MAST_BATCH = 64
# MAST-B's attention at B = 64, two views in one pass (128 clips): (BH, Lq,
# key grid) and the blocks of one pass that run it (24 in all)
MAST_ATTN = (
    ((128, 1212, (26, 3)), 2), ((256, 306, (51, 6)), 1), ((256, 306, (26, 3)), 2), ((512, 78, (51, 6)), 1),
    ((512, 78, (26, 3)), 15), ((1024, 26, (26, 3)), 1), ((1024, 26, (13, 2)), 2),
)
ATTN_KERNELS = ("rel_attention_fwd", "rel_attention_bwd_dq", "rel_attention_bwd_dkv")
# attention kernels vs plain: f32 relative to max(1, max|plain|) (both sum in
# f32, in other orders); bf16 in ulps of max|plain| (p and ds are rounded to
# bf16 on both sides, and a sum-order difference can move a rounding)
TOL_ATT_F32, TOL_ATT_GRAD_F32 = 1e-5, 1e-4
TOL_ATT_BF16_ULPS, TOL_ATT_GRAD_BF16_ULPS = 2, 4
# f32 SS-MAST step (MAST tiny, B=4), card vs CPU on the same views: the loss,
# relative; each gradient tensor to 1e-3 of its own max|ref| + 1e-5 of the
# largest gradient (the CPU parity test's bound against JAX)
TOL_MAST_LOSS, TOL_MAST_GRAD = 1e-5, 1e-3


def ssmast_config() -> dict:
    """configs/ssmast.yaml as it stands, the slice's path."""
    from audiossl_tpu_torch import config as cfgmod

    return cfgmod.load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "ssmast.yaml"))


def attention_case(bh, lq, grid, lk, d, dtype, dev, seed):
    """q, k, v, bias (None without a key grid) and a cotangent dO."""
    r = np.random.default_rng(seed)
    lk = grid[0] * grid[1] if grid else lk
    t = lambda *shape, s=1.0: torch.from_numpy((s * r.standard_normal(shape)).astype(np.float32)).to(dev, dtype)
    bias = t(bh, lq, grid[0] + grid[1], s=0.5) if grid else None
    return t(bh, lq, d), t(bh, lk, d), t(bh, lk, d), bias, t(bh, lq, d)


def check_attention(label, bh, lq, grid, lk, d, dtype, dev, seed, errs, twice=False) -> None:
    """The three attention kernels against their plain versions on one case
    (the dk/dv kernel on the kernel's own row statistics), within the
    TOL_ATT_* bounds; with ``twice``, a second run must give the same bits.
    The largest |error| of each kernel goes into ``errs``."""
    from audiossl_tpu_torch.ops import attention as A

    q, k, v, bias, do = attention_case(bh, lq, grid, lk, d, dtype, dev, seed=seed)
    scale = d**-0.5
    qs = A.scale_q(q, scale)
    runs = []
    for _ in range(2 if twice else 1):
        out = A.rel_attention_fwd(qs, k, v, bias, grid)
        dq, dbias, stats = A.rel_attention_bwd_dq(qs, k, v, bias, grid, scale, do)
        dk, dv = A.rel_attention_bwd_dkv(qs, k, v, bias, grid, do, stats)
        torch.cuda.synchronize()
        runs.append([out, dq, dk, dv, stats] + ([dbias] if grid else []))
    if twice:
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        print(f"determinism {label} {str(dtype)[6:]}: forward, dq, dk/dv equal bits on a second run: {same}")
        if not same:
            raise RuntimeError(f"an attention kernel gave other bits on a second run at {label} {dtype}")
    out, dq, dk, dv, stats = runs[0][:5]
    dbias = runs[0][5] if grid else None
    want_dq, want_dbias, want_stats = A.attention_bwd_dq_plain(qs, k, v, bias, grid, scale, do)
    want_dk, want_dv = A.attention_bwd_dkv_plain(qs, k, v, bias, grid, do, stats)  # the kernel's own inputs
    pairs = [("rel_attention_fwd", "out", out, A.attention_fwd_plain(qs, k, v, bias, grid)),
             ("rel_attention_bwd_dq", "dq", dq, want_dq), ("rel_attention_bwd_dkv", "dk", dk, want_dk),
             ("rel_attention_bwd_dkv", "dv", dv, want_dv)]
    if grid:
        pairs.append(("rel_attention_bwd_dq", "dbias", dbias, want_dbias))
    torch.cuda.synchronize()
    stat_err = float((stats - want_stats).abs().max() / want_stats.abs().max())
    if not stat_err <= 1e-5:
        raise RuntimeError(f"rel_attention_bwd_dq's row statistics disagree at {label} {dtype}: {stat_err}")
    for name, what, got, want in pairs:
        got, want = got.float(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"{name} {what} {label}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
        err, ref = float((got - want).abs().max()), float(want.abs().max())
        grad = what != "out"
        if dtype == torch.float32:
            tol = (TOL_ATT_GRAD_F32 if grad else TOL_ATT_F32) * max(1.0, ref)
        else:
            tol = (TOL_ATT_GRAD_BF16_ULPS if grad else TOL_ATT_BF16_ULPS) * bf16_ulp(ref)
        print(f"{name} {what} kernel vs plain, {label} {str(dtype)[6:]}: max|d| = {err:.3e} "
              f"(tol {tol:.3e}, max|plain| {ref:.3e})")
        if not err <= tol:
            raise RuntimeError(f"{name} ({what}) disagrees with its plain version at {label} {dtype}: {err} > {tol}")
        errs[name] = max(errs[name], err)


def attention_checks(dev) -> dict[str, float]:
    """The three attention kernels against their plain versions, f32 and
    bf16, at two MAST-B shapes, a ragged one and the no-bias mode (AST)."""
    cases = [
        ("MAST-B block 0 [128, 1212, 78] 26x3", 128, 1212, (26, 3), None, 96),
        ("MAST-B block 2 [256, 306, 306] 51x6", 256, 306, (51, 6), None, 96),
        ("ragged [3, 37, 33] 3x11", 3, 37, (3, 11), None, 96),
        ("no bias [6, 600, 130] D=64", 6, 600, None, 130, 64),
    ]
    errs = dict.fromkeys(ATTN_KERNELS, 0.0)
    for i, (label, bh, lq, grid, lk, d) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(label, bh, lq, grid, lk, d, dtype, dev, i, errs)
    return errs


def rows_checks(dev) -> dict[str, float]:
    """The dense-rows kernel against its plain version: Kaldi mode at the
    SS-MAST batch [64, 160000], librosa mode at the serving batch [256, 15200]."""
    from audiossl_tpu_torch.frontend import fused_stft
    from audiossl_tpu_torch.frontend.fbank import kaldi_fbank
    from audiossl_tpu_torch.frontend.stft import log_mel

    rng = np.random.default_rng(11)
    errs = {}
    for name, fn, plain, shape in (("fused_rows_kaldi", fused_stft.kaldi_fbank_fused, kaldi_fbank, (MAST_BATCH, MAST_CLIP)),
                                   ("fused_rows_librosa", fused_stft.log_mel_dense_fused, log_mel, (SERVE_BATCH, CLIP))):
        w = torch.from_numpy((0.5 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        got, want = fn(w), plain(w)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
        errs[name] = float((got - want).abs().max())
        print(f"{name} kernel vs plain, {list(shape)}: max|d| = {errs[name]:.3e} (tol {TOL_KERNEL})")
        if not errs[name] <= TOL_KERNEL:
            raise RuntimeError(f"{name} disagrees with its plain version: {errs[name]}")
    return errs


def dispatcher_check(dev) -> dict:
    """logmel_features, the serving frontend's log-mel, on a config that is
    not ct_eligible (n_fft = 400): on the card it must launch the rows kernel
    in librosa mode exactly once (its dense design, as 400 is no power of
    two), the log-mel kernel never, and match the plain log_mel."""
    from audiossl_tpu_torch.frontend import fused_stft, logmel_features
    from audiossl_tpu_torch.frontend.stft import LogMelConfig, log_mel

    cfg = LogMelConfig(n_fft=400, hop=160)
    w = torch.from_numpy((0.5 * np.random.default_rng(13).standard_normal((64, CLIP))).astype(np.float32)).to(dev)
    fused_stft.fused_rows.launches.update(dict.fromkeys(fused_stft.ROW_MODES, 0))
    fused_stft.log_mel_fused.launches = 0
    got = logmel_features(w, cfg)
    torch.cuda.synchronize()
    counts, log_mel_launches = dict(fused_stft.fused_rows.launches), fused_stft.log_mel_fused.launches
    want = log_mel(w, cfg)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"logmel_features at n_fft=400: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    err = float((got - want).abs().max())
    print(f"dispatcher: logmel_features, LogMelConfig(n_fft=400, hop=160), [64, {CLIP}] on the card: rows kernel "
          f"launches {counts}, log-mel kernel launches {log_mel_launches}; max|d| vs plain = {err:.3e} (tol {TOL_KERNEL})")
    if counts != {"kaldi": 0, "librosa": 1} or log_mel_launches != 0:
        raise RuntimeError(f"logmel_features at n_fft=400 did not launch the rows kernel once: {counts}, {log_mel_launches}")
    if not err <= TOL_KERNEL:
        raise RuntimeError(f"logmel_features at n_fft=400 disagrees with the plain log_mel: {err}")
    return {"launches": counts["librosa"], "max_abs_err": err}


def attention_determinism(dev) -> None:
    """Each attention kernel twice on the same bf16 inputs at two MAST-B
    shapes (the dk/dv kernel splits its query rows at the first): the bits
    must be equal."""
    from audiossl_tpu_torch.ops import attention as A

    for bh, lq, grid in ((128, 1212, (26, 3)), (256, 306, (51, 6))):
        d = 96
        q, k, v, bias, do = attention_case(bh, lq, grid, None, d, torch.bfloat16, dev, seed=bh + lq)
        qs = A.scale_q(q, d**-0.5)
        outs = [A.rel_attention_fwd(qs, k, v, bias, grid) for _ in range(2)]
        first = A.rel_attention_bwd_dq(qs, k, v, bias, grid, d**-0.5, do)
        second = A.rel_attention_bwd_dq(qs, k, v, bias, grid, d**-0.5, do)
        kv = [A.rel_attention_bwd_dkv(qs, k, v, bias, grid, do, first[2]) for _ in range(2)]
        torch.cuda.synchronize()
        same_out = torch.equal(*outs)
        same_dq = all(torch.equal(a, b) for a, b in zip(first, second))
        same_dkv = all(torch.equal(a, b) for a, b in zip(*kv))
        print(f"determinism [{bh}, {lq}, {grid[0] * grid[1]}] bf16: out equal bits {same_out}, dq/dbias/stats equal "
              f"bits {same_dq}, dk/dv equal bits {same_dkv}")
        if not (same_out and same_dq and same_dkv):
            raise RuntimeError(f"an attention kernel gave other bits on a second run at [{bh}, {lq}]")


def ssmast_wavs(tmp: str, wav, n_rows: int) -> str:
    """16 synthetic 10.5 s WAVs (two sines in noise) and a manifest of
    ``n_rows`` rows cycling over them."""
    rng = np.random.default_rng(21)
    t = np.arange(int(10.5 * 16000)) / 16000.0
    files = []
    for i in range(16):
        f0 = 90.0 * 2 ** (i / 3)
        x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 3.3 * f0 * t) + 0.02 * rng.standard_normal(t.size)
        files.append(os.path.join(tmp, f"mast{i}.wav"))
        wav.write_wav(files[-1], x.astype(np.float32))
    csv = os.path.join(tmp, "mast.csv")
    with open(csv, "w") as f:
        f.write("files\n" + "".join(f"{files[r % 16]}\n" for r in range(n_rows)))
    return csv


def ssmast_training_run(tmp: str, wav, dev) -> dict[str, int]:
    """SS-MAST pretraining through train_upstream at the config's full width
    (MViTv2-B, 128 x 1024 fbank, B=64, bf16, queue 65536 x 256) for
    TRAIN_STEPS steps; checks the losses, the launches per step and that the
    exported MAST trunk embeds. Returns the launch counts of the run."""
    from audiossl_tpu_torch.frontend import build_frontend, fused_stft
    from audiossl_tpu_torch.models.convert import mvit_reference_layout
    from audiossl_tpu_torch.models.mast import MASTEncoder, mast_config
    from audiossl_tpu_torch.ops import attention as A
    from audiossl_tpu_torch.train.loop import train_upstream

    config = ssmast_config()
    batch = int(config["run"]["batch_size"])
    csv = ssmast_wavs(tmp, wav, batch * TRAIN_STEPS)
    config["run"].update(save_path=os.path.join(tmp, "ssmast"), epochs=1)
    wrappers = {name: getattr(A, name) for name in ATTN_KERNELS}
    for fn in wrappers.values():
        fn.launches = 0
    fused_stft.fused_rows.launches.update(dict.fromkeys(fused_stft.ROW_MODES, 0))
    t0 = time.perf_counter()
    _, step, ckpt_dir = train_upstream(config, csv, "ssmast", max_steps=TRAIN_STEPS, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    counts.update({f"fused_rows_{mode}": n for mode, n in fused_stft.fused_rows.launches.items()})
    with open(os.path.join(ckpt_dir, "stats.jsonl")) as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    print(f"training: train_upstream ssmast, MViTv2-B, B={batch}, 128 x 1024 fbank, bf16, "
          f"{step} steps in {seconds:.1f} s (set-up, loading and the checkpoint included); losses {losses}; "
          f"launches {counts}")
    if step != TRAIN_STEPS or len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"SS-MAST training took {step} steps with losses {losses}")
    depth = mast_config(config["pretrain"]["model_size"]).depth  # 24 for MViTv2-B
    # per step: one fbank; the forward in every block of the query and the key
    # pass; each backward kernel in every block of the query pass
    per_step = {"fused_rows_kaldi": 1, "rel_attention_fwd": 2 * depth, "rel_attention_bwd_dq": depth,
                "rel_attention_bwd_dkv": depth, "fused_rows_librosa": 0}
    for name, n in per_step.items():
        if counts[name] != n * TRAIN_STEPS:
            raise RuntimeError(f"{name} launched {counts[name]} times in {TRAIN_STEPS} steps, expected {n} per step")
    sd = torch.load(os.path.join(ckpt_dir, "encoder", f"{step}.pt"), map_location="cpu", weights_only=True)
    inp = config["pretrain"]["input"]
    trunk = MASTEncoder(inp["n_mels"], inp["target_length"], config["pretrain"]["model_size"],
                        compute_dtype=torch.bfloat16).to(dev).eval()
    trunk.load_state_dict(mvit_reference_layout(sd))
    frontend = build_frontend(config["pretrain"]["input"])
    waves = torch.from_numpy(np.stack([wav.load_wave(os.path.join(tmp, f"mast{i}.wav"))[:MAST_CLIP] for i in range(8)])).to(dev)
    with torch.inference_mode():
        z = trunk(frontend(waves)[:, None])
    if z.shape != (8, 768) or not torch.isfinite(z).all():
        raise RuntimeError(f"the exported MAST trunk gave {tuple(z.shape)} or non-finite embeddings")
    print(f"training: exported encoder/{step}.pt (the MAST trunk, reference layout) embeds 8 clips -> [8, 768], finite")
    return counts


def ssmast_f32_step_check(dev) -> dict[str, float]:
    """One f32 SS-MAST step (MAST tiny, 64 x 96 views, B=4, drop path 0) on
    the card against the same step on the CPU's plain
    path, from the same weights, queue and views: the loss and every query
    gradient. To show the CPU's own sensitivity, its gradients are also taken
    on the views changed by 1e-6 relative."""
    import copy

    from audiossl_tpu_torch.objectives import init_objective

    cfg = ssmast_config()
    cfg["pretrain"].update(model_size="tiny", droppath_rate=0.0, compute_dtype="f32")
    cfg["pretrain"]["input"].update(n_mels=64, target_length=96)
    init = init_objective("ssmast", cfg, seed=0).train()
    rng = np.random.default_rng(31)
    views = [torch.from_numpy(rng.standard_normal((4, 1, 64, 96)).astype(np.float32)) for _ in range(2)]
    noise = torch.Generator().manual_seed(7)
    noisy = [v * (1.0 + 1e-6 * torch.randn(v.shape, generator=noise)) for v in views]
    results = []
    for d, vs in ((dev, views), (torch.device("cpu"), views), (torch.device("cpu"), noisy)):
        obj = copy.deepcopy(init).to(d)
        loss = obj.loss(*(v.to(d) for v in vs))
        loss.backward()
        results.append((loss.item(), {n: p.grad.cpu() for n, p in obj.encoder.named_parameters()}))
    (loss_card, g_card), (loss_cpu, g_cpu), (_, g_noisy) = results
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    largest = max(float(g.abs().max()) for g in g_cpu.values())

    def compare(g):  # per tensor |d| / (max|ref| + 1e-2 * largest), and all of them in norm
        rels = {n: float((g[n] - ref).abs().max()) / (float(ref.abs().max()) + 1e-2 * largest) for n, ref in g_cpu.items()}
        flat = lambda gs: torch.cat([v.flatten() for v in gs.values()])
        return rels, float((flat(g) - flat(g_cpu)).norm() / flat(g_cpu).norm())

    rels, norm_err = compare(g_card)
    noise_rels, noise_norm = compare(g_noisy)
    worst = max(rels, key=rels.get)
    print(f"f32 SS-MAST step (MAST tiny, B=4), the CPU alone on its views changed by 1e-6 relative: gradients move "
          f"{noise_norm:.3e} in norm, the worst tensor {max(noise_rels.values()):.3e}")
    print(f"f32 SS-MAST step, card vs CPU plain path on the same views: loss {loss_card:.7e} vs {loss_cpu:.7e} "
          f"(relative {loss_err:.3e}, tol {TOL_MAST_LOSS}); gradients {norm_err:.3e} in norm; worst tensor {worst} "
          f"{rels[worst]:.3e} (tol {TOL_MAST_GRAD})")
    if not (loss_err <= TOL_MAST_LOSS and rels[worst] <= TOL_MAST_GRAD):
        raise RuntimeError(f"the f32 SS-MAST step on the card disagrees with the CPU path: {loss_err}, {rels[worst]}")
    return {"loss": loss_err, "gradients_norm": norm_err, "worst_tensor": rels[worst],
            "cpu_1e-6_views_gradients": noise_norm, "cpu_1e-6_views_worst_tensor": max(noise_rels.values())}


def attention_bound(kind: str, bh: int, lq: int, lk: int, d: int, kb: int, esize: int) -> tuple[float, float, float]:
    """(bound ms, bytes ms, operations ms) of one attention function: each
    input read once, each output written once; the products the function
    needs at the bf16 tensor rate (2 FLOP per MAC; the forward q k^T and
    p v; dq + dbias: q k^T, dO v^T, ds k; dk + dv: q k^T, dO v^T, ds^T q, p^T dO)."""
    q, kv, b = bh * lq * d, bh * lk * d, bh * lq * kb
    if kind == "rel_attention_fwd":
        nbytes, matmuls = esize * (2 * q + 2 * kv + b), 2
    elif kind == "rel_attention_bwd_dq":
        nbytes, matmuls = esize * (3 * q + 2 * kv + 2 * b) + 12 * bh * lq, 3
    else:
        nbytes, matmuls = esize * (2 * q + 4 * kv + b) + 12 * bh * lq, 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = matmuls * 2.0 * bh * lq * lk * d / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def attention_times(dev, card) -> dict[str, dict]:
    """Each attention kernel at each MAST-B shape (bf16, the path's dtype),
    its plain version and the library yardstick (scaled_dot_product_attention
    with the float mask bias E, forward; its autograd backward for the two
    backward kernels: the graph of forward and backward less the forward's),
    per launch and summed over one training step. Each is timed as a CUDA
    graph (graph_ms), so that the host's launch gaps drop out."""
    import torch.nn.functional as F

    from audiossl_tpu_torch.ops import attention as A

    step = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, library_ms=0.0) for name in ATTN_KERNELS}
    for (bh, lq, grid), blocks in MAST_ATTN:
        lk, d = grid[0] * grid[1], 96
        q, k, v, bias, do = attention_case(bh, lq, grid, None, d, torch.bfloat16, dev, seed=lq + lk)
        qs = A.scale_q(q, d**-0.5)
        _, _, stats = A.rel_attention_bwd_dq(qs, k, v, bias, grid, d**-0.5, do)
        # the plain versions take E on the card: a host-to-device copy cannot be captured
        e = torch.from_numpy(A.rel_expand_matrix(*grid)).to(dev)
        mask = torch.matmul(bias, e.to(torch.bfloat16))
        ql, kl, vl, ml = (t.clone().requires_grad_() for t in (q, k, v, mask))

        def library_fwd_bwd():
            out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ml, scale=d**-0.5)
            return torch.autograd.grad(out, (ql, kl, vl, ml), do)

        lib_fwd = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=d**-0.5))
        lib_bwd = graph_ms(library_fwd_bwd) - lib_fwd
        fns = {
            "rel_attention_fwd": (lambda: A.rel_attention_fwd(qs, k, v, bias, grid),
                                  lambda: A.attention_fwd_plain(qs, k, v, bias, e), lib_fwd, 2 * blocks),
            "rel_attention_bwd_dq": (lambda: A.rel_attention_bwd_dq(qs, k, v, bias, grid, d**-0.5, do),
                                     lambda: A.attention_bwd_dq_plain(qs, k, v, bias, e, d**-0.5, do), lib_bwd, blocks),
            "rel_attention_bwd_dkv": (lambda: A.rel_attention_bwd_dkv(qs, k, v, bias, grid, do, stats),
                                      lambda: A.attention_bwd_dkv_plain(qs, k, v, bias, e, do, stats), lib_bwd, blocks),
        }
        for name, (kernel, plain, lib_ms, per_step) in fns.items():
            ms, plain_ms = graph_ms(kernel), graph_ms(plain, iters=5)
            bound, t_bytes, t_ops = attention_bound(name, bh, lq, lk, d, sum(grid), 2)
            print(f"[{card}] {name} [{bh}, {lq}, {lk}] {grid[0]}x{grid[1]} bf16, {per_step} a step: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms; bound {bound:.4f} ms (bytes {t_bytes:.4f}, "
                  f"products {t_ops:.4f} at the bf16 rate, {t_ops * PEAK_BF16 / PEAK_F32:.4f} as f32 FFMA)")
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound), ("bytes_ms", t_bytes),
                             ("ops_ms", t_ops), ("library_ms", lib_ms)):
                step[name][key] += per_step * val
    out = {}
    for name, st in step.items():
        print(f"[{card}] {name}, summed over one SS-MAST step (B=64): kernel {st['ms']:.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms, library {st['library_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms")
        out[name] = {"ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                     "bound_by": "operations" if st["ops_ms"] >= st["bytes_ms"] else "bytes", "library_ms": st["library_ms"]}
    return out


def rows_times(dev, card) -> dict[str, dict]:
    """The rows kernel on prepared frame rows in both modes, its plain
    version and a torch.fft.rfft composition of the same function (the
    library yardstick), each a CUDA graph replay (graph_ms): Kaldi at
    [64, 160000], librosa at [256, 15200]."""
    from audiossl_tpu_torch import no_tf32
    from audiossl_tpu_torch.frontend import fbank, fused_stft
    from audiossl_tpu_torch.frontend.stft import EPS32, EPS64, LogMelConfig, frame_signal

    rng = np.random.default_rng(12)
    out = {}
    kcfg, lcfg = fbank.FbankConfig(), LogMelConfig()
    w = torch.from_numpy((0.5 * rng.standard_normal((MAST_BATCH, MAST_CLIP))).astype(np.float32)).to(dev)
    kframes = fbank.frame_rows(w, kcfg).reshape(-1, kcfg.window_size).contiguous()
    w = torch.from_numpy((0.5 * rng.standard_normal((SERVE_BATCH, CLIP))).astype(np.float32)).to(dev)
    lframes = frame_signal(w, lcfg.n_fft, lcfg.hop, lcfg.center).reshape(-1, lcfg.n_fft).contiguous()
    for name, mode, cfg, frames in (("fused_rows_kaldi", "kaldi", kcfg, kframes),
                                    ("fused_rows_librosa", "librosa", lcfg, lframes)):
        c = fused_stft._rows_constants(cfg, frames.device)
        nfft = c.n

        def library(frames=frames, c=c, mode=mode):
            spec = torch.fft.rfft(frames * c.window, n=c.n)
            power = spec.real.square() + spec.imag.square()
            if mode == "kaldi":
                return torch.log(torch.clamp_min(power @ c.mel_t, EPS32))
            return torch.log((power + EPS64) @ c.mel_t + EPS32)

        with no_tf32():
            lib_err = float((library() - fused_stft.fused_rows_plain(frames, c.bank, c.mel_t, mode)).abs().max())
            ms = graph_ms(lambda: fused_stft.fused_rows(frames, cfg, mode))
            plain_ms = graph_ms(lambda: fused_stft.fused_rows_plain(frames, c.bank, c.mel_t, mode), iters=5)
            library_ms = graph_ms(library)
        rows, width = frames.shape
        n_bins, n_mels = c.mel_t.shape
        nnz = int(torch.count_nonzero(c.mel_t))
        flops = rows * (width + 2.5 * nfft * math.log2(nfft) + 3 * n_bins + 2 * nnz + 2 * n_mels)
        nbytes = 4 * rows * (width + n_mels)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
        print(f"[{card}] {name} [{rows}, {width}] rows, {nfft}-point FFT design: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (torch.fft.rfft composition) {library_ms:.4f} ms (max|d| vs plain "
              f"{lib_err:.2e}); bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
              f"function {flops / 1e9:.3f} GFLOP -> {t_ops:.4f} ms); all CUDA graph replays")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": library_ms}
    return out


def ssmast_step(dev):
    """(TrainStep, augmentation state, generator) of SS-MAST at the config's
    full width."""
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.train.optim import build_optimizer
    from audiossl_tpu_torch.train.step import TrainStep

    config = ssmast_config()
    pre = config["pretrain"]
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    obj = init_objective("ssmast", config, seed=0, device=dev).train()
    opt, _ = build_optimizer("adamw", [p for p in obj.parameters() if p.requires_grad], 3e-4, weight_decay=0.0)
    gen = torch.Generator(dev).manual_seed(0)
    step = TrainStep(obj, pipeline, frontend, opt, gen, None, "precomputed")
    return step, pipeline.init_state(frontend.n_mels, frontend.num_frames(MAST_CLIP), dev), gen


def clips_per_sec(step, state, waves, windows: int = 3, steps: int = 4) -> tuple[list[float], object]:
    """Host-clock clips/s of ``windows`` windows of ``steps`` steps, each
    ending in a synchronize, after 2 warm-up steps."""
    for _ in range(2):
        state, loss = step(state, waves)
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step(state, waves)
        torch.cuda.synchronize()
        rates.append(steps * waves.shape[0] / (time.perf_counter() - t0))
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"SS-MAST training loss became {loss.item()}")
    return rates, state


def ssmast_train_times(dev, card, pool) -> None:
    """train_clips_per_sec of SS-MAST at B=64, bf16, full width, on waves
    already on the card: the median of 3 windows of 4 steps on the host
    clock; then the step split by CUDA events (mean of 4 steps); the
    profiler's busy share."""
    from audiossl_tpu_torch.objectives.delores_m import info_nce, queue_update
    from audiossl_tpu_torch.ops.stats import l2_normalize

    reps = -(-MAST_BATCH * MAST_CLIP // pool.size)
    waves = torch.from_numpy(np.resize(np.tile(pool.ravel(), reps), (MAST_BATCH, MAST_CLIP))).to(dev)
    step, state, gen = ssmast_step(dev)
    rates, state = clips_per_sec(step, state, waves)
    obj, opt = step.objective, step.optimizer
    names = ("frontend+augment", "EMA + query forward", "key forward", "loss + queue", "query backward", "AdamW")
    parts = dict.fromkeys(names, 0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    b, tau = MAST_BATCH, obj.temperature
    for _ in range(4):
        ev[0].record()
        state, v1, v2 = step.views(state, waves)
        ev[1].record()
        m = obj.momentum()
        obj._ema_(m)
        obj._ema_(m)
        q12 = l2_normalize(obj.encoder(torch.cat([v1, v2]), gen), dim=1)
        ev[2].record()
        k21 = obj._keys(torch.cat([v2, v1]), gen)
        ev[3].record()
        total = info_nce(q12[:b], k21[:b], obj.queue, tau)
        queue, ptr = queue_update(obj.queue, obj.queue_ptr, k21[:b])
        total = total + info_nce(q12[b:], k21[b:], queue, tau)
        obj.queue, obj.queue_ptr = queue_update(queue, ptr, k21[b:])
        obj.step.add_(1)
        ev[4].record()
        opt.zero_grad(set_to_none=True)
        total.backward()
        ev[5].record()
        opt.step()
        ev[6].record()
        torch.cuda.synchronize()
        for name, e0, e1 in zip(names, ev[:-1], ev[1:]):
            parts[name] += e0.elapsed_time(e1) / 4
    print(f"[{card}] SS-MAST training B={MAST_BATCH} bf16 MViTv2-B 128 x 1024: train_clips_per_sec "
          f"{float(np.median(rates)):.1f} (median of windows {[round(r, 1) for r in rates]}); step split "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f"; query forward + backward {parts['EMA + query forward'] + parts['query backward']:.4f} ms")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, loss = step(state, waves)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us = device_kernels_us(prof.key_averages())
    busy = sum(kernels_us.values())
    if not busy:
        print(f"[{card}] SS-MAST training profile: no device time recorded (not measured)")
        return
    print(f"[{card}] SS-MAST training profile, 2 steps: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"({busy / wall_us:.1%}); {len(kernels_us)} kernels; by device time per step:")
    for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 2e3:9.4f} ms  {us / busy:6.1%}  {name[:110]}")


# ---------------------------------------------------------------- the build's ptxas report


def kernel_label(name: str, pattern: str) -> str:
    """A readable name of a mangled kernel name: the function whose name
    matches ``pattern``, with its template arguments (dtype, ints, bools)."""
    # the mangled name: length, name, template arguments; in an anonymous namespace
    # the length follows the file's 8-digit hash (_cu_<hash><length><name>)
    m = re.search(rf"_cu_[0-9a-f]{{8}}(\d+)({pattern})", name) or re.search(rf"(\d+)({pattern})", name)
    if not m:
        return name
    n = int(m.group(1))
    kname, tail = m.group(2)[:n], name[m.start(2) + n:]
    tmpl = tail.split("Ev")[0] if tail.startswith("I") else ""
    args = (["bf16"] if "bfloat16" in tmpl else ["f32"] if tmpl.startswith("If") else [])
    args += re.findall(r"Li(\d+)E", tmpl) + [("false", "true")[int(v)] for v in re.findall(r"Lb(\d)E", tmpl)]
    return f"{kname}<{','.join(args)}>" if args else kname


def ptxas_check(kernels) -> None:
    """Registers and spills of every attention and block-1 kernel
    instantiation, from ptxas's report of each library's build; any spill
    fails the run."""
    spilled = []
    for source, pattern in (("attention", r"attn_\w+"), ("block1", r"block1_\w+|reduce_partials_kernel")):
        report = kernels.ptxas_report(kernels.build_log(source))
        if not report:
            raise RuntimeError(f"no ptxas report of {source}.cu's build")
        rows = []
        for name, r in report.items():
            label = kernel_label(name, pattern)
            rows.append(f"{label} {r.get('registers')} regs, {r.get('spill_stores', 0)}/{r.get('spill_loads', 0)} B spilled")
            if r.get("spill_stores") or r.get("spill_loads"):
                spilled.append(f"{source}.cu {label}")
        print(f"ptxas, {source}.cu ({len(report)} kernels): " + "; ".join(rows))
    if spilled:
        raise RuntimeError(f"kernels spill registers: {spilled}")


# ---------------------------------------------------------------- the downstream probe and AST-base (slice 6)

AST_CLIP = 163840  # 10.24 s at 16 kHz: 1025 log-mel frames, AST-base's 101 x 12 patches + cls + dist = 1214 tokens
AST_BATCH = 32  # configs/downstream.yaml's run.batch_size
AST_SHAPE = (384, 1214, 64)  # the attention of one AST-base block at B=32: 12 heads of 64
AST_DEPTH = 12  # attention launches of each kernel per step (blocks)
# f32 AST-tiny step, card vs CPU: the MAST-tiny check's bounds
TOL_AST_LOSS, TOL_AST_GRAD = TOL_MAST_LOSS, TOL_MAST_GRAD


def write_labelled(tmp: str, name: str, files: list[str], labels: list[str], n_train: int, n_test: int) -> tuple[str, str]:
    """``wav,label`` train and test CSVs of ``n_train`` and ``n_test`` rows
    cycling over the files."""
    paths = []
    for split, n in (("train", n_train), ("test", n_test)):
        paths.append(os.path.join(tmp, f"{name}_{split}.csv"))
        with open(paths[-1], "w") as f:
            f.write("wav,label\n" + "".join(f"{files[r % len(files)]},{labels[r % len(files)]}\n" for r in range(n)))
    return paths[0], paths[1]


def probe_counts_check(what: str, counts: dict[str, int], per_step: dict[str, int], per_eval: dict[str, int],
                       steps: int, evals: int) -> None:
    for name, n in counts.items():
        want = per_step.get(name, 0) * steps + per_eval.get(name, 0) * evals
        if n != want:
            raise RuntimeError(f"{what}: {name} launched {n} times in {steps} steps and {evals} eval batches, expected "
                               f"{per_step.get(name, 0)} a step and {per_eval.get(name, 0)} an eval batch")


def audiontt_probe_run(tmp: str, wav, dev) -> dict[str, int]:
    """The linear probe (train_downstream --freeze) on the DeLoRes-S run's
    checkpoint at configs/downstream.yaml as it stands (AudioNTT, d 2048,
    64 mels, 1 s clips, B=32), one epoch: 2 steps and one eval batch on the
    run's 16 training WAVs labelled by pitch (4 classes). Per step and per
    eval batch the log-mel kernel launches once; 1 s gives 101 frames, which
    the fused block 1 does not take (it needs an even frame count: the JAX
    package's rule), so block 1 runs cuDNN and its kernels launch 0 times."""
    from audiossl_tpu_torch.frontend import fused_stft
    from audiossl_tpu_torch.ops import block1
    from audiossl_tpu_torch.train_downstream import main as downstream_main

    files = [os.path.join(tmp, f"train{i}.wav") for i in range(16)]  # write_manifest's sines, rising in pitch
    train_csv, test_csv = write_labelled(tmp, "probe", files, [f"pitch{i // 4}" for i in range(16)], 64, 32)
    wrappers = {"log_mel_fused": fused_stft.log_mel_fused, "block1_fwd": block1.block1_fwd,
                "block1_bwd_sums": block1.block1_bwd_sums, "block1_bwd_weight": block1.block1_bwd_weight}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = downstream_main(["--task", "probe", "--train_csv", train_csv, "--test_csv", test_csv, "--checkpoint",
                              os.path.join(tmp, "delores_s_chkp"), "--freeze", "--epochs", "1",
                              "--exp_dir", os.path.join(tmp, "exp")])
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    print(f"probe: train_downstream --freeze on the DeLoRes-S checkpoint (AudioNTT-2048, 64 mels, 1 s, B=32), "
          f"{len(result['losses'])} steps + 1 eval batch in {time.perf_counter() - t0:.1f} s; losses {result['losses']}; "
          f"test accuracy {result['history']}; launches {counts}")
    if len(result["losses"]) != 2 or not all(math.isfinite(v) for v in result["losses"] + result["history"]):
        raise RuntimeError(f"the AudioNTT probe gave losses {result['losses']} and accuracy {result['history']}")
    probe_counts_check("the AudioNTT probe", counts, {"log_mel_fused": 1}, {"log_mel_fused": 1}, 2, 1)
    return counts


def ast_wavs(tmp: str, wav) -> tuple[list[str], list[str]]:
    """8 synthetic 10.5 s WAVs, two of each of 4 classes: the class's tone
    and its third harmonic in noise, pitch rising with the class."""
    rng = np.random.default_rng(41)
    t = np.arange(int(10.5 * 16000)) / 16000.0
    files, labels = [], []
    for i in range(8):
        c = i % 4
        f0 = 180.0 * 2 ** (c / 1.5) * (1.0 + 0.01 * (i // 4))
        x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 3 * f0 * t) + 0.03 * rng.standard_normal(t.size)
        files.append(os.path.join(tmp, f"ast{i}.wav"))
        wav.write_wav(files[-1], x.astype(np.float32))
        labels.append(f"tone{c}")
    return files, labels


def ast_config(tmp: str) -> tuple[dict, str]:
    """configs/downstream.yaml with only base_encoder.type AST, model_size
    base, input.n_mels 128 and run.duration 10.24, written to ``tmp``."""
    import yaml

    from audiossl_tpu_torch import config as cfgmod

    config = cfgmod.load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "downstream.yaml"))
    config["downstream"]["base_encoder"].update(type="AST", model_size="base")
    config["downstream"]["input"]["n_mels"] = 128
    config["run"]["duration"] = 10.24
    path = os.path.join(tmp, "ast_downstream.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return config, path


def ast_finetune_run(tmp: str, wav, dev) -> dict[str, int]:
    """AST-base fine-tuning through train_downstream (the CLI's main, in this
    process so that the launch counts can be read) at AST's published input:
    ast_config, B=32, seeded random weights, one epoch of 3 steps on
    synthetic labelled WAVs, then one eval batch. Per step 1 log-mel launch
    and 12 / 12 / 12 attention launches; per eval batch 1 log-mel and 12
    forward launches. Returns the launch counts of the run."""
    from audiossl_tpu_torch.frontend import fused_stft
    from audiossl_tpu_torch.ops import attention as A
    from audiossl_tpu_torch.train_downstream import main as downstream_main

    config, cfg_path = ast_config(tmp)
    files, labels = ast_wavs(tmp, wav)
    steps, evals = 3, 1
    train_csv, test_csv = write_labelled(tmp, "ast", files, labels, steps * AST_BATCH, evals * AST_BATCH)
    wrappers = {"log_mel_fused": fused_stft.log_mel_fused, **{name: getattr(A, name) for name in ATTN_KERNELS}}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    # --encoder AST as well: the CLI's --encoder (default AudioNTT2020Task6) overrides the config, as in JAX
    result = downstream_main(["--task", "ast", "--train_csv", train_csv, "--test_csv", test_csv, "-c", cfg_path,
                              "--encoder", "AST", "--epochs", "1", "--exp_dir", os.path.join(tmp, "exp")])
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    print(f"AST-base fine-tune: train_downstream, 128 mels x 1025 frames (1214 tokens), B={AST_BATCH}, f32 trunk with "
          f"bf16 attention operands, {len(result['losses'])} steps + {evals} eval batch in {time.perf_counter() - t0:.1f} s "
          f"(set-up and loading included); losses {result['losses']}; test accuracy {result['history']}; launches {counts}")
    if len(result["losses"]) != steps or not all(math.isfinite(v) for v in result["losses"] + result["history"]):
        raise RuntimeError(f"the AST fine-tune gave losses {result['losses']} and accuracy {result['history']}")
    per_step = {"log_mel_fused": 1, **dict.fromkeys(ATTN_KERNELS, AST_DEPTH)}
    per_eval = {"log_mel_fused": 1, "rel_attention_fwd": AST_DEPTH}
    probe_counts_check("the AST-base fine-tune", counts, per_step, per_eval, steps, evals)
    return counts


def ast_attention_checks(dev) -> dict[str, float]:
    """The attention kernels with no bias where the keys do not fit in shared
    memory (the streamed designs), f32 and bf16, against their plain
    versions: AST-base's (384, 1214, 64), equal bits twice there; a ragged
    1500; keys one past a multiple of the 64-key chunk; a microbatch of the
    pipelined AST-base and of the vit_block pipeline (phases 43-44)."""
    mb = PP_MB * PP_HEADS
    cases = [("AST-base [384, 1214, 1214] D=64", 384, 1214, 1214), ("ragged [24, 1500, 1500] D=64", 24, 1500, 1500),
             ("64 n + 1 keys [6, 1217, 1217] D=64", 6, 1217, 1217),
             (f"a pipeline microbatch [{mb}, {PP_TOKENS}, {PP_TOKENS}] D=64", mb, PP_TOKENS, PP_TOKENS)]
    errs = dict.fromkeys(ATTN_KERNELS, 0.0)
    for i, (label, bh, lq, lk) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(label, bh, lq, None, lk, 64, dtype, dev, 100 + i, errs, twice=i == 0)
    return errs


def ast_f32_step_check(dev) -> dict[str, float]:
    """One f32 AST-tiny step (depth 12, the 128 x 1025 input: 1214 tokens,
    past the resident f32 kernels' 799 / 719 keys at D = 64, so the streamed
    f32 forward and dq run; attention operands f32) on the card against the
    CPU's plain path, from the same weights and views; the loss is a fixed
    random projection of the embedding. The MAST-tiny check's method and
    bounds; the CPU's gradients are also taken on the views changed by 1e-6
    relative, to show its own sensitivity."""
    import copy

    from audiossl_tpu_torch.models.ast import ASTEncoder
    from audiossl_tpu_torch.ops import attention as A

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = ASTEncoder(128, AST_CLIP // 160 + 1, "tiny", attention_dtype=torch.float32).train()
    rng = np.random.default_rng(51)
    views = torch.from_numpy(rng.standard_normal((2, 1, 128, AST_CLIP // 160 + 1)).astype(np.float32))
    proj = torch.from_numpy(rng.standard_normal((2, 192)).astype(np.float32))
    noisy = views * (1.0 + 1e-6 * torch.randn(views.shape, generator=torch.Generator().manual_seed(7)))
    plans = [A._lib().audiossl_attn_tile(which, 1214, 64, 0, 0) for which in range(3)]
    results = []
    for d, v in ((dev, views), (torch.device("cpu"), views), (torch.device("cpu"), noisy)):
        model = copy.deepcopy(init).to(d)
        before = [getattr(A, name).launches for name in ATTN_KERNELS]
        loss = (model(v.to(d)) * proj.to(d)).sum()
        loss.backward()
        launched = [getattr(A, name).launches - n for name, n in zip(ATTN_KERNELS, before)]
        results.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}, launched))
    (loss_card, g_card, launched), (loss_cpu, g_cpu, _), (_, g_noisy, _) = results
    if launched != [AST_DEPTH] * 3:
        raise RuntimeError(f"the f32 AST-tiny step launched the attention kernels {launched} times, expected 12 each")
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    largest = max(float(g.abs().max()) for g in g_cpu.values())

    def compare(g):
        rels = {n: float((g[n] - ref).abs().max()) / (float(ref.abs().max()) + 1e-2 * largest) for n, ref in g_cpu.items()}
        flat = lambda gs: torch.cat([v.flatten() for v in gs.values()])
        return rels, float((flat(g) - flat(g_cpu)).norm() / flat(g_cpu).norm())

    rels, norm_err = compare(g_card)
    noise_rels, noise_norm = compare(g_noisy)
    worst = max(rels, key=rels.get)
    print(f"f32 AST-tiny step (1214 tokens, f32 attention: rows per block forward / dq / dk-dv {plans}; launches "
          f"{launched}), the CPU alone on its views changed by 1e-6 relative: gradients move {noise_norm:.3e} in norm, "
          f"the worst tensor {max(noise_rels.values()):.3e}")
    print(f"f32 AST-tiny step, card vs CPU plain path on the same views: loss {loss_card:.7e} vs {loss_cpu:.7e} "
          f"(relative {loss_err:.3e}, tol {TOL_AST_LOSS}); gradients {norm_err:.3e} in norm; worst tensor {worst} "
          f"{rels[worst]:.3e} (tol {TOL_AST_GRAD})")
    if not (loss_err <= TOL_AST_LOSS and rels[worst] <= TOL_AST_GRAD):
        raise RuntimeError(f"the f32 AST-tiny step on the card disagrees with the CPU path: {loss_err}, {rels[worst]}")
    return {"loss": loss_err, "gradients_norm": norm_err, "worst_tensor": rels[worst],
            "cpu_1e-6_views_gradients": noise_norm, "cpu_1e-6_views_worst_tensor": max(noise_rels.values())}


def ast_attention_times(dev, card, shape: tuple[int, int, int] = AST_SHAPE) -> dict[str, dict]:
    """Each attention kernel at AST-base's (384, 1214, 64) (or ``shape``: a
    tp rank's heads), bf16, no bias: ms per launch and per step (12
    launches), its plain version, the bound, and the library yardstick,
    scaled_dot_product_attention with no mask (its forward; the graph of
    forward and backward less the forward's for the backward kernels); all
    CUDA graph replays."""
    import torch.nn.functional as F

    from audiossl_tpu_torch.ops import attention as A

    bh, l, d = shape
    q, k, v, _, do = attention_case(bh, l, None, l, d, torch.bfloat16, dev, seed=131)
    scale = d**-0.5
    qs = A.scale_q(q, scale)
    _, _, stats = A.rel_attention_bwd_dq(qs, k, v, None, None, scale, do)
    four = lambda t: t.view(AST_BATCH, bh // AST_BATCH, l, d)  # [B, H, L, D] for SDPA
    ql, kl, vl = (four(t).clone().requires_grad_() for t in (q, k, v))

    def library_fwd_bwd():
        out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        return torch.autograd.grad(out, (ql, kl, vl), four(do))

    lib_fwd = graph_ms(lambda: F.scaled_dot_product_attention(four(q), four(k), four(v), scale=scale))
    lib_bwd = graph_ms(library_fwd_bwd) - lib_fwd
    fns = {
        "rel_attention_fwd": (lambda: A.rel_attention_fwd(qs, k, v, None, None),
                              lambda: A.attention_fwd_plain(qs, k, v, None, None), lib_fwd),
        "rel_attention_bwd_dq": (lambda: A.rel_attention_bwd_dq(qs, k, v, None, None, scale, do),
                                 lambda: A.attention_bwd_dq_plain(qs, k, v, None, None, scale, do), lib_bwd),
        "rel_attention_bwd_dkv": (lambda: A.rel_attention_bwd_dkv(qs, k, v, None, None, do, stats),
                                  lambda: A.attention_bwd_dkv_plain(qs, k, v, None, None, do, stats), lib_bwd),
    }
    out = {}
    for name, (kernel, plain, lib_ms) in fns.items():
        ms, plain_ms = graph_ms(kernel), graph_ms(plain, iters=5)
        bound, t_bytes, t_ops = attention_bound(name, bh, l, l, d, 0, 2)
        print(f"[{card}] {name} AST-base [{bh}, {l}, {l}] D={d} bf16, no bias, {AST_DEPTH} a step: kernel {ms:.4f} ms "
              f"({AST_DEPTH * ms:.4f} a step), plain {plain_ms:.4f} ms, library (SDPA, no mask"
              f"{', forward' if name == 'rel_attention_fwd' else ', its whole backward'}) {lib_ms:.4f} ms; bound "
              f"{bound:.4f} ms (bytes {t_bytes:.4f}, products {t_ops:.4f} at the bf16 rate; {bound * AST_DEPTH:.4f} a step)")
        out[name] = {"shape": list(shape), "launches_per_step": AST_DEPTH, "ms": ms, "ms_per_step": AST_DEPTH * ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "library_ms": lib_ms}
    return out


def ast_train_times(dev, card) -> None:
    """train_clips_per_sec of the AST-base fine-tune (ast_config, B=32) on
    device-resident waves: the median of 3 windows of 3 steps on the host
    clock; the step split by CUDA events (mean of 3 steps); the profiler's
    device busy share over 2 steps."""
    from audiossl_tpu_torch.downstream import probe
    from audiossl_tpu_torch.frontend.stft import LogMelConfig
    from audiossl_tpu_torch.objectives.unfused import cross_entropy

    with tempfile.TemporaryDirectory() as tmp:
        config, _ = ast_config(tmp)
    mel_cfg = LogMelConfig(n_mels=128)
    model = probe.build_model(config, 4, mel_cfg.num_frames(AST_CLIP)).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=float(config["run"]["lr"]))
    rng = np.random.default_rng(61)
    waves = torch.from_numpy((0.3 * rng.standard_normal((AST_BATCH, AST_CLIP))).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 4, AST_BATCH)).to(dev)
    step = lambda: probe.probe_step(model, opt, mel_cfg, waves, labels)
    for _ in range(2):
        loss = step()
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(3):
            loss = step()
        torch.cuda.synchronize()
        rates.append(3 * AST_BATCH / (time.perf_counter() - t0))
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"AST fine-tune loss became {loss.item()}")
    names = ("log-mel", "forward + loss", "backward", "Adam")
    parts = dict.fromkeys(names, 0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    for _ in range(3):
        ev[0].record()
        feats = probe.features(waves, mel_cfg)
        ev[1].record()
        loss = cross_entropy(model(feats), labels)
        ev[2].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        for name, e0, e1 in zip(names, ev[:-1], ev[1:]):
            parts[name] += e0.elapsed_time(e1) / 3
    print(f"[{card}] AST-base fine-tune B={AST_BATCH}, 128 x 1025 (1214 tokens), f32 trunk, bf16 attention: "
          f"train_clips_per_sec {float(np.median(rates)):.1f} (median of windows {[round(r, 1) for r in rates]}); "
          f"step split " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            loss = step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us = device_kernels_us(prof.key_averages())
    busy = sum(kernels_us.values())
    if not busy:
        print(f"[{card}] AST fine-tune profile: no device time recorded (not measured)")
        return
    print(f"[{card}] AST fine-tune profile, 2 steps: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"({busy / wall_us:.1%}); {len(kernels_us)} kernels; by device time per step:")
    for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 2e3:9.4f} ms  {us / busy:6.1%}  {name[:110]}")



# ---------------------------------------------------------------- the SS-MAST checkpoint put to use (slice 9)

PROBE_BATCH = 32  # configs/downstream.yaml's run.batch_size
PROBE_MELS, PROBE_FRAMES = 64, 101  # configs/downstream.yaml: 64 mels, 1 s clips (a 9 x 5 token grid)


def mast_probe_attention_shapes(batch: int = PROBE_BATCH) -> list[tuple[int, int, tuple[int, int], int]]:
    """MAST-B's distinct attention shapes at the probe's 64 mels x 101
    frames: (BH, Lq, key grid, blocks), in block order, read from the model
    on the meta device."""
    from audiossl_tpu_torch.models.mast import MASTEncoder

    with torch.device("meta"):
        m = MASTEncoder(PROBE_MELS, PROBE_FRAMES, "base")
    shapes: dict[tuple, int] = {}
    for a in (blk.attn for blk in m.blocks):
        key = (batch * a.num_heads, a.q_hw[0] * a.q_hw[1], tuple(a.k_hw))
        shapes[key] = shapes.get(key, 0) + 1
    return [(bh, lq, grid, n) for (bh, lq, grid), n in shapes.items()]


def mast_probe_attention_checks(dev) -> dict[str, float]:
    """The three attention kernels against their plain versions, f32 and
    bf16, at every attention shape of MAST-B at the probe's 9 x 5 token grid
    (B=32: Lq from 45 down to 2, Lk from 15 down to 2), far below the
    64-row tiles the kernels were designed at; bf16 twice for equal bits."""
    errs = dict.fromkeys(ATTN_KERNELS, 0.0)
    for i, (bh, lq, grid, n) in enumerate(mast_probe_attention_shapes()):
        label = f"MAST-B probe [{bh}, {lq}, {grid[0] * grid[1]}] {grid[0]}x{grid[1]} ({n} blocks)"
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(label, bh, lq, grid, None, 96, dtype, dev, 200 + i, errs, twice=dtype == torch.bfloat16)
    return errs



SLICE9_CLIP = 163840  # 10.24 s at 16 kHz: 1022 Kaldi frames, padded to the config's 1024
SLICE9_BATCH = 64  # the serving batch: configs/ssmast.yaml's run.batch_size
SLICE9_REQUESTS = (1, 7, 64, 65)


class LogLines(logging.Handler):
    """Collects the messages of one logger while attached."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.logger, self.lines = logging.getLogger(name), []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def kernel_wrappers() -> dict:
    """Every kernel wrapper with a launch counter, by the kernel line's names
    (the rows kernel counts by mode in ``fused_rows.launches``)."""
    from audiossl_tpu_torch.frontend import fused_stft
    from audiossl_tpu_torch.ops import attention as A
    from audiossl_tpu_torch.ops import block1

    return {"log_mel_fused": fused_stft.log_mel_fused, "block1_fwd": block1.block1_fwd,
            "block1_bwd_sums": block1.block1_bwd_sums, "block1_bwd_weight": block1.block1_bwd_weight,
            **{name: getattr(A, name) for name in ATTN_KERNELS}}


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    from audiossl_tpu_torch.frontend import fused_stft

    for fn in kernel_wrappers().values():
        fn.launches = 0
    fused_stft.fused_rows.launches.update(dict.fromkeys(fused_stft.ROW_MODES, 0))


def read_launches() -> dict[str, int]:
    """Every kernel's launch count, the rows kernel's by mode."""
    from audiossl_tpu_torch.frontend import fused_stft

    counts = {name: fn.launches for name, fn in kernel_wrappers().items()}
    counts.update({f"fused_rows_{mode}": n for mode, n in fused_stft.fused_rows.launches.items()})
    return counts


def expect_counts(what: str, counts: dict[str, int], want: dict[str, int]) -> None:
    """Each counter at ``want`` (0 where unnamed)."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise RuntimeError(f"{what}: {name} launched {n} times, expected {want.get(name, 0)} (all counts {counts})")


def slice9_requests(wav_dir: str, wav, n: int) -> np.ndarray:
    """[n, SLICE9_CLIP] waves: phase 10's 16 WAVs read back through
    data/wav.py, scaled and in noise."""
    rng = np.random.default_rng(71)
    clips = np.stack([wav.load_wave(os.path.join(wav_dir, f"mast{i}.wav"))[:SLICE9_CLIP] for i in range(16)])
    gains = rng.uniform(0.3, 1.0, (n, 1))
    return (gains * clips[np.arange(n) % 16] + 0.01 * rng.standard_normal((n, SLICE9_CLIP))).astype(np.float32)


def fbank_serving_run(label: str, export_argv: list[str], pool: np.ndarray, depth: int, tmp: str, dev, card) -> dict:
    """One fbank serving path through the entry points a user calls:
    ``serve.export`` (CLI main) writes the artifact at the default dtype and
    at f32; ``ServingEncoder`` with a fixed batch of SLICE9_BATCH answers
    SLICE9_REQUESTS, counts from 0 (per batch 1 Kaldi rows launch and
    ``depth`` attention forwards, nothing else); default vs f32 on the card
    within TOL_BF16, f32 on the card vs the CPU path on two clips within
    TOL_F32; then the times. Returns the counts, errors and times."""
    from audiossl_tpu_torch.serve import export as serve

    arts = {}
    for dtype in ("default", "f32"):
        arts[dtype] = os.path.join(tmp, f"{label}_{dtype}.pt")
        serve.main(export_argv + ["--out", arts[dtype], "--dtype", dtype, "--clip_samples", str(SLICE9_CLIP),
                                  "--device", str(dev)])
    art = serve.load_artifact(arts["default"])
    enc = fixed_batch_encoder(arts["default"], dev)
    reset_launches()
    outs = {n: enc(pool[:n]) for n in SLICE9_REQUESTS}
    torch.cuda.synchronize()
    counts = read_launches()
    batches = sum(-(-n // SLICE9_BATCH) for n in SLICE9_REQUESTS)
    d = outs[1].shape[1]
    for n, out in outs.items():
        if out.shape != (n, d) or not np.isfinite(out).all():
            raise RuntimeError(f"{label} serving {n} clips: shape {out.shape} or non-finite")
    print(f"{label} serving: artifact {art['encoder_type']} {art['model_size']}, {art['frontend']}, "
          f"{art['input_tdim']} frames, dtype {art['compute_dtype']}; requests {list(SLICE9_REQUESTS)} -> [n, {d}] "
          f"finite in {batches} batches of {SLICE9_BATCH}; launches {counts}")
    expect_counts(f"{label} serving", counts, {"fused_rows_kaldi": batches, "rel_attention_fwd": depth * batches})

    f32 = fixed_batch_encoder(arts["f32"], dev)
    e32 = f32(pool[:SLICE9_BATCH])
    rel = float(np.abs(outs[SLICE9_BATCH] - e32).max() / np.abs(e32).max())
    print(f"{label} serving default ({art['compute_dtype']}) vs f32 on the card, batch {SLICE9_BATCH}: max|d| / max|f32| "
          f"= {rel:.3e} (tol {TOL_BF16})")
    if not rel <= TOL_BF16:
        raise RuntimeError(f"{label}: default-dtype serving strays from f32: {rel}")
    cpu = serve.ServingEncoder(arts["f32"], device="cpu")
    t0 = time.perf_counter()
    ecpu = cpu(pool[:2])
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(e32[:2] - ecpu).max())
    scale = max(1.0, float(np.abs(ecpu).max()))
    print(f"{label} serving f32 card vs CPU plain path, 2 clips ({cpu_s:.1f} s on the CPU): max|d| = {err:.3e} "
          f"(tol {TOL_F32 * scale:.3e})")
    if not err <= TOL_F32 * scale:
        raise RuntimeError(f"{label}: f32 serving on the card disagrees with the CPU path: {err}")

    emb = enc.embedder
    w = torch.from_numpy(pool[:SLICE9_BATCH]).to(dev)
    with torch.inference_mode():
        feats = emb.features(w)
        frontend_ms = cuda_ms(lambda: emb.features(w), iters=10)
        encoder_ms = cuda_ms(lambda: emb.model(feats), iters=5, warmup=2)
        serve_ms = cuda_ms(lambda: emb(w), iters=5, warmup=2)
    batch_np = pool[:SLICE9_BATCH]
    enc(batch_np)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        enc(batch_np)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    with torch.inference_mode():
        busy = busy_share(lambda: emb(w), 3, card, f"{label} serving, device-resident")
    print(f"[{card}] {label} serving B={SLICE9_BATCH}, {art['input_tdim']} x {art['frontend']['n_mels']} fbank, "
          f"{art['compute_dtype']}, device-resident: {serve_ms:.4f} ms/batch = {SLICE9_BATCH / serve_ms * 1e3:.1f} clips/s "
          f"(frontend {frontend_ms:.4f} ms, encoder {encoder_ms:.4f} ms); through ServingEncoder (numpy in/out, host "
          f"clock): {host_ms:.4f} ms/batch = {SLICE9_BATCH / host_ms * 1e3:.1f} clips/s")
    return {"counts": counts, "batches": batches, "bf16_rel": rel, "f32_cpu_err": err, "busy": busy,
            "device_ms": serve_ms, "frontend_ms": frontend_ms, "encoder_ms": encoder_ms, "host_ms": host_ms,
            "clips_per_s": SLICE9_BATCH / serve_ms * 1e3, "host_clips_per_s": SLICE9_BATCH / host_ms * 1e3}


def fixed_batch_encoder(path: str, dev):
    """A ServingEncoder over the artifact at the fixed batch SLICE9_BATCH."""
    from audiossl_tpu_torch.serve.export import ServingEncoder

    return ServingEncoder(path, fixed_batch=SLICE9_BATCH, device=dev)


def busy_share(fn, calls: int, card, label: str) -> float | None:
    """The device's busy share over ``calls`` eager calls of ``fn`` (after
    one warm-up): torch.profiler's summed kernel time over the host clock;
    prints it with the largest kernels. None if no device time was recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    kernels_us = device_kernels_us(averages)
    busy = sum(kernels_us.values())
    if not busy:
        print(f"[{card}] {label} profile: no device time recorded (not measured)")
        return None
    aten = sum(e.count for e in averages if e.key.startswith("aten::")) / calls
    print(f"[{card}] {label} profile, {calls} calls: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"({busy / wall_us:.1%}); {aten:.0f} aten calls a call; by device time per call:")
    for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {us / calls / 1e3:9.4f} ms  {us / busy:6.1%}  {name[:110]}")
    return busy / wall_us


def ast_serving_config(tmp: str) -> str:
    """configs/ssmast.yaml (128-bin fbank, 1024 frames) with base_encoder
    AST, model_size base: AST-base at its published input, 1214 tokens."""
    import yaml

    config = ssmast_config()
    config["pretrain"]["base_encoder"].update(type="AST", model_size="base")
    path = os.path.join(tmp, "ast_serve.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def mast_probe_config(tmp: str) -> str:
    """configs/downstream.yaml with base_encoder MAST, model_size base (64
    mels, 1 s, B=32 as it stands), written to ``tmp``."""
    import yaml

    from audiossl_tpu_torch import config as cfgmod

    config = cfgmod.load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "downstream.yaml"))
    config["downstream"]["base_encoder"].update(type="MAST", model_size="base")
    path = os.path.join(tmp, "mast_downstream.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def mast_probe_run(ckpt: str, wav_dir: str, tmp: str, dev) -> dict[str, dict[str, int]]:
    """train_downstream (the CLI's main) on the SS-MAST checkpoint with MAST-B
    at configs/downstream.yaml's 64 mels x 1 s, B=32: frozen (2 steps and 1
    eval batch; per step 1 log-mel and 24 attention forwards, no backward),
    then fine-tuned (2 steps and 1 eval batch; per step 24 of each backward
    kernel as well). The cross-shape transplant (128 x 1024 -> 64 x 101)
    must be logged, the losses finite. Returns each run's launch counts."""
    from audiossl_tpu_torch.train_downstream import main as downstream_main

    files = [os.path.join(wav_dir, f"mast{i}.wav") for i in range(16)]
    train_csv, test_csv = write_labelled(tmp, "mastprobe", files, [f"pitch{i // 4}" for i in range(16)],
                                         2 * PROBE_BATCH, PROBE_BATCH)
    cfg_path = mast_probe_config(tmp)
    depth = 24
    out = {}
    for mode, flags in (("frozen", ["--freeze"]), ("fine-tuned", [])):
        reset_launches()
        t0 = time.perf_counter()
        with LogLines("audiossl_tpu_torch.downstream") as log_lines:
            result = downstream_main(["--task", "mastprobe", "--train_csv", train_csv, "--test_csv", test_csv,
                                      "--checkpoint", ckpt, "-c", cfg_path, "--encoder", "MAST", "--epochs", "1",
                                      "--batch_size", str(PROBE_BATCH), "--exp_dir", os.path.join(tmp, "exp"),
                                      "--device", str(dev)] + flags)
        torch.cuda.synchronize()
        counts = read_launches()
        transplant = [line for line in log_lines.lines if "cross-shape encoder transplant" in line]
        print(f"MAST-B probe ({mode}): train_downstream on the SS-MAST checkpoint, 64 mels x 101 frames (9 x 5 "
              f"tokens), B={PROBE_BATCH}, {len(result['losses'])} steps + 1 eval batch in {time.perf_counter() - t0:.1f} s; "
              f"losses {result['losses']}; test accuracy {result['history']}; launches {counts}; log: {transplant}")
        if not transplant:
            raise RuntimeError(f"the MAST-B probe ({mode}) did not log the cross-shape transplant")
        if len(result["losses"]) != 2 or not all(math.isfinite(v) for v in result["losses"] + result["history"]):
            raise RuntimeError(f"the MAST-B probe ({mode}) gave losses {result['losses']}")
        per_step = {"log_mel_fused": 1, "rel_attention_fwd": depth}
        if mode == "fine-tuned":
            per_step.update(rel_attention_bwd_dq=depth, rel_attention_bwd_dkv=depth)
        probe_counts_check(f"the MAST-B probe ({mode})", counts, per_step, {"log_mel_fused": 1, "rel_attention_fwd": depth},
                           2, 1)
        out[mode] = counts
    return out


def mast_probe_times(ckpt: str, dev, card, tmp: str) -> dict[str, dict[str, float]]:
    """The MAST-B probe's step on device-resident waves (B=32, 64 mels x 1 s,
    the checkpoint transplanted), frozen and fine-tuned: the step split by
    CUDA events (mean of 5 steps), clips/s (host clock, median of 3 windows
    of 5 steps) and the device's busy share over 3 steps."""
    from audiossl_tpu_torch.config import load_config
    from audiossl_tpu_torch.downstream import probe
    from audiossl_tpu_torch.frontend.stft import LogMelConfig
    from audiossl_tpu_torch.objectives.unfused import cross_entropy

    config = load_config(mast_probe_config(tmp))
    mel_cfg = LogMelConfig(n_mels=PROBE_MELS)
    rng = np.random.default_rng(73)
    waves = torch.from_numpy((0.3 * rng.standard_normal((PROBE_BATCH, 16000))).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 4, PROBE_BATCH)).to(dev)
    out = {}
    for mode in ("frozen", "fine-tuned"):
        model = probe.build_model(config, 4, PROBE_FRAMES)
        probe.load_encoder(model, ckpt, (PROBE_FRAMES, PROBE_MELS))
        model = model.to(dev).train()
        if mode == "frozen":
            model.encoder.requires_grad_(False)
        opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=1e-3)
        gen = torch.Generator(dev).manual_seed(7)
        step = lambda: probe.probe_step(model, opt, mel_cfg, waves, labels, gen)
        for _ in range(3):
            loss = step()
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5):
                loss = step()
            torch.cuda.synchronize()
            rates.append(5 * PROBE_BATCH / (time.perf_counter() - t0))
        if not math.isfinite(loss.item()):
            raise RuntimeError(f"MAST-B probe ({mode}) loss became {loss.item()}")
        names = ("log-mel", "forward + loss", "backward", "Adam")
        parts = dict.fromkeys(names, 0.0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        for _ in range(5):
            ev[0].record()
            feats = probe.features(waves, mel_cfg)
            ev[1].record()
            loss = cross_entropy(model(feats, gen), labels)
            ev[2].record()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            ev[3].record()
            opt.step()
            ev[4].record()
            torch.cuda.synchronize()
            for name, e0, e1 in zip(names, ev[:-1], ev[1:]):
                parts[name] += e0.elapsed_time(e1) / 5
        print(f"[{card}] MAST-B probe ({mode}) B={PROBE_BATCH}, 64 mels x 101 frames (9 x 5 tokens), bf16: "
              f"{float(np.median(rates)):.1f} clips/s (median of windows {[round(r, 1) for r in rates]}); step split "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
        busy = busy_share(step, 3, card, f"MAST-B probe ({mode}) step")
        out[mode] = {"clips_per_s": float(np.median(rates)), "busy": busy, **parts}
    return out


def extract_features_run(ntt_ckpt: str, wav_dir: str, tmp: str, dev) -> dict:
    """downstream.extract_features (the CLI's main) on the 16 WAVs of phase
    10: log-mel files on the card within TOL_KERNEL of the CPU's (the log-mel
    kernel launching once a batch), then the embeddings of phase 7's
    DeLoRes-S checkpoint (AudioNTT-2048, bf16), finite and within TOL_BF16 of
    the CPU's. Returns the counts and errors."""
    from audiossl_tpu_torch.downstream.extract_features import main as extract_main

    csv = os.path.join(tmp, "extract.csv")
    with open(csv, "w") as f:
        f.write("AudioPath\n" + "".join(f"{os.path.join(wav_dir, f'mast{i}.wav')}\n" for i in range(16)))
    out = {}
    for kind, flags in (("log-mel", []), ("embeddings", ["--checkpoint", ntt_ckpt])):
        files = {}
        for device in ("cuda", "cpu"):
            reset_launches()
            dest = os.path.join(tmp, f"feats_{kind}_{device}")
            n = extract_main(["--csv", csv, "--out", dest, "--batch_size", "8", "--device", device] + flags)
            if device == "cuda":
                torch.cuda.synchronize()
                counts = read_launches()
            files[device] = {i: np.load(os.path.join(dest, f"mast{i}.wav.npy")) for i in range(n)}
        shape = files["cuda"][0].shape
        if n != 16 or not all(np.isfinite(v).all() for v in files["cuda"].values()):
            raise RuntimeError(f"extract_features ({kind}) wrote {n} files or non-finite values")
        err = max(float(np.abs(files["cuda"][i] - files["cpu"][i]).max()) for i in range(n))
        ref = max(float(np.abs(files["cpu"][i]).max()) for i in range(n))
        tol = TOL_KERNEL if kind == "log-mel" else TOL_BF16 * ref
        print(f"extract_features ({kind}): 16 files of {shape} on the card, max|card - CPU| = {err:.3e} (tol {tol:.3e}); "
              f"launches {counts}")
        if not err <= tol:
            raise RuntimeError(f"extract_features ({kind}) on the card disagrees with the CPU: {err}")
        expect_counts(f"extract_features ({kind})", counts, {"log_mel_fused": 2})
        out[kind] = {"launches": counts["log_mel_fused"], "max_abs_err": err}
    return out


# ---------------------------------------------------------------- the clustering family (slice 11)

CLUSTER_CLIPS = 1280  # 5 batches of 256: DECAR's 1280-slot bank holds its 1024 prototypes
CLUSTER_CLASSES = 16
DECAR_STEPS = 7  # 5 steps an epoch: the second clustering runs on a bank the first epoch's steps refreshed
CLUSTER_STEPS = 3  # DeepCluster-v1 and the Kmix run


def write_distinct_manifest(tmp: str, wav) -> tuple[str, np.ndarray]:
    """CLUSTER_CLIPS distinct 1 s clips and a manifest (``files``, ``class``):
    clip i belongs to class i % CLUSTER_CLASSES, whose f0 (a quarter octave
    apart from the next) it takes with a seeded 2% jitter, with a seeded
    gain, a second partial at a class-specific ratio and light noise. The
    sines of ``write_manifest`` repeat, which leaves k-means++ with zero
    weights and PCA with degenerate eigenvalues."""
    rng = np.random.default_rng(41)
    t = np.arange(16000) / 16000.0
    classes = np.arange(CLUSTER_CLIPS) % CLUSTER_CLASSES
    files = []
    for i, c in enumerate(classes):
        f0 = 110.0 * 2 ** (c / 4) * (1.0 + 0.02 * rng.standard_normal())
        x = rng.uniform(0.2, 0.5) * (np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * (1.5 + 0.25 * (c % 4)) * f0 * t))
        files.append(os.path.join(tmp, f"clip{i}.wav"))
        wav.write_wav(files[-1], (x + 0.01 * rng.standard_normal(t.size)).astype(np.float32))
    csv = os.path.join(tmp, "distinct.csv")
    with open(csv, "w") as f:
        f.write("files,class\n" + "".join(f"{p},{c}\n" for p, c in zip(files, classes)))
    return csv, classes


def serves(sd: dict, config: dict, pool: np.ndarray, what: str, dev) -> None:
    """The exported encoder ``sd`` serves a batch of SERVE_BATCH clips, finite."""
    from audiossl_tpu_torch import config as cfgmod
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.serve.export import build_embedder

    d = int(config["pretrain"]["base_encoder"]["output_dim"])
    emb = build_embedder(sd, build_frontend(config["pretrain"]["input"]), cfgmod.clip_samples(config), torch.bfloat16, dev)
    with torch.inference_mode():
        out = emb(torch.from_numpy(pool[:SERVE_BATCH]).to(dev))
    if out.shape != (SERVE_BATCH, d) or not torch.isfinite(out).all():
        raise RuntimeError(f"the {what} export served {tuple(out.shape)} or non-finite values")
    print(f"{what}: the exported encoder serves [{SERVE_BATCH}, {CLIP}] -> [{SERVE_BATCH}, {d}], finite")


def stats_lines(ckpt_dir: str) -> list[dict]:
    with open(os.path.join(ckpt_dir, "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


def ntt_launches(counts: dict[str, int]) -> dict[str, int]:
    return {k: counts[k] for k in NTT_KERNELS}


def decar_run(csv: str, pool: np.ndarray, tmp: str, dev) -> dict[str, int]:
    """DECAR-v2 through ``train_decar`` on configs/decar_v2.yaml as it stands
    (B=256, d=512, feat 128, 1024 prototypes, LARC, freeze 300) over the
    distinct manifest, 2 epochs, DECAR_STEPS steps, counts from 0: finite
    losses; two clusterings, each with every clip assigned and the
    prototypes equal to the centroids; one log-mel launch per bank batch and
    1 / 2 / 1 / 1 a step; the final bank and assignments complete; the
    exported encoder serves."""
    from audiossl_tpu_torch.train.decar_loop import train_decar

    config = ntt_config("decar_v2")
    batch = int(config["run"]["batch_size"])
    config["run"].update(save_path=os.path.join(tmp, "decar_v2"), epochs=2)
    reset_launches()
    t0 = time.perf_counter()
    with LogLines("audiossl_tpu_torch.decar") as lines:
        _, step, ckpt_dir = train_decar(config, csv, max_steps=DECAR_STEPS, seed=TRAIN_SEED, device=dev)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    losses = [line["train_loss"] for line in stats_lines(ckpt_dir)]
    clusterings = [line for line in lines.lines if "k-means over" in line]
    print(f"training: train_decar (configs/decar_v2.yaml), B={batch}, d=512, bf16, {CLUSTER_CLIPS} clips, {step} steps "
          f"in {seconds:.1f} s (set-up, the bank pass and loading included); losses {losses}; launches "
          f"{ntt_launches(counts)}")
    for line in clusterings:
        print(f"training: decar_v2 {line}")
    if step != DECAR_STEPS or len(losses) != DECAR_STEPS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"DECAR-v2 took {step} steps with losses {losses}")
    if len(clusterings) != 2 or not all(f"{CLUSTER_CLIPS}/{CLUSTER_CLIPS} clips assigned" in line
                                        and line.endswith("max|prototypes - centroids| = 0") for line in clusterings):
        raise RuntimeError(f"DECAR-v2's clusterings: {clusterings}")
    n_bank = CLUSTER_CLIPS // batch
    expect_counts(f"DECAR-v2, a {n_bank}-batch bank pass and {step} steps", counts,
                  {"log_mel_fused": n_bank + step, "block1_fwd": 2 * step, "block1_bwd_sums": step,
                   "block1_bwd_weight": step})
    state = torch.load(os.path.join(ckpt_dir, "state", f"{step}.pt"), map_location="cpu", weights_only=True)
    if not bool((state["assignments"] >= 0).all()) or not bool((state["memory"]["index"] >= 0).all()):
        raise RuntimeError("DECAR-v2's final assignments or bank leave clips out")
    sd = torch.load(os.path.join(ckpt_dir, "encoder", f"{step}.pt"), map_location="cpu", weights_only=True)
    serves(sd, config, pool, "training: decar_v2", dev)
    return counts


def deepcluster_run(csv: str, classes: np.ndarray, pool: np.ndarray, tmp: str, dev) -> dict[str, int]:
    """DeepCluster-v1 through ``train_deepcluster_v1`` on configs/decar_v1.yaml
    as it stands (B=256, d=2048, 512 clusters) over the distinct manifest,
    CLUSTER_STEPS steps, counts from 0: finite losses and k-means objective,
    one log-mel launch per feature batch and 1 / 1 / 1 / 1 a step; the
    exported encoder serves."""
    from audiossl_tpu_torch.train.deepcluster_loop import train_deepcluster_v1
    from audiossl_tpu_torch.utils.metrics import nmi

    config = ntt_config("decar_v1")
    batch = int(config["run"]["batch_size"])
    config["run"].update(save_path=os.path.join(tmp, "decar_v1"), epochs=1)
    reset_launches()
    t0 = time.perf_counter()
    _, step, ckpt_dir, labels = train_deepcluster_v1(config, csv, max_steps=CLUSTER_STEPS, seed=TRAIN_SEED, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    lines = stats_lines(ckpt_dir)
    losses, km = [line["train_loss"] for line in lines], lines[0]["kmeans_loss"]
    print(f"training: train_deepcluster_v1 (configs/decar_v1.yaml), B={batch}, d=2048, bf16, {CLUSTER_CLIPS} clips, "
          f"{step} steps in {seconds:.1f} s (set-up, the feature pass and loading included); k-means objective {km!r} "
          f"({len(np.unique(labels))} of 512 clusters non-empty, NMI against the generating classes "
          f"{nmi(labels, classes):.4f}); losses {losses}; launches {ntt_launches(counts)}")
    if step != CLUSTER_STEPS or len(losses) != step or not all(math.isfinite(v) for v in losses + [km]):
        raise RuntimeError(f"DeepCluster-v1 took {step} steps with losses {losses}, k-means objective {km}")
    n_feat = -(-CLUSTER_CLIPS // batch)
    expect_counts(f"DeepCluster-v1, a {n_feat}-batch feature pass and {step} steps", counts,
                  {"log_mel_fused": n_feat + step, "block1_fwd": step, "block1_bwd_sums": step,
                   "block1_bwd_weight": step})
    sd = torch.load(os.path.join(ckpt_dir, "encoder", f"{step}.pt"), map_location="cpu", weights_only=True)
    serves(sd, config, pool, "training: decar_v1", dev)
    return counts


def pseudo_label_kmix_run(ntt_ckpt: str, csv: str, classes: np.ndarray, pool: np.ndarray, tmp: str,
                          dev) -> dict[str, dict[str, int]]:
    """``make_pseudo_labels`` (the CLI's main, its default 585 clusters) on
    phase 7's DeLoRes-S checkpoint over the distinct manifest, counts from 0
    (one log-mel launch a batch, nothing else), the NMI of its labels
    against the generating classes; then DeLoRes-S through train_upstream
    on a copy of configs/delores_s_kmix.yaml whose centroid_path is the
    saved centroids, CLUSTER_STEPS steps, counts from 0 (1 / 2 / 2 / 2 a
    step), with Kmix's ranked partner search taking over once the first push
    (B clips) filled the bank past top_k."""
    from audiossl_tpu_torch.objectives.make_pseudo_labels import main as pseudo_main
    from audiossl_tpu_torch.train.loop import train_upstream
    from audiossl_tpu_torch.utils.metrics import nmi

    labelled, cents = os.path.join(tmp, "pseudo.csv"), os.path.join(tmp, "kmix_centroids.npy")
    reset_launches()
    t0 = time.perf_counter()
    out = pseudo_main(["--csv", csv, "--checkpoint", ntt_ckpt, "--out", labelled, "--save_centroids", cents])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pseudo_counts = read_launches()
    with open(labelled) as f:
        rows = f.read().splitlines()
    centroids = np.load(cents)
    score = nmi(out["labels"], classes)
    print(f"make_pseudo_labels: {len(rows) - 1} labels ({len(np.unique(out['labels']))} of 585 clusters non-empty, "
          f"k-means objective {out['loss']!r}) in {seconds:.1f} s; NMI against the {CLUSTER_CLASSES} generating "
          f"classes {score:.4f}; Kmix centroids {centroids.shape}; launches {ntt_launches(pseudo_counts)}")
    n_batches = -(-CLUSTER_CLIPS // 256)
    if rows[0] != "files,label" or len(rows) != CLUSTER_CLIPS + 1 or centroids.shape != (len(np.unique(out["labels"])), 64) \
            or not np.isfinite(centroids).all():
        raise RuntimeError(f"make_pseudo_labels wrote {rows[:2]} ... ({len(rows)} rows), centroids {centroids.shape}")
    expect_counts("make_pseudo_labels", pseudo_counts, {"log_mel_fused": n_batches})

    config = ntt_config("delores_s_kmix")
    config["pretrain"]["augmentations"]["Kmix"]["centroid_path"] = cents
    config["run"].update(save_path=os.path.join(tmp, "delores_s_kmix"), epochs=1)
    batch, top_k = int(config["run"]["batch_size"]), int(config["pretrain"]["augmentations"]["Kmix"]["top_k"])
    reset_launches()
    t0 = time.perf_counter()
    with LogLines("audiossl_tpu_torch.data") as lines:
        _, step, ckpt_dir = train_upstream(config, csv, "delores_s", max_steps=CLUSTER_STEPS, seed=TRAIN_SEED,
                                           device=dev)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    losses = [line["train_loss"] for line in stats_lines(ckpt_dir)]
    ranked = [line for line in lines.lines if line.startswith("Kmix: the bank holds")]
    print(f"training: train_upstream delores_s on configs/delores_s_kmix.yaml (centroid_path -> the saved centroids), "
          f"B={batch}, {step} steps in {seconds:.1f} s; losses {losses}; launches {ntt_launches(counts)}; {ranked}")
    if step != CLUSTER_STEPS or len(losses) != step or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"the Kmix DeLoRes-S run took {step} steps with losses {losses}")
    if ranked != [f"Kmix: the bank holds {batch} items (top_k {top_k}): partners from the ranked centroid "
                  "neighbourhoods from here on"]:
        raise RuntimeError(f"Kmix's ranked partner search did not take over after the first push: {ranked}")
    expect_counts(f"Kmix DeLoRes-S, {step} steps", counts,
                  {k: n * step for k, n in zip(NTT_KERNELS, TRAIN_LAUNCHES["delores_s_kmix"])})
    sd = torch.load(os.path.join(ckpt_dir, "encoder", f"{step}.pt"), map_location="cpu", weights_only=True)
    serves(sd, config, pool, "training: delores_s_kmix", dev)
    return {"make_pseudo_labels": pseudo_counts, "delores_s_kmix": counts, "nmi": score}


def clustering_times(csv: str, dev, card) -> dict[str, float]:
    """The seconds of one DECAR clustering (a 1280 x 128 bank, 1024
    centroids, 10 iterations: kmeans_on_mesh) by CUDA events, and of one
    memory-bank pass (fill_memory over the distinct manifest at B=256,
    d=512, bf16: WAV decode and windows on host threads, the log-mel kernel,
    eval-mode AudioNTT) on the host clock, each the second of two runs."""
    from audiossl_tpu_torch.data.pipeline import ManifestLoader
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.objectives.decar import kmeans_on_mesh
    from audiossl_tpu_torch.train.decar_loop import fill_memory

    gen = torch.Generator(dev).manual_seed(3)
    bank = torch.randn((CLUSTER_CLIPS, 128), generator=gen, device=dev)
    bank = bank / bank.norm(dim=1, keepdim=True)
    index = torch.arange(CLUSTER_CLIPS, device=dev)
    pick = torch.from_numpy(np.random.default_rng(3).permutation(CLUSTER_CLIPS)[:1024])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        start.record()
        kmeans_on_mesh(bank, index, CLUSTER_CLIPS, 1024, pick, 10)
        end.record()
        torch.cuda.synchronize()
    cluster_s = start.elapsed_time(end) / 1e3
    config = ntt_config("decar_v2")
    frontend = build_frontend(config["pretrain"]["input"])
    obj = init_objective("decar_v2", config, seed=0, device=dev)
    loader = ManifestLoader(csv, 256, CLIP, frontend.sample_rate, num_workers=8, seed=0, wire_dtype="int16")
    loader.labels = np.arange(loader.num_samples)
    mem, mem_idx = torch.zeros((CLUSTER_CLIPS, 128), device=dev), torch.full((CLUSTER_CLIPS,), -1, device=dev)
    for _ in range(2):
        t0 = time.perf_counter()
        fill_memory(obj, loader, frontend, mem, mem_idx)
        torch.cuda.synchronize()
        bank_s = time.perf_counter() - t0
    print(f"[{card}] DECAR clustering, a {CLUSTER_CLIPS} x 128 bank, 1024 centroids, 10 iterations "
          f"(kmeans_on_mesh, f32, TF32 off): {cluster_s:.4f} s by CUDA events; one memory-bank pass over "
          f"{CLUSTER_CLIPS} clips at B=256, d=512, bf16 (decode, log-mel kernel, eval AudioNTT, host clock): "
          f"{bank_s:.4f} s = {CLUSTER_CLIPS / bank_s:.1f} clips/s")
    return {"decar_clustering_s": cluster_s, "memory_bank_pass_s": bank_s}


# ---------------------------------------------------------------- slice 12: the supervised MAST fine-tune

FT_CLASSES = 527  # AudioSet's class count (synthetic mids)
FT_WAVS = 32  # distinct 10 s clips
FT_STEPS = 3
FT_ACCUM_STEPS = 2
FT_EVAL = 65  # a short last eval batch at B=64
FT_TOL_ACCUM = 1e-5  # accumulating 2 against 1 on the card, augmentations off
FT_FAULT_TENSORS = ("head.weight", "mast.blocks.1.attn.qkv.weight")


FT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "mast_ft.yaml")


def finetune_config() -> dict:
    """configs/mast_ft.yaml as it stands, the slice's path."""
    from audiossl_tpu_torch import config as cfgmod

    return cfgmod.load_config(FT_CONFIG)


def audioset_style_data(tmp: str, wav, batch: int) -> dict:
    """FT_WAVS distinct 10 s WAVs at 16 kHz (a chord of three partials in
    noise, each clip its own), a FT_CLASSES-row label CSV with synthetic
    mids, a train JSON of 4 batches and an eval JSON of FT_EVAL rows that
    list the WAVs again and again, 1-3 labels a row. Returns the paths and the
    clips [FT_WAVS, 160000]."""
    rng = np.random.default_rng(120)
    t = np.arange(160000) / 16000.0
    clips, files = [], []
    for i in range(FT_WAVS):
        f0 = 80.0 * 2 ** (i / 6)
        x = sum(a * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3)) for k, a in ((1, 0.3), (2.5, 0.12), (4.1, 0.06)))
        x = (x * (0.6 + 0.4 * np.sin(2 * np.pi * (0.3 + 0.1 * i) * t)) + 0.02 * rng.standard_normal(t.size))
        files.append(os.path.join(tmp, f"as{i:02d}.wav"))
        wav.write_wav(files[-1], x.astype(np.float32))
        clips.append(wav.load_wave(files[-1]))
    labels_csv = os.path.join(tmp, "class_labels_indices.csv")
    with open(labels_csv, "w") as f:
        f.write("index,mid,display_name\n" + "".join(f"{i},/m/syn{i:03d},class {i}\n" for i in range(FT_CLASSES)))
    out = {"label_csv": labels_csv, "clips": np.stack(clips).astype(np.float32)}
    for name, rows in (("train", 4 * batch), ("eval", FT_EVAL)):
        data = []
        for r in range(rows):
            i = int(rng.integers(FT_WAVS))
            mids = {i * 16 % FT_CLASSES, *rng.integers(FT_CLASSES, size=int(rng.integers(0, 3))).tolist()}
            data.append({"wav": files[i], "labels": ",".join(f"/m/syn{m:03d}" for m in sorted(mids))})
        out[name] = os.path.join(tmp, f"{name}.json")
        with open(out[name], "w") as f:
            json.dump({"data": data}, f)
    return out


def finetune_counts(per_step: dict[str, int], steps: int, per_eval: dict[str, int] | None = None,
                    eval_batches: int = 0) -> dict[str, int]:
    return {k: per_step.get(k, 0) * steps + (per_eval or {}).get(k, 0) * eval_batches
            for k in set(per_step) | set(per_eval or {})}


def finetune_attention_checks(dev) -> dict[str, float]:
    """The three attention kernels against their plain versions in bf16 at
    each of the fine-tune's MAST-B shapes (B=64: the SS-MAST query pass's
    MAST_ATTN shapes at half their batch), the first twice for equal bits."""
    errs = dict.fromkeys(ATTN_KERNELS, 0.0)
    for i, ((bh, lq, grid), n) in enumerate(MAST_ATTN):
        label = f"MAST-B fine-tune [{bh // 2}, {lq}, {grid[0] * grid[1]}] {grid[0]}x{grid[1]} ({n} blocks)"
        check_attention(label, bh // 2, lq, grid, None, 96, torch.bfloat16, dev, 300 + i, errs, twice=i == 0)
    return errs


def finetune_run(data: dict, tmp: str, dev, card) -> dict:
    """The fine-tune through its CLI on configs/mast_ft.yaml as it stands
    (MAST-B, 128 x 1024 fbank, B=64, bf16; mixup, SpecMask, norm and noise
    on) for FT_STEPS steps and the eval, counts from 0: per step 1 Kaldi rows
    launch and 24 attention forwards, 24 dq and 24 dk/dv; per eval batch 1
    rows launch and 24 forwards; nothing else. mAP and AUC finite in [0, 1].
    Then the export served through serve.export --checkpoint."""
    from audiossl_tpu_torch.models.mast import mast_config
    from audiossl_tpu_torch.train.finetune_mast import main as finetune_main

    config = finetune_config()
    depth = mast_config(config["finetune"]["model_size"]).depth
    batch = int(config["run"]["batch_size"])
    reset_launches()
    t0 = time.perf_counter()
    stats, ckpt_dir = finetune_main(["-c", FT_CONFIG, "--train_json", data["train"], "--label_csv", data["label_csv"],
                                     "--eval_json",
                                     data["eval"], "--max_steps", str(FT_STEPS), "--save_path",
                                     os.path.join(tmp, "mast_ft"), "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    eval_batches = -(-FT_EVAL // batch)
    with open(os.path.join(ckpt_dir, "stats.jsonl")) as f:
        losses = [rec["train_loss"] for rec in map(json.loads, f) if "step" in rec]
    print(f"fine-tune: finetune_mast CLI on configs/mast_ft.yaml as it stands (MAST-B, B={batch}, 128 x 1024 fbank, "
          f"bf16, mixup / SpecMask / norm / noise on), {FT_STEPS} steps and an eval of {FT_EVAL} clips in "
          f"{seconds:.1f} s (set-up, loading, eval and the checkpoint included); losses {losses}; stats {stats}; "
          f"launches {counts}")
    if len(losses) != FT_STEPS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"the fine-tune took {len(losses)} steps with losses {losses}")
    for key in ("mAP", "AUC"):
        if not (math.isfinite(stats[key]) and 0.0 <= stats[key] <= 1.0):
            raise RuntimeError(f"fine-tune eval {key} = {stats[key]}")
    per_step = {"fused_rows_kaldi": 1, "rel_attention_fwd": depth, "rel_attention_bwd_dq": depth,
                "rel_attention_bwd_dkv": depth}
    per_eval = {"fused_rows_kaldi": 1, "rel_attention_fwd": depth}
    expect_counts("fine-tune", counts, finetune_counts(per_step, FT_STEPS, per_eval, eval_batches))
    rng = np.random.default_rng(121)
    reps = data["clips"][np.arange(SLICE9_REQUESTS[-1]) % FT_WAVS]
    pool = np.pad(reps, ((0, 0), (0, SLICE9_CLIP - reps.shape[1])))
    pool = (rng.uniform(0.5, 1.0, (len(pool), 1)) * pool + 0.005 * rng.standard_normal(pool.shape)).astype(np.float32)
    serve = fbank_serving_run("MAST-B fine-tuned", ["--checkpoint", ckpt_dir], pool, depth, tmp, dev, card)
    return {"counts": counts, "per_step": per_step, "per_eval": per_eval, "eval_batches": eval_batches,
            "stats": stats, "losses": losses, "serve": serve}


def finetune_accum_run(data: dict, tmp: str, dev) -> dict[str, int]:
    """The same CLI with --grad_accum_steps 2 for FT_ACCUM_STEPS steps, no
    eval, counts from 0: 2 rows, 48 forwards, 48 dq, 48 dk/dv a step."""
    from audiossl_tpu_torch.models.mast import mast_config
    from audiossl_tpu_torch.train.finetune_mast import main as finetune_main

    depth = mast_config(finetune_config()["finetune"]["model_size"]).depth
    reset_launches()
    finetune_main(["-c", FT_CONFIG, "--train_json", data["train"], "--label_csv", data["label_csv"], "--max_steps",
                   str(FT_ACCUM_STEPS), "--grad_accum_steps", "2", "--save_path", os.path.join(tmp, "mast_ft_a2"),
                   "--device", str(dev)])
    torch.cuda.synchronize()
    counts = read_launches()
    print(f"fine-tune with --grad_accum_steps 2: {FT_ACCUM_STEPS} steps; launches {counts}")
    per_step = {"fused_rows_kaldi": 2, "rel_attention_fwd": 2 * depth, "rel_attention_bwd_dq": 2 * depth,
                "rel_attention_bwd_dkv": 2 * depth}
    expect_counts("fine-tune at grad_accum_steps 2", counts, finetune_counts(per_step, FT_ACCUM_STEPS))
    return counts


def ssmast_accum_run(tmp: str, wav, dev) -> dict[str, int]:
    """SS-MAST through train_upstream on configs/ssmast.yaml with
    pretrain.grad_accum_steps: 2, for 2 steps, counts from 0: per step 1
    fbank, 96 attention forwards (the two key passes and the two query
    passes), 48 dq and 48 dk/dv; the queue pointer at 2B a step."""
    from audiossl_tpu_torch.models.mast import mast_config
    from audiossl_tpu_torch.train.loop import train_upstream

    config = ssmast_config()
    config["pretrain"]["grad_accum_steps"] = 2
    batch = int(config["run"]["batch_size"])
    steps = 2
    csv = ssmast_wavs(tmp, wav, batch * steps)
    config["run"].update(save_path=os.path.join(tmp, "ssmast_a2"), epochs=1)
    depth = mast_config(config["pretrain"]["model_size"]).depth
    reset_launches()
    obj, step, ckpt_dir = train_upstream(config, csv, "ssmast", max_steps=steps, device=dev)
    torch.cuda.synchronize()
    counts = read_launches()
    losses = [rec["train_loss"] for rec in stats_lines(ckpt_dir)]
    print(f"SS-MAST with pretrain.grad_accum_steps 2: {step} steps, losses {losses}, queue pointer "
          f"{int(obj.queue_ptr)}; launches {counts}")
    if step != steps or not all(math.isfinite(v) for v in losses) or int(obj.queue_ptr) != 2 * batch * steps:
        raise RuntimeError(f"SS-MAST at grad_accum_steps 2: {step} steps, losses {losses}, pointer {int(obj.queue_ptr)}")
    per_step = {"fused_rows_kaldi": 1, "rel_attention_fwd": 4 * depth, "rel_attention_bwd_dq": 2 * depth,
                "rel_attention_bwd_dkv": 2 * depth}
    expect_counts("SS-MAST at grad_accum_steps 2", counts, finetune_counts(per_step, steps))
    return counts


def finetune_tiny_config(augment: bool = True) -> dict:
    """mast_ft.yaml at MAST tiny, f32, 64 mels x 96 frames (1 s clips), its
    SpecMask scaled to the grid (12 of 64 bins, 18 of 96 frames)."""
    ft = finetune_config()["finetune"]
    ft.update(model_size="tiny", compute_dtype="f32", freqm=12, timem=18)
    ft["input"].update(n_mels=64, target_length=96, length_wave=1.0)
    if not augment:
        ft.update(freqm=0, timem=0, droppath_rate=0.0)
        ft["input"].update(mixup=0.0, noise=False)
    return ft


def finetune_f32_step_check(dev) -> dict[str, float]:
    """One f32 fine-tune step of MAST tiny at B=4 (every augmentation and
    drop path on, the same draws) on the card against the CPU plain path:
    the loss within TOL_MAST_LOSS, each gradient tensor within TOL_MAST_GRAD
    of its max|ref| + 1e-2 of the largest (the SS-MAST rule); a 1e-2 fault
    in each of FT_FAULT_TENSORS must be refused. Then accumulating 2 against
    1 on the card, augmentations and drop path off, within FT_TOL_ACCUM."""
    import copy

    from audiossl_tpu_torch.train import finetune_mast as ftm

    ft = finetune_tiny_config()
    rng = np.random.default_rng(122)
    t = np.arange(16000) / 16000.0
    waves = torch.from_numpy((0.3 * np.sin(2 * np.pi * rng.uniform(100, 900, (4, 1)) * t)
                              + 0.03 * rng.standard_normal((4, 16000))).astype(np.float32))
    targets = torch.from_numpy((rng.uniform(size=(4, 10)) < 0.3).astype(np.float32))
    init = ftm.init_classifier(ft, 10, seed=0, device=torch.device("cpu")).train()
    gen = torch.Generator().manual_seed(5)
    draws = ftm.sample_step_draws(ft, 4, gen)
    n_drop = 2 * sum(1 for blk in init.mast.blocks if blk.droppath > 0)
    drop = [torch.rand(4, generator=gen) for _ in range(n_drop)]

    def on(d, x):  # the draws' tensors on device d
        if isinstance(x, torch.Tensor):
            return x.to(d)
        if x is None:
            return None
        return type(x)(*(on(d, v) for v in x)) if hasattr(x, "_fields") else type(x)(on(d, v) for v in x)

    def grads(d, ft_cfg, accum, step_draws, start=init):
        model = copy.deepcopy(start).to(d)
        step = ftm.FinetuneStep(model, torch.optim.SGD(model.parameters(), lr=0.0), ft_cfg, torch.Generator(d), accum)
        loss = step.loss_and_grads(waves.to(d), targets.to(d), step_draws)
        return float(loss), {n: p.grad.cpu() for n, p in model.named_parameters()}

    loss_card, g_card = grads(dev, ft, 1, [on(dev, draws._replace(drop=drop))])
    loss_cpu, g_cpu = grads(torch.device("cpu"), ft, 1, [draws._replace(drop=drop)])
    largest = max(float(g.abs().max()) for g in g_cpu.values())

    def worst(g):
        rels = {n: float((g[n] - ref).abs().max()) / (float(ref.abs().max()) + 1e-2 * largest) for n, ref in g_cpu.items()}
        name = max(rels, key=rels.get)
        return name, rels[name]

    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    name, rel = worst(g_card)
    print(f"f32 fine-tune step (MAST tiny, B=4, every augmentation on), card vs CPU plain path on the same draws: loss "
          f"{loss_card:.7e} vs {loss_cpu:.7e} (relative {loss_err:.3e}, tol {TOL_MAST_LOSS}); worst gradient tensor {name} "
          f"{rel:.3e} (tol {TOL_MAST_GRAD})")
    if not (loss_err <= TOL_MAST_LOSS and rel <= TOL_MAST_GRAD):
        raise RuntimeError(f"the f32 fine-tune step on the card disagrees with the CPU path: {loss_err}, {name} {rel}")
    for fault in FT_FAULT_TENSORS:
        bad = dict(g_card, **{fault: g_card[fault] * (1.0 + STEP_FAULT)})
        f_name, f_rel = worst(bad)
        print(f"f32 fine-tune gate, {fault} scaled by 1 + {STEP_FAULT}: worst tensor {f_name} {f_rel:.3e} -> refused")
        if f_rel <= TOL_MAST_GRAD:
            raise RuntimeError(f"the f32 fine-tune gate did not refuse a {STEP_FAULT} fault in {fault}: {f_rel}")

    plain = finetune_tiny_config(augment=False)
    start = ftm.init_classifier(plain, 10, seed=0, device=torch.device("cpu")).train()  # drop path 0
    l1, g1 = grads(dev, plain, 1, None, start)
    l2, g2 = grads(dev, plain, 2, None, start)
    big = max(float(g.abs().max()) for g in g1.values())
    acc_rel = max(float((g2[n] - g).abs().max()) / (float(g.abs().max()) + 1e-2 * big) for n, g in g1.items())
    acc_loss = abs(l2 - l1) / abs(l1)
    print(f"fine-tune on the card, accumulating 2 against 1 (augmentations and drop path off): loss relative "
          f"{acc_loss:.3e}, worst gradient tensor {acc_rel:.3e} (tol {FT_TOL_ACCUM})")
    if not (acc_loss <= FT_TOL_ACCUM and acc_rel <= FT_TOL_ACCUM):
        raise RuntimeError(f"accumulating 2 on the card disagrees with 1: {acc_loss}, {acc_rel}")
    return {"loss": loss_err, "worst_tensor": rel, "accum_loss": acc_loss, "accum_worst_tensor": acc_rel}


def finetune_times(dev, card, clips: np.ndarray) -> dict[str, float]:
    """The fine-tune's training clips/s at B=64, bf16, full width
    (configs/mast_ft.yaml) on waves already on the card: the median of 3
    windows of 4 steps on the host clock; the step split by CUDA events
    (mean of 4 steps): frontend + augment (mixup, fbank, mask, norm, noise),
    forward + loss, backward, clip + AdamW; the busy share by torch.profiler;
    the peak memory of the steps; eval clips/s (sigmoid scores, mean of 5
    batches by CUDA events)."""
    from audiossl_tpu_torch.train import finetune_mast as ftm
    from audiossl_tpu_torch.train.layer_decay import adamw_layer_decay

    config = finetune_config()
    run, ft = config["run"], config["finetune"]
    b = int(run["batch_size"])
    model = ftm.init_classifier(ft, FT_CLASSES, seed=0, device=dev).train()
    opt = adamw_layer_decay(model.named_parameters(), float(run["learning_rate"]), ftm.MVIT_DEPTH[ft["model_size"]],
                            float(run["layer_decay"]), float(run["weight_decay"]),
                            clip_grad_norm=float(run["clip_grad_norm"]))
    gen = torch.Generator(dev).manual_seed(0)
    step = ftm.FinetuneStep(model, opt, ft, gen)
    waves = torch.from_numpy(clips[np.arange(b) % len(clips)]).to(dev)
    rng = np.random.default_rng(123)
    targets = torch.from_numpy((rng.uniform(size=(b, FT_CLASSES)) < 3 / FT_CLASSES).astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        loss = step(waves, targets)
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(4):
            loss = step(waves, targets)
        torch.cuda.synchronize()
        rates.append(4 * b / (time.perf_counter() - t0))
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"fine-tune loss became {loss.item()}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    names = ("frontend+augment", "forward+loss", "backward", "clip+AdamW")
    parts = dict.fromkeys(names, 0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    for _ in range(4):
        ev[0].record()
        x, t = step.inputs(waves, targets, ftm.sample_step_draws(ft, b, gen))
        ev[1].record()
        loss = step.forward_loss(x, t, None)
        ev[2].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        for name, e0, e1 in zip(names, ev[:-1], ev[1:]):
            parts[name] += e0.elapsed_time(e1) / 4
    busy = busy_share(lambda: step(waves, targets), 2, card, "MAST-B fine-tune step")
    with torch.inference_mode():
        eval_ms = cuda_ms(lambda: step.scores(waves), iters=5, warmup=2)
    rate = float(np.median(rates))
    print(f"[{card}] MAST-B fine-tune B={b} bf16 128 x 1024 (configs/mast_ft.yaml): train_clips_per_sec {rate:.1f} "
          f"(median of windows {[round(r, 1) for r in rates]}); step split "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f"; peak memory {peak_gib:.2f} GiB; eval {eval_ms:.4f} ms/batch = {b / eval_ms * 1e3:.1f} clips/s")
    return {"train_clips_per_sec": rate, "windows": rates, **{f"{k}_ms": v for k, v in parts.items()},
            "busy": busy, "peak_memory_gib": peak_gib, "eval_ms": eval_ms, "eval_clips_per_sec": b / eval_ms * 1e3}



# ---------------------------------------------------------------- slice 13: host data and data parallelism

ROOT = os.path.dirname(os.path.abspath(__file__))
DDP_WORLD = 2  # gloo ranks sharing the one card (NCCL refuses two ranks on one GPU)
DDP_LR = 0.03  # configs/delores_s.yaml's SGD rate
# the 2-rank DeLoRes-S step against one process at B=256 on the same views and
# dropout masks, bf16: the two differ only in the order of the sums that the
# all-reduces split (BN moments, the Barlow cross-correlation, the gradients),
# and a last-bit change of a BN statistic can move a bf16 rounding downstream.
# One process on the same clips in another row order changes those sums as
# much, so its distance from the one-process step is the yardstick: the loss
# (relative), the whole gradient (relative in norm) and the parameters after
# the step (max|d|) of each rank must land within DDP_SPREAD times it, plus
# f32 round-off (DDP_FLOOR), DDP_SPREAD as the DeLoRes-M trajectory test's
DDP_SPREAD = 4.0
DDP_FLOOR = {"loss": 1e-6, "grad": 1e-5, "param": 1e-7}
# the same step in f32 (the block-1 FFMA kernels, TF32 off), where nothing
# rounds to bf16: the loss and the parameters are held to the CPU
# data-parallel test's fixed 1e-5; the whole gradient to DDP_SPREAD times the
# f32 yardstick plus DDP_FLOOR, since a last-bit change can flip a max-pool's
# routing and move whole gradient entries (the f32 yardstick measured 2.1e-4
# of the norm on the H100, where round-off alone predicted <= 1e-5)
TOL_DDP_F32 = {"loss": 1e-5, "param": 1e-5}
# faults planted in the 2-rank step (the package is not changed: the script
# swaps a collective for the run): SyncBN on each rank's own moments, and the
# gradients summed over the ranks where their mean is due. Each must fail the
# f32 gate, or it cannot see what it is for; whether the bf16 band (wide,
# as bf16 rounding is) sees them too is printed
DDP_FAULTS = ("local_moments", "grad_sum")
DDP_SSMAST_STEPS = 2
# collectives a DeLoRes-S step makes on each rank: SyncBN forward and backward
# per view in block 1 (1 + 1), blocks 2-3 (2 + 2) and the projector (2 + 2);
# the Barlow loss's two moments and cross-correlation (3 + 3); the gradients'
# flat buffer; the loss's mean
DDP_DELORES_S_CALLS = {"syncbn": 20, "barlow": 6, "all_reduce_grads": 1, "all_reduce": 1}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def native_tar_run(wav, tmp: str, dev) -> dict:
    """Phase 29: the native loader, built from the port's csrc/wavloader.cpp,
    decodes as the NumPy path does, gives its batches where no clip is
    longer than the window (no crop draw), and the same batch twice for a
    seed; then DeLoRes-S trains 3 steps through the pretraining CLI on a
    tar-sharded manifest (data/tar.py's write_shards), configs/delores_s.yaml
    as it stands, its loader on the native path (the default wherever the
    library builds), counts from 0. Returns the launches and the seconds."""
    import yaml

    from audiossl_tpu_torch.data import native, tar
    from audiossl_tpu_torch.data.pipeline import ManifestLoader
    from audiossl_tpu_torch.train_upstream import main as upstream_main

    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the native wav loader did not build from audiossl_tpu_torch/csrc/wavloader.cpp")
    build_s = time.perf_counter() - t0
    config = ntt_config("delores_s")
    batch = int(config["run"]["batch_size"])
    plain = write_manifest(tmp, wav, 64)
    files = sorted({line.strip() for line in open(plain).readlines()[1:]})
    for f in files[:4]:
        if not np.array_equal(native.decode(f), wav.load_wave(f)):
            raise RuntimeError(f"the native decode of {f} differs from the NumPy decode")
    long = dict(batch_size=16, clip_samples=40000, sample_rate=16000, shuffle=False)  # 2 s clips in 2.5 s windows
    got = next(iter(ManifestLoader(plain, native=True, **long).epoch(0)))[0]
    want = next(iter(ManifestLoader(plain, num_workers=1, native=False, **long).epoch(0)))[0]
    crop = dict(batch_size=16, clip_samples=CLIP, sample_rate=16000, seed=5)
    twice = [next(iter(ManifestLoader(plain, native=True, **crop).epoch(0)))[0] for _ in range(2)]
    if not (np.array_equal(got, want) and np.array_equal(*twice) and twice[0].any()):
        raise RuntimeError("the native loader's batches differ from the NumPy path's, or from themselves")
    entries = tar.write_shards(files, os.path.join(tmp, "shards"), shard_clips=5)
    sharded = os.path.join(tmp, "sharded.csv")
    with open(sharded, "w") as f:
        f.write("files\n" + "".join(f"{entries[r % len(entries)]}\n" for r in range(batch * TRAIN_STEPS)))
    config["run"].update(save_path=os.path.join(tmp, "tar_delores_s"), epochs=1)
    cfg_path = os.path.join(tmp, "delores_s_native.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logging.getLogger("audiossl_tpu_torch.data").addHandler(handler)
    reset_launches()
    t0 = time.perf_counter()
    try:
        upstream_main(["--upstream", "delores_s", "--input", sharded, "-c", cfg_path, "--max_steps", str(TRAIN_STEPS)])
    finally:
        logging.getLogger("audiossl_tpu_torch.data").removeHandler(handler)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    losses = [line["train_loss"] for line in stats_lines(os.path.join(tmp, "tar_delores_s_chkp"))]
    print(f"host data: native loader built in {build_s:.1f} s ({native.library_path()}); decode = NumPy decode; "
          f"padded batch = NumPy batch; cropped batch twice equal; {len(entries)} clips in "
          f"{len({e.split('::')[0] for e in entries})} tar shards; DeLoRes-S B={batch} through the CLI on the sharded "
          f"manifest: {TRAIN_STEPS} steps in {seconds:.1f} s, losses {losses}, loader log {seen}, launches {counts}")
    if not any("native C++ decode" in m for m in seen):
        raise RuntimeError(f"the CLI's loader did not take the native path: {seen}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"the tar-sharded DeLoRes-S run logged losses {losses}")
    expect_counts(f"DeLoRes-S on tar shards, {TRAIN_STEPS} steps", counts,
                  {k: n * TRAIN_STEPS for k, n in zip(NTT_KERNELS, TRAIN_LAUNCHES["delores_s"])})
    return {"counts": counts, "seconds": seconds, "build_s": build_s}


@contextlib.contextmanager
def planted_fault(fault: str | None):
    """``fault`` planted in the package's collectives for the block: SyncBN
    on local moments (the BN all-reduces skipped), or the gradients' sum
    over the group in place of their mean."""
    from audiossl_tpu_torch.parallel import dist

    saved = dist.all_reduce_mean, dist.all_reduce_sum, dist.all_reduce_grads_
    if fault == "local_moments":
        dist.all_reduce_mean = lambda x, kind="all_reduce": x if kind == "syncbn" else saved[0](x, kind)
        dist.all_reduce_sum = lambda x, kind="all_reduce": x if kind == "syncbn" else saved[1](x, kind)
    elif fault == "grad_sum":
        def summed(params):
            params = list(params)
            saved[2](params)
            for p in params:
                if p.grad is not None:
                    p.grad *= dist.world()
        dist.all_reduce_grads_ = summed
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        dist.all_reduce_mean, dist.all_reduce_sum, dist.all_reduce_grads_ = saved


def step_distance(a: dict, b: dict) -> dict[str, float]:
    """Step ``a`` from step ``b``: the loss (relative), the whole gradient
    (relative in norm) and the parameters after the step (max|d|)."""
    ga = torch.cat([v.flatten() for v in a["grads"].values()])
    gb = torch.cat([b["grads"][k].flatten() for k in a["grads"]])
    return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]), "grad": float((ga - gb).norm() / gb.norm()),
            "param": max(float((a["params"][k] - v).abs().max()) for k, v in b["params"].items())}


def ddp_delores_s_step(waves: np.ndarray, dev, timed: bool = False, perm: np.ndarray | None = None,
                       f32: bool = False, fault: str | None = None) -> dict:
    """One DeLoRes-S SGD step at full width (configs/delores_s.yaml, bf16 or
    with ``f32`` in f32, seed TRAIN_SEED) on this process's share of
    ``waves``, ``fault`` planted (planted_fault): every process
    makes the views of the whole batch with one generator (seed 0; the
    log-mel kernel once) and takes its rows; the two dropout masks are the
    one-process run's, drawn from a generator of seed 1, at this process's
    rows; then TrainStep's loss and all-reduced gradients and the update.
    Counts from 0. ``perm`` reorders the batch's rows (views and masks
    alike) before the step. ``timed``: then 3 more steps on host clocks and
    the busy share of 2 by torch.profiler."""
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.parallel import dist
    from audiossl_tpu_torch.train.optim import sgd_torch
    from audiossl_tpu_torch.train.step import TrainStep

    cfg = ntt_config("delores_s")
    pre = cfg["pretrain"]
    if f32:
        pre["base_encoder"]["compute_dtype"] = "float32"
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    obj = init_objective("delores_s", cfg, seed=TRAIN_SEED, device=dev).train()
    step = TrainStep(obj, pipeline, frontend, sgd_torch([p for p in obj.parameters() if p.requires_grad], DDP_LR),
                     torch.Generator(dev).manual_seed(0))
    state = pipeline.init_state(frontend.n_mels, frontend.num_frames(CLIP), dev)
    n = waves.shape[0]
    rows = slice(dist.rank() * n // dist.world(), (dist.rank() + 1) * n // dist.world())
    d, rate = obj.encoder.d, obj.encoder.fc[2].p
    g = torch.Generator(dev).manual_seed(1)
    masks = [torch.rand((n, frontend.num_frames(CLIP) // 8, d), generator=g, device=dev) < 1.0 - rate
             for _ in range(2)]
    calls = iter(masks)
    original = AudioNTT2020Task6._dropout
    AudioNTT2020Task6._dropout = lambda self, h, generator: torch.where(next(calls)[rows], h / (1.0 - rate), 0.0)
    reset_launches()
    dist.calls.clear()
    try:
        state, v1, v2 = step.views(state, torch.from_numpy(waves).to(dev))
        if perm is not None:
            order = torch.from_numpy(perm).to(dev)
            v1, v2, masks[:] = v1[order], v2[order], [m[order] for m in masks]
        with planted_fault(fault):
            loss = step.loss_and_grads(v1[rows], v2[rows])
    finally:
        AudioNTT2020Task6._dropout = original
    grads = {k: p.grad.detach().float().cpu().clone() for k, p in obj.named_parameters()}
    step.update()
    torch.cuda.synchronize()
    out = {"loss": float(loss), "grads": grads, "counts": read_launches(), "calls": dict(dist.calls),
           "params": {k: p.detach().float().cpu().clone() for k, p in obj.named_parameters()}}
    if timed:
        v1, v2 = v1[rows], v2[rows]
        step_s = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step.loss_and_grads(v1, v2)
            step.update()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                step.loss_and_grads(v1, v2)
                step.update()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = sum(device_kernels_us(prof.key_averages()).values())
        out.update(step_ms=float(np.median(step_s[1:])) * 1e3, busy=busy / wall_us if busy else None)
    return out


def ddp_ssmast_run(tmp: str, csv: str, rank: int, shuffle: bool, steps: int, dev) -> dict:
    """SS-MAST through train_upstream on configs/ssmast.yaml as it stands
    (with ``shuffle``: a copy with pretrain.shuffle_bn true) in this rank's
    group, ``steps`` steps, counts from 0; every enqueue's local keys are
    recorded (``queue_update`` wrapped) for the parent to find in the
    checkpoint's queue."""
    from audiossl_tpu_torch.objectives import ssmast
    from audiossl_tpu_torch.parallel import dist
    from audiossl_tpu_torch.train.loop import train_upstream

    config = ssmast_config()
    name = "ssmast_shuffle" if shuffle else "ssmast"
    config["pretrain"]["shuffle_bn"] = shuffle
    config["run"].update(save_path=os.path.join(tmp, name), epochs=1)
    keys, original = [], ssmast.queue_update
    ssmast.queue_update = lambda queue, ptr, k: (keys.append(k.detach().float().cpu()), original(queue, ptr, k))[1]
    reset_launches()
    dist.calls.clear()
    t0 = time.perf_counter()
    try:
        obj, step, ckpt_dir = train_upstream(config, csv, "ssmast", max_steps=steps, device=dev)
    finally:
        ssmast.queue_update = original
    torch.cuda.synchronize()
    return {"keys": keys, "counts": read_launches(), "calls": dict(dist.calls), "step": step, "ckpt_dir": ckpt_dir,
            "queue": obj.queue.float().cpu(), "ptr": int(obj.queue_ptr), "seconds": time.perf_counter() - t0}


def ddp_rank(rank: int, world: int, port: int, in_path: str, out_dir: str) -> None:
    """One gloo rank on the one card (phases 30-31): the DeLoRes-S step on
    its half of the batch (bf16, f32, and with each planted fault), each
    held against the parent's one-process step, 2 steps of train_upstream on
    DeLoRes-S at world 2,
    and SS-MAST through train_upstream (then with shuffle-BN); the results to
    ``out_dir/rank<r>.pt``. Gloo is chosen here, by the script: the package
    takes NCCL for CUDA, which refuses two ranks on one GPU."""
    sys.path.insert(0, ROOT)
    logging.basicConfig(level=logging.WARNING)
    from audiossl_tpu_torch.train.loop import train_upstream

    d = torch.load(in_path, weights_only=False)
    dev = torch.device(d["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:  # the kernels load from the parent's build at first launch
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        ref = torch.load(d["ref"], weights_only=False)
        brief = lambda st, prec: {"err": step_distance(st, ref[prec]), **{k: v for k, v in st.items()
                                                                          if k not in ("grads", "params")}}
        out = {"delores_s_step": brief(ddp_delores_s_step(d["waves"], dev, timed=True), "bf16"),
               "delores_s_f32": brief(ddp_delores_s_step(d["waves"], dev, f32=True), "f32"),
               "faults": {f"{prec} {fault}": brief(ddp_delores_s_step(d["waves"], dev, f32=prec == "f32",
                                                                      fault=fault), prec)["err"]
                          for prec in ("bf16", "f32") for fault in DDP_FAULTS}}
        config = ntt_config("delores_s")
        config["run"].update(save_path=os.path.join(d["tmp"], "ddp_delores_s"), epochs=1)
        reset_launches()
        _, step, _ = train_upstream(config, d["ntt_csv"], "delores_s", max_steps=2, device=dev)
        out["delores_s_loop"] = {"step": step, "counts": read_launches()}
        out["ssmast"] = ddp_ssmast_run(d["tmp"], d["mast_csv"], rank, False, DDP_SSMAST_STEPS, dev)
        out["ssmast_shuffle"] = ddp_ssmast_run(d["tmp"], d["mast_csv"], rank, True, 1, dev)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def ddp_runs(pool: np.ndarray, wav, tmp: str, dev, card) -> dict:
    """Phases 30-31: two gloo ranks share the card (one spawn). (b) DeLoRes-S
    at full width, global B=256, 128 clips a rank: the bf16 step equals one
    process's B=256 step on the same views and masks within DDP_SPREAD times
    the yardstick, the f32 step within TOL_DDP_F32 and that band of the f32
    yardstick, which each planted fault (DDP_FAULTS) must fail; the launches per rank exact (log-mel 1 for the
    whole batch's views, block 1 2 / 2 / 2), the collectives per rank exact
    (DDP_DELORES_S_CALLS); then
    train_upstream at world 2 (host_shard, batch // world), 2 steps: 1 / 2 /
    2 / 2 a step a rank, rank 0's checkpoint holding both ranks' augmentation
    state. (c) SS-MAST on configs/ssmast.yaml as it stands (B=64, 32 a rank,
    batched views) for 2 steps, then with shuffle-BN (sequential views) for
    1: the checkpoint's queue holds both ranks' keys in JAX's order; the
    launches per rank exact."""
    ntt_csv = write_manifest(tmp, wav, 2 * int(ntt_config("delores_s")["run"]["batch_size"]))
    mast_batch = int(ssmast_config()["run"]["batch_size"])
    mast_csv = ssmast_wavs(tmp, wav, DDP_SSMAST_STEPS * mast_batch)
    waves = pool[:SERVE_BATCH]
    # (b)'s references, before the ranks start: one process's step in bf16 and
    # in f32, and the yardstick, one process on the same rows in another order
    perm = np.random.default_rng(7).permutation(waves.shape[0])
    one = {"bf16": ddp_delores_s_step(waves, dev), "f32": ddp_delores_s_step(waves, dev, f32=True)}
    spread = {prec: step_distance(ddp_delores_s_step(waves, dev, perm=perm, f32=prec == "f32"), ref)
              for prec, ref in one.items()}
    bound = {k: DDP_SPREAD * v + DDP_FLOOR[k] for k, v in spread["bf16"].items()}
    bound32 = {**TOL_DDP_F32, "grad": DDP_SPREAD * spread["f32"]["grad"] + DDP_FLOOR["grad"]}
    torch.save(one, os.path.join(tmp, "ddp_ref.pt"))
    del one
    torch.save({"waves": waves, "tmp": tmp, "ntt_csv": ntt_csv, "mast_csv": mast_csv, "device": str(dev),
                "ref": os.path.join(tmp, "ddp_ref.pt")}, os.path.join(tmp, "ddp_in.pt"))
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(ddp_rank, args=(DDP_WORLD, free_port(), os.path.join(tmp, "ddp_in.pt"), tmp),
                                nprocs=DDP_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(DDP_WORLD)]

    fmt = lambda e: f"loss rel {e['loss']:.2e}, gradient rel norm {e['grad']:.3e}, params max|d| {e['param']:.3e}"
    for prec, e in spread.items():
        print(f"[{card}] DeLoRes-S B=256 {prec}, one process in another row order against one process: {fmt(e)}")
    report = {"one_process_reordered": spread["bf16"], "one_process_reordered_f32": spread["f32"], "bound_f32": bound32}
    step_counts = {"log_mel_fused": 1, "block1_fwd": 2, "block1_bwd_sums": 2, "block1_bwd_weight": 2}
    for r, res in enumerate(ranks):
        st, st32 = res["delores_s_step"], res["delores_s_f32"]
        err, err32 = st["err"], st32["err"]
        print(f"[{card}] DeLoRes-S data parallel, rank {r} of {DDP_WORLD} (gloo, both ranks on this one card), "
              f"B=256 as 2 x 128, bf16, against one process: loss {st['loss']:.6f} (rel "
              f"{err['loss']:.2e}, tol {bound['loss']:.2e}); gradient rel norm {err['grad']:.3e} (tol "
              f"{bound['grad']:.3e}); params after the step max|d| {err['param']:.3e} (tol {bound['param']:.3e}); "
              f"launches {st['counts']}; collectives {st['calls']}; step {st['step_ms']:.1f} ms = "
              f"{128 / st['step_ms'] * 1e3:.1f} clips/s for this rank's 128 (two ranks sharing one card over gloo: "
              f"not a multi-GPU rate); busy " + (f"{st['busy']:.1%}" if st["busy"] is not None else "not measured"))
        print(f"[{card}] the same in f32, rank {r}: {fmt(err32)} (tol {bound32}); launches {st32['counts']}")
        failures = []
        if not all(err[k] <= bound[k] for k in err):
            failures.append(f"rank {r}'s DeLoRes-S step strays from one process's: {err} against {bound}")
        if not all(err32[k] <= bound32[k] for k in err32):
            failures.append(f"rank {r}'s f32 DeLoRes-S step strays from one process's: {err32} against {bound32}")
        for name, e in res["faults"].items():
            gate = bound if name.startswith("bf16") else bound32
            caught = [k for k in e if e[k] > gate[k]]
            print(f"[{card}] planted fault, rank {r}, {name}: {fmt(e)}; "
                  + (f"fails the {name.split()[0]} gate on {caught}" if caught else f"passes the {name.split()[0]} gate"))
            if name.startswith("f32") and not caught:
                failures.append(f"the f32 gate does not catch the planted fault {name}: {e}")
        if failures:
            raise RuntimeError("; ".join(failures))
        for key, res_st in (("bf16", st), ("f32", st32)):
            expect_counts(f"DeLoRes-S step {key}, rank {r}", res_st["counts"], step_counts)
            if res_st["calls"] != DDP_DELORES_S_CALLS:
                raise RuntimeError(f"rank {r}'s {key} DeLoRes-S step made collectives {res_st['calls']}, "
                                   f"expected {DDP_DELORES_S_CALLS}")
        loop = res["delores_s_loop"]
        expect_counts(f"train_upstream delores_s at world {DDP_WORLD}, rank {r}", loop["counts"],
                      {k: 2 * n for k, n in zip(NTT_KERNELS, TRAIN_LAUNCHES["delores_s"])})
        report[f"rank{r}"] = {**{f"{k}_err": v for k, v in err.items()}, **{f"{k}_err_f32": v for k, v in err32.items()},
                              "faults": res["faults"], "step_ms": st["step_ms"], "busy": st["busy"],
                              "calls": st["calls"]}
    saved = torch.load(os.path.join(tmp, "ddp_delores_s_chkp", "state", "2.pt"), map_location="cpu", weights_only=True)
    aug = saved["augment"]
    if aug["world"] != DDP_WORLD or aug["mixup"]["bank"].shape[0] != DDP_WORLD or len(saved["generator"]) != DDP_WORLD:
        raise RuntimeError(f"the world-2 checkpoint's augmentation state is not world-sized: {aug['world']}")
    print(f"DeLoRes-S train_upstream at world {DDP_WORLD}: 2 steps a rank, launches a rank "
          f"{ranks[0]['delores_s_loop']['counts']}; rank 0's checkpoint holds the mixup banks "
          f"{tuple(aug['mixup']['bank'].shape)} and {len(saved['generator'])} generators; spawn + all phases {spawn_s:.1f} s")

    # (c) SS-MAST: the queue holds both ranks' keys in JAX's (rank) order
    depth = 24
    for name, steps, fwd, bwd in (("ssmast", DDP_SSMAST_STEPS, 2 * depth, depth), ("ssmast_shuffle", 1, 4 * depth,
                                                                                   2 * depth)):
        saved = torch.load(os.path.join(ranks[0][name]["ckpt_dir"], "state", f"{steps}.pt"), map_location="cpu",
                           weights_only=True)
        queue, ptr = saved["objective"]["queue"].float(), 0
        for k0, k1 in zip(ranks[0][name]["keys"], ranks[1][name]["keys"]):
            both = torch.cat([k0, k1])
            if not torch.equal(queue[:, ptr:ptr + both.shape[0]].T, both):
                raise RuntimeError(f"{name}: the queue at {ptr} does not hold rank 0's then rank 1's keys")
            ptr += both.shape[0]
        if int(saved["objective"]["queue_ptr"]) != ptr or ptr != steps * 2 * mast_batch:
            raise RuntimeError(f"{name}: the queue pointer is {int(saved['objective']['queue_ptr'])}, expected {ptr}")
        if not torch.equal(ranks[0][name]["queue"], ranks[1][name]["queue"]):
            raise RuntimeError(f"{name}: the two ranks' queues differ")
        for r, res in enumerate(ranks):
            expect_counts(f"{name} at world {DDP_WORLD}, rank {r}", res[name]["counts"],
                          {"fused_rows_kaldi": steps, "rel_attention_fwd": steps * fwd,
                           "rel_attention_bwd_dq": steps * bwd, "rel_attention_bwd_dkv": steps * bwd})
        print(f"{name} through train_upstream at world {DDP_WORLD} ({mast_batch // DDP_WORLD} clips a rank): {steps} "
              f"step(s); the queue holds both ranks' keys in rank order at columns 0..{ptr} ({len(ranks[0][name]['keys'])} "
              f"enqueues of {2 * ranks[0][name]['keys'][0].shape[0]}); launches a rank {ranks[0][name]['counts']}; "
              f"collectives a rank {ranks[0][name]['calls']}; {ranks[0][name]['seconds']:.1f} s on rank 0")
        report[name] = {"counts_per_rank": ranks[0][name]["counts"], "calls_per_rank": ranks[0][name]["calls"],
                        "steps": steps}
    report["delores_s_counts_per_rank"] = ranks[0]["delores_s_step"]["counts"]
    report["delores_s_loop_counts_per_rank"] = ranks[0]["delores_s_loop"]["counts"]
    return report


def nccl_world_one_check(pool: np.ndarray, dev) -> dict:
    """Phase 32: the NCCL group of one process, joined through
    ``maybe_init_distributed()`` from torchrun-style env, gives the DeLoRes-S
    step's bits without a group (every helper is the identity at world 1)."""
    from audiossl_tpu_torch.parallel import dist, launch

    waves = pool[:64]
    alone = ddp_delores_s_step(waves, dev)
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    if not launch.maybe_init_distributed(dev, env=env):
        raise RuntimeError("maybe_init_distributed did not join the torchrun-style group")
    try:
        backend, world = torch.distributed.get_backend(), dist.world()
        grouped = ddp_delores_s_step(waves, dev)
    finally:
        torch.distributed.destroy_process_group()
    same = alone["loss"] == grouped["loss"] and all(torch.equal(v, grouped["grads"][k]) for k, v in alone["grads"].items()) \
        and all(torch.equal(v, grouped["params"][k]) for k, v in alone["params"].items())
    print(f"{backend} at world 1 (from torchrun env): the DeLoRes-S step on 64 clips gives "
          f"{'the same bits as' if same else 'OTHER bits than'} no process group; collectives {grouped['calls']}")
    if backend != launch.backend_for(dev) or world != 1 or not same or grouped["calls"]:
        raise RuntimeError("the NCCL group of one process changed the step")
    return {"backend": backend, "same_bits": same}


# ---------------------------------------------------------------- slice 14: tensor parallelism

TP = 2  # the model axis: 2 gloo ranks share the card (NCCL refuses two ranks on one GPU)
TP_DP = 2  # the data axis of the dp x tp gate (4 ranks)
TP_SSMAST_STEPS = 2  # then a resume to TP_SSMAST_STEPS + 1
TP_AST_STEPS = 2  # 3 before the sharded-state phases, cut to keep the script inside its time
AST_TP_SHAPE = (AST_BATCH * 12 // TP, 1214, 64)  # each rank's attention at AST-base, B=32: 6 of the 12 heads
# the f32 gates: the tp step against one process on the same inputs, held to
# DDP_SPREAD times one process's distance from itself on the same rows in
# another order (the sums split otherwise, as tp splits them), plus f32
# round-off (DDP_FLOOR): the loss (relative) and the whole gradient
# (relative in norm); faults planted in the package's tp primitives and
# collectives for the run, each of which the gate must catch
TP_FAULTS = ("sum_backward_reduce", "world_grad_mean")
TP_GATE_BATCH = 4
AST_GATE_FRAMES = AST_CLIP // 160 + 1  # 1025 frames: 1214 tokens, the streamed f32 attention


def tp_ssmast_gate_config() -> dict:
    """SS-MAST on MAST tiny, f32, drop path 0, 64 x 96 views, a 64-key queue."""
    cfg = ssmast_config()
    cfg["pretrain"].update(model_size="tiny", droppath_rate=0.0, compute_dtype="f32", num_negatives=64)
    cfg["pretrain"]["input"].update(n_mels=64, target_length=96)
    return cfg


class ASTGate(torch.nn.Module):
    """AST at tiny's width with 4 heads (tiny's 3 do not divide by 2), depth
    2, at the probe's 128 x 1025 input (1214 tokens), f32 attention, and a
    4-class linear head: the downstream.tp path's model, small."""

    def __init__(self):
        from audiossl_tpu_torch.models.ast import ASTConfig, ASTEncoder

        super().__init__()
        self.encoder = ASTEncoder(128, AST_GATE_FRAMES, ASTConfig(embed_dim=192, num_heads=4, depth=2),
                                  attention_dtype=torch.float32)
        self.final = torch.nn.Linear(192, 4)

    def forward(self, x):
        return self.final(self.encoder(x))


@contextlib.contextmanager
def planted_tp_fault(fault: str | None):
    """``fault`` planted in the package for the block: the all-reduce after a
    row-parallel layer with a summed backward, or the gradients' mean over
    the whole world (mixing shards of one weight) in place of the data
    axis's."""
    from audiossl_tpu_torch.parallel import dist
    from audiossl_tpu_torch.parallel import tp as tpar

    class SumBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            out = x.detach().clone().contiguous()
            torch.distributed.all_reduce(out, group=dist.model_group())
            return out

        @staticmethod
        def backward(ctx, g):
            out = g.detach().clone().contiguous()
            torch.distributed.all_reduce(out, group=dist.model_group())
            return out

    def world_mean(params):
        params = [p for p in params if p.requires_grad]
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1).float() for p in params])
        torch.distributed.all_reduce(flat)
        flat /= dist.world()
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p).to(p.dtype)
            off += p.numel()

    saved = tpar.reduce_from_model, dist.all_reduce_grads_
    if fault == "sum_backward_reduce":
        tpar.reduce_from_model = lambda x: SumBackward.apply(x) if dist.tp_world() > 1 else x
    elif fault == "world_grad_mean":
        dist.all_reduce_grads_ = world_mean
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        tpar.reduce_from_model, dist.all_reduce_grads_ = saved


def tp_gate_step(kind: str, inputs: dict, dev, perm: np.ndarray | None = None, fault: str | None = None) -> dict:
    """One f32 step of ``kind`` ("ssmast": MAST tiny through TrainStep's
    loss, backward and all-reduces; "ast": ASTGate, cross-entropy) on this
    rank's share of the inputs over the data axis and its shards over the
    model axis (one process: the whole model and batch), ``fault`` planted,
    ``perm`` reordering the batch's rows first; seeded weights alike on
    every rank. The loss (the data axis's mean) and the whole gradients."""
    from audiossl_tpu_torch import no_tf32
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.parallel import dist
    from audiossl_tpu_torch.parallel import tp as tpar
    from audiossl_tpu_torch.parallel.tp_ast import ast_spec, shard_ast_
    from audiossl_tpu_torch.parallel.tp_mvit import mvit_spec, shard_mvit_
    from audiossl_tpu_torch.train.step import TrainStep

    rows = (lambda x: x) if perm is None else (lambda x: x[perm])
    share = lambda x: dist.share(torch.from_numpy(np.ascontiguousarray(rows(x)))).to(dev)  # noqa: E731
    dist.calls.clear()
    reset_launches()
    if kind == "ssmast":
        obj = init_objective("ssmast", tp_ssmast_gate_config(), seed=0).to(dev).train()
        shard_mvit_(obj)
        opt = torch.optim.AdamW([p for p in obj.parameters() if p.requires_grad], lr=3e-4)
        with planted_tp_fault(fault):
            loss = TrainStep(obj, None, None, opt, torch.Generator(dev).manual_seed(0)).loss_and_grads(
                share(inputs["v1"]), share(inputs["v2"]))
        named, spec_of = obj.named_parameters(), mvit_spec
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = ASTGate()
        model = model.to(dev).train()
        shard_ast_(model.encoder)
        with planted_tp_fault(fault), no_tf32():
            loss = torch.nn.functional.cross_entropy(model(share(inputs["x"])), share(inputs["labels"]))
            loss.backward()
            dist.all_reduce_grads_(model.parameters())
            loss = dist.all_reduce_mean(loss.detach())
        named, spec_of = model.named_parameters(), ast_spec
    grads = {n: tpar.gather_from_ranks(p.grad, spec_of(n)).float().cpu() for n, p in named if p.grad is not None}
    torch.cuda.synchronize()
    return {"loss": float(loss), "grads": grads, "calls": dict(dist.calls), "counts": read_launches()}


def tp_gate_inputs() -> dict:
    """The gates' inputs from a generator of their own: MAST tiny's two
    views, AST's 128 x 1025 views and labels."""
    rng = np.random.default_rng(141)
    return {"ssmast": {"v1": rng.standard_normal((TP_GATE_BATCH, 1, 64, 96)).astype(np.float32),
                       "v2": rng.standard_normal((TP_GATE_BATCH, 1, 64, 96)).astype(np.float32)},
            "ast": {"x": rng.standard_normal((TP_GATE_BATCH, 1, 128, AST_GATE_FRAMES)).astype(np.float32),
                    "labels": np.arange(TP_GATE_BATCH) % 4}}


def tp_gate_distance(a: dict, b: dict) -> dict[str, float]:
    """Step ``a`` from step ``b``: the loss (relative) and the whole gradient
    (relative in norm)."""
    ga = torch.cat([v.flatten() for v in a["grads"].values()])
    gb = torch.cat([b["grads"][k].flatten() for k in a["grads"]])
    return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]), "grad": float((ga - gb).norm() / gb.norm())}


def tp_gates(inputs: dict, dev) -> dict:
    """This rank's gate steps, correct and with each planted fault."""
    out = {}
    for kind in ("ssmast", "ast"):
        out[kind] = tp_gate_step(kind, inputs[kind], dev)
        for fault in TP_FAULTS:
            out[f"{kind} {fault}"] = tp_gate_step(kind, inputs[kind], dev, fault=fault)
    return out


def tp_capture_optimizer():
    """Patch train/loop.py's build_optimizer to keep the optimizers it builds
    (their moments' shapes per rank); returns the list and the restorer."""
    from audiossl_tpu_torch.train import loop

    built, original = [], loop.build_optimizer

    def keep(*args, **kw):
        built.append(original(*args, **kw))
        return built[-1]

    loop.build_optimizer = keep
    return built, lambda: setattr(loop, "build_optimizer", original)


def tp_ssmast_times(obj, config, dev, card, rank: int) -> dict:
    """This rank's SS-MAST step at tp (B=64 bf16, waves on the card):
    TrainStep with a fresh AdamW over its shards, timed by tp_step_times."""
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.train.step import TrainStep

    pre = config["pretrain"]
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    opt = torch.optim.AdamW([p for p in obj.parameters() if p.requires_grad], lr=3e-4, weight_decay=0.0)
    step = TrainStep(obj, pipeline, frontend, opt, torch.Generator(dev).manual_seed(0), None,
                     str(pre.get("normalization", "mean_var")))
    waves = torch.from_numpy(np.random.default_rng(143).standard_normal((MAST_BATCH, MAST_CLIP)).astype(np.float32)
                             * 0.3).to(dev)
    state = pipeline.init_state(frontend.n_mels, frontend.num_frames(MAST_CLIP), dev)
    return tp_step_times(lambda: step(state, waves), dev, card, f"SS-MAST pretrain.tp {TP}, rank {rank}", MAST_BATCH)


def tp_step_times(fn, dev, card, label: str, batch: int) -> dict:
    """A warm-up, the busy share of 1 step by torch.profiler (and the
    collectives a step), then 2 steps on the host clock (their median: the
    mean; 2 profiled and 3 timed before the script's time grew past 1000 s
    with the sharded-state phases)."""
    from audiossl_tpu_torch.parallel import dist

    dist.calls.clear()
    busy = busy_share(fn, 1, card, label)  # a warm-up and 1 call
    calls = {k: v / 2 for k, v in dist.calls.items()}
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    print(f"[{card}] {label}: step {ms:.1f} ms (median of 2; {[round(t * 1e3, 1) for t in times]}) = "
          f"{batch / ms * 1e3:.1f} clips/s of the model group's {batch}, collectives a step {calls} "
          f"(half of them each way; gloo through the host, two ranks sharing one card: not an NVLink rate); busy "
          + (f"{busy:.1%}" if busy is not None else "not measured"))
    return {"step_ms": ms, "step_ms_each": [t * 1e3 for t in times], "busy": busy, "calls_per_step": calls}


def tp_rank(rank: int, world: int, port: int, in_path: str, out_dir: str) -> None:
    """One gloo rank of a (world // TP) x TP grid on the one card: the f32
    gates; at world TP also SS-MAST at pretrain.tp through train_upstream
    (then a resume) and AST-base at downstream.tp through train_downstream
    (fine-tuned, then frozen), with their step times. At world 1, only
    SS-MAST's one-process peak memory, in a process of its own as each rank
    is. Results to ``out_dir/rank<r>.pt``. Gloo is the script's choice (NCCL
    refuses two ranks on one GPU; the package takes NCCL for CUDA)."""
    sys.path.insert(0, ROOT)
    logging.basicConfig(level=logging.WARNING)
    from audiossl_tpu_torch.parallel import dist

    d = torch.load(in_path, weights_only=False)
    dev = torch.device(d["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:  # the kernels load from the parent's build at first launch
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        if world == 1:
            torch.save({"ssmast_peak_bytes": one_process_ssmast_peak(d, dev)}, os.path.join(out_dir, "rank0.pt"))
            return
        dist.set_tp(TP)
        out = {"grid": (dist.dp_rank(), dist.tp_rank()), "gates": tp_gates(d["gates"], dev)}
        if world == TP:
            out.update(tp_ssmast_run(d, rank, dev))
            out.update(tp_ast_run(d, rank, dev))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def one_process_ssmast_peak(d: dict, dev) -> int:
    """SS-MAST through train_upstream on configs/ssmast.yaml as tp_ssmast_run
    takes it, at pretrain.tp 1, TP_SSMAST_STEPS steps: the peak device bytes
    above what the process held when it started."""
    from audiossl_tpu_torch.train.loop import train_upstream

    config = ssmast_config()
    config["run"].update(save_path=os.path.join(d["tmp"], "one_process_ssmast"), epochs=1)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_upstream(config, d["mast_csv"], "ssmast", max_steps=TP_SSMAST_STEPS, device=dev)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def tp_ssmast_run(d: dict, rank: int, dev) -> dict:
    """SS-MAST through train_upstream on a copy of configs/ssmast.yaml with
    pretrain.tp 2 (B=64, bf16, MViTv2-B), TP_SSMAST_STEPS steps, counts from
    0, peak memory above what the rank held before (the gates' leftovers);
    the shards and moments this rank held; then a resume from its
    checkpoint to one step more; then the step's times."""
    from audiossl_tpu_torch.train.loop import train_upstream

    config = ssmast_config()
    config["pretrain"]["tp"] = TP
    config["run"].update(save_path=os.path.join(d["tmp"], "tp_ssmast"), epochs=1)
    built, restore = tp_capture_optimizer()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        obj, step, ckpt_dir = train_upstream(config, d["mast_csv"], "ssmast", max_steps=TP_SSMAST_STEPS, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, peak = read_launches(), torch.cuda.max_memory_allocated() - base
        opt = built[0][0]
        blk = obj.encoder.mast.blocks[5]  # stage 2's first block: dim 192 -> 384
        shapes = {"qkv": tuple(blk.attn.qkv.weight.shape), "attn.proj": tuple(blk.attn.proj.weight.shape),
                  "mlp.fc1": tuple(blk.mlp.fc1.weight.shape), "mlp.fc2": tuple(blk.mlp.fc2.weight.shape),
                  "key qkv": tuple(obj.encoder_k.mast.blocks[5].attn.qkv.weight.shape),
                  "qkv exp_avg": tuple(opt.state[blk.attn.qkv.weight]["exp_avg"].shape),
                  "fc2 exp_avg_sq": tuple(opt.state[blk.mlp.fc2.weight]["exp_avg_sq"].shape)}
        params = sum(p.numel() for p in obj.encoder.parameters())
        reset_launches()
        obj2, step2, _ = train_upstream(config, d["mast_csv"], "ssmast", load_checkpoint=ckpt_dir,
                                        max_steps=TP_SSMAST_STEPS + 1, device=dev)
        torch.cuda.synchronize()
        resume_counts = read_launches()
    finally:
        restore()
    del obj
    times = tp_ssmast_times(obj2, config, dev, d["card"], rank)
    return {"ssmast": {"step": step, "counts": counts, "seconds": seconds, "peak_bytes": peak, "shapes": shapes,
                       "encoder_params_held": params, "ckpt_dir": ckpt_dir, "resume_step": step2,
                       "resume_counts": resume_counts, "times": times}}


def tp_ast_run(d: dict, rank: int, dev) -> dict:
    """AST-base through train_downstream at downstream.tp 2 (ast_config,
    B=32, 128 mels x 1025 frames): TP_AST_STEPS steps and one eval batch,
    counts from 0, then the same with --freeze; the shards this rank held;
    then the fine-tuned step's times on device-resident waves."""
    import yaml

    from audiossl_tpu_torch.downstream.probe import features, probe_step
    from audiossl_tpu_torch.frontend.stft import LogMelConfig
    from audiossl_tpu_torch.train_downstream import main as downstream_main

    out = {}
    for mode in ("finetune", "freeze"):
        config, _ = ast_config(d["tmp"])
        config["downstream"]["tp"] = TP
        path = os.path.join(d["tmp"], f"ast_tp_{mode}.yaml")
        if rank == 0:
            with open(path, "w") as f:
                yaml.safe_dump(config, f)
        torch.distributed.barrier()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        result = downstream_main(["--task", f"ast_tp_{mode}", "--train_csv", d["ast_train"], "--test_csv", d["ast_test"],
                                  "-c", path, "--encoder", "AST", "--epochs", "1", "--exp_dir",
                                  os.path.join(d["tmp"], "exp"), "--device", str(dev)]
                                 + (["--freeze"] if mode == "freeze" else []))
        torch.cuda.synchronize()
        model = result["model"]
        out[f"ast_{mode}"] = {"counts": read_launches(), "seconds": time.perf_counter() - t0,
                              "losses": result["losses"], "history": result["history"],
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "qkv": tuple(model.encoder.blocks[0].attn.qkv.weight.shape),
                              "fc1": tuple(model.encoder.blocks[0].mlp.fc1.weight.shape)}
        if mode == "finetune":
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            mel = LogMelConfig(sample_rate=16000, n_mels=int(config["downstream"]["input"]["n_mels"]))
            waves = torch.from_numpy(np.random.default_rng(145).standard_normal((AST_BATCH, AST_CLIP)).astype(np.float32)
                                     * 0.3).to(dev)
            labels = torch.arange(AST_BATCH, device=dev) % 4
            features(waves, mel)
            out["ast_finetune"]["times"] = tp_step_times(lambda: probe_step(model, opt, mel, waves, labels), dev,
                                                         d["card"], f"AST-base downstream.tp {TP}, rank {rank}",
                                                         AST_BATCH)
        del model, result
    return out


def tp_expected(kind: str) -> dict[str, int]:
    """Launches a rank, a step (and an eval batch), of each tp path."""
    depth = 24
    return {"ssmast": {"fused_rows_kaldi": 1, "rel_attention_fwd": 2 * depth, "rel_attention_bwd_dq": depth,
                       "rel_attention_bwd_dkv": depth},
            "ast_step": {"log_mel_fused": 1, **dict.fromkeys(ATTN_KERNELS, AST_DEPTH)},
            "ast_freeze_step": {"log_mel_fused": 1, "rel_attention_fwd": AST_DEPTH},
            "ast_eval": {"log_mel_fused": 1, "rel_attention_fwd": AST_DEPTH}}[kind]


def tp_runs(wav, tmp: str, dev, card) -> dict:
    """Phases 34-36: tensor parallelism, gloo ranks sharing the card. The
    parent first makes the f32 gates' one-process references and their
    yardsticks (one process on the same rows in another order); then one
    spawn of TP ranks (the gates at tp 2, SS-MAST pretrain.tp and AST-base
    downstream.tp through their entry points, their step times) and one of
    TP_DP x TP ranks (the gates at dp 2 x tp 2). Checks every gate and
    fault, the launches a rank, the shards a rank held, the resume and the
    export served at tp 1."""
    from audiossl_tpu_torch.serve import export as serve

    mast_batch = int(ssmast_config()["run"]["batch_size"])
    mast_csv = ssmast_wavs(tmp, wav, (TP_SSMAST_STEPS + 1) * mast_batch)
    files, labels = ast_wavs(tmp, wav)
    ast_train, ast_test = write_labelled(tmp, "ast_tp", files, labels, TP_AST_STEPS * AST_BATCH, AST_BATCH)
    gates = tp_gate_inputs()
    perm = np.random.default_rng(147).permutation(TP_GATE_BATCH)
    one = {kind: tp_gate_step(kind, gates[kind], dev) for kind in ("ssmast", "ast")}
    spread = {kind: tp_gate_distance(tp_gate_step(kind, gates[kind], dev, perm=perm), one[kind]) for kind in one}
    bound = {kind: {k: DDP_SPREAD * v + DDP_FLOOR[k] for k, v in e.items()} for kind, e in spread.items()}
    for kind in one:
        print(f"[{card}] f32 {kind} gate, one process on the same rows in another order against one process: "
              f"loss rel {spread[kind]['loss']:.2e}, gradient rel norm {spread[kind]['grad']:.3e}; the gate "
              f"{bound[kind]}")
    ranks = {}
    for world in (1, TP, TP_DP * TP):  # world 1: one process's SS-MAST peak, beside a rank's
        sub = os.path.join(tmp, f"tp_world{world}")
        os.makedirs(sub)
        torch.save({"gates": gates, "tmp": tmp, "mast_csv": mast_csv, "ast_train": ast_train, "ast_test": ast_test,
                    "device": str(dev), "card": card}, os.path.join(sub, "in.pt"))
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(tp_rank, args=(world, free_port(), os.path.join(sub, "in.pt"), sub), nprocs=world,
                                    join=True)
        print(f"tensor parallelism: {world} gloo ranks on this card, spawn and every phase {time.perf_counter() - t0:.1f} s")
        ranks[world] = [torch.load(os.path.join(sub, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    one_peak = ranks.pop(1)[0]["ssmast_peak_bytes"]

    report, failures = {"gate_spread": spread, "gate_bound": bound}, []
    for world, rs in ranks.items():
        grid = [r["grid"] for r in rs]
        if grid != [(r // TP, r % TP) for r in range(world)]:
            failures.append(f"world {world}: the grid is {grid}")
        for r, res in enumerate(rs):
            for name, step in res["gates"].items():
                kind, _, fault = name.partition(" ")
                err = tp_gate_distance(step, one[kind])
                caught = [k for k in err if err[k] > bound[kind][k]]
                print(f"[{card}] f32 {kind} gate at dp {world // TP} x tp {TP}, rank {r}"
                      + (f", planted fault {fault}" if fault else "") + f": loss rel {err['loss']:.2e}, gradient rel "
                      f"norm {err['grad']:.3e}; " + (f"fails the gate on {caught}" if caught else "passes the gate")
                      + ("" if fault else f"; collectives {step['calls']}"))
                report[f"gate world{world} rank{r} {name}"] = err
                if fault and not caught:
                    failures.append(f"the {kind} gate does not catch {fault} at world {world}, rank {r}: {err}")
                if not fault and caught:
                    failures.append(f"rank {r}'s {kind} tp step at world {world} strays from one process: {err}")
    if failures:
        raise RuntimeError("; ".join(failures))

    rs = ranks[TP]
    steps = TP_SSMAST_STEPS
    for r, res in enumerate(rs):
        st = res["ssmast"]
        expect_counts(f"SS-MAST pretrain.tp {TP}, rank {r}, {steps} steps", st["counts"],
                      {k: steps * n for k, n in tp_expected("ssmast").items()})
        expect_counts(f"SS-MAST pretrain.tp {TP} resumed, rank {r}, 1 step", st["resume_counts"], tp_expected("ssmast"))
        sh = st["shapes"]
        want = {"qkv": (3 * 384 // TP, 192), "attn.proj": (384, 384 // TP), "mlp.fc1": (4 * 384 // TP, 384),
                "mlp.fc2": (384, 4 * 384 // TP), "key qkv": (3 * 384 // TP, 192), "qkv exp_avg": (3 * 384 // TP, 192),
                "fc2 exp_avg_sq": (384, 4 * 384 // TP)}
        if sh != want or st["step"] != steps or st["resume_step"] != steps + 1:
            raise RuntimeError(f"rank {r} of SS-MAST pretrain.tp held {sh} (expected {want}), steps {st['step']}, "
                               f"{st['resume_step']}")
        print(f"SS-MAST pretrain.tp {TP} through train_upstream (configs/ssmast.yaml, MViTv2-B, B={mast_batch}, bf16), "
              f"rank {r}: {steps} steps in {st['seconds']:.1f} s, launches {st['counts']}; block 5 held {sh}; "
              f"{st['encoder_params_held'] / 1e6:.2f} M of the query tower's parameters on this rank; resumed to step "
              f"{st['resume_step']} ({st['resume_counts']})")
        print(f"[{card}] SS-MAST pretrain.tp {TP}, rank {r}: peak memory {st['peak_bytes'] / 2**30:.3f} GiB above what "
              f"the rank held before; one process at pretrain.tp 1, in a fresh process, {one_peak / 2**30:.3f} GiB: "
              f"{st['peak_bytes'] / one_peak:.3f} of it")
    saved = torch.load(os.path.join(rs[0]["ssmast"]["ckpt_dir"], "state", f"{steps + 1}.pt"), map_location="cpu",
                       weights_only=True)
    dense = saved["objective"]["encoder.mast.blocks.5.attn.qkv.weight"].shape
    if tuple(dense) != (3 * 384, 192):
        raise RuntimeError(f"the tp checkpoint is not dense: {tuple(dense)}")
    # the export at tp 1 behind the fbank: the serving CLI writes the artifact,
    # ServingEncoder answers 65 clips in 2 batches of 64, counts from 0
    art = os.path.join(tmp, "tp_export.pt")
    serve.main(["--checkpoint", rs[0]["ssmast"]["ckpt_dir"], "--out", art, "--clip_samples", str(SLICE9_CLIP),
                "--device", str(dev)])
    pool = slice9_requests(tmp, wav, 65)
    enc = fixed_batch_encoder(art, dev)
    reset_launches()
    z = enc(pool)
    torch.cuda.synchronize()
    served = read_launches()
    if z.shape != (65, 768) or not np.isfinite(z).all():
        raise RuntimeError(f"the tp checkpoint's export served {z.shape} or non-finite embeddings")
    expect_counts("the tp checkpoint's export served at tp 1", served, {"fused_rows_kaldi": 2, "rel_attention_fwd": 48})
    print(f"the tp {TP} checkpoint (dense: block 5's qkv {tuple(dense)}) exported and served at tp 1: 65 clips -> "
          f"{z.shape}, finite; launches {served}")

    for r, res in enumerate(rs):
        for mode, per_step in (("finetune", tp_expected("ast_step")), ("freeze", tp_expected("ast_freeze_step"))):
            a = res[f"ast_{mode}"]
            if len(a["losses"]) != TP_AST_STEPS or not all(math.isfinite(v) for v in a["losses"] + a["history"]):
                raise RuntimeError(f"AST downstream.tp {mode}, rank {r}: losses {a['losses']}, accuracy {a['history']}")
            probe_counts_check(f"AST-base downstream.tp {TP} {mode}, rank {r}", a["counts"], per_step,
                               tp_expected("ast_eval"), TP_AST_STEPS, 1)
            if a["qkv"] != (3 * 768 // TP, 768) or a["fc1"] != (4 * 768 // TP, 768):
                raise RuntimeError(f"AST downstream.tp rank {r} held qkv {a['qkv']}, fc1 {a['fc1']}")
            print(f"AST-base downstream.tp {TP} through train_downstream ({mode}, B={AST_BATCH}, 1214 tokens, 6 of the 12 "
                  f"heads a rank), rank {r}: {TP_AST_STEPS} steps + 1 eval batch in {a['seconds']:.1f} s; losses "
                  f"{a['losses']}; accuracy {a['history']}; launches {a['counts']}; block 0 held qkv {a['qkv']}, fc1 "
                  f"{a['fc1']}; peak memory {a['peak_bytes'] / 2**30:.2f} GiB")
    report.update({
        "ssmast_launches_per_rank": rs[0]["ssmast"]["counts"], "ssmast_peak_gib_per_rank": [
            res["ssmast"]["peak_bytes"] / 2**30 for res in rs],
        "ssmast_one_process_peak_gib": one_peak / 2**30,
        "ssmast_times": [res["ssmast"]["times"] for res in rs], "ast_times": [res["ast_finetune"]["times"] for res in rs],
        "ast_launches_per_rank": rs[0]["ast_finetune"]["counts"], "ast_freeze_launches_per_rank": rs[0]["ast_freeze"]["counts"],
        "ast_peak_gib_per_rank": [res["ast_finetune"]["peak_bytes"] / 2**30 for res in rs],
        "served_launches": served})
    return report


def tp_attention_checks(dev) -> dict[str, float]:
    """Phase 33: the attention kernels at each rank's shape under
    downstream.tp 2, AST-base at B=32 with 6 of its 12 heads: [192, 1214,
    64], no bias (the streamed designs), f32 and bf16, against their plain
    versions, equal bits twice."""
    errs = dict.fromkeys(ATTN_KERNELS, 0.0)
    bh, l, d = AST_TP_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        check_attention(f"AST-base per rank at tp {TP} [{bh}, {l}, {l}] D={d}", bh, l, None, l, d, dtype, dev, 161, errs,
                        twice=True)
    return errs


# ---------------------------------------------------------------- sharded training state (slice 15)

SHARD_WORLD = 2  # gloo ranks sharing the one card (NCCL refuses two ranks on one GPU)
SHARD_FSDP_STEPS = 3  # SS-MAST under run.fsdp, then a resume to SHARD_FSDP_STEPS + 1
SHARD_ZERO_STEPS = 2  # SS-MAST under run.zero_optimizer
SHARD_FT_STEPS = 3  # the fine-tune with --fsdp, then an eval
SHARD_GATE_BATCH = 4
SHARD_GATE_CLIP = 1e-2  # the fine-tune gate's clip_grad_norm: below the gradient's norm, so the clip scales
# the f32 gates hold a world-2 step to one process on the same rows with
# the tp gates' yardstick: DDP_SPREAD times one process's distance from itself on
# the rows in another order, plus f32 round-off (DDP_FLOOR; the clip's norm
# takes the loss's floor). Each kind's planted fault (the package is not
# changed: the script swaps one function for the run) must fail its gate
SHARD_KINDS = ("ssmast_fsdp", "ssmast_zero", "finetune_fsdp")
SHARD_FAULTS = {"ssmast_fsdp": "sum_reduce_scatter", "ssmast_zero": "zero_row_offset",
                "finetune_fsdp": "replicated_n_times"}


@contextlib.contextmanager
def planted_shard_fault(fault: str | None):
    """``fault`` planted in the package for the block: the fsdp gradients'
    reduce-scatter as a sum over the data axis (not its mean), the clip's
    global norm with the whole leaves summed over the axis as the pieces
    are (each counted n times), or each rank's ZeRO slice taken from the
    next row while its gradient is its own row's."""
    from audiossl_tpu_torch.parallel import dist, fsdp
    from audiossl_tpu_torch.train import zero

    def sum_reduce_scatter(flat, kind="reduce_scatter"):
        out = torch.empty(flat.numel() // dist.dp_world(), dtype=flat.dtype, device=flat.device)
        torch.distributed.reduce_scatter_tensor(out, flat.contiguous())
        return out

    def replicated_n_times(sharded, whole):
        sq = torch.cat([t.float().flatten() for t in list(sharded) + list(whole)]).square().sum()
        return dist.all_reduce_sum(sq, "fsdp_norm")

    saved = dist.reduce_scatter_mean, fsdp.global_sq_norm, zero.local_slice
    if fault == "sum_reduce_scatter":
        dist.reduce_scatter_mean = sum_reduce_scatter
    elif fault == "replicated_n_times":
        fsdp.global_sq_norm = replicated_n_times
    elif fault == "zero_row_offset":
        zero.local_slice = lambda a, n, rank: zero.shard_rows(a, n)[(rank + 1) % n]
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        dist.reduce_scatter_mean, fsdp.global_sq_norm, zero.local_slice = saved


def shard_gate_config() -> dict:
    """The tp gates' SS-MAST (MAST tiny, f32, 64 x 96) with a [256, 256]
    queue: JAX's rule splits it on K, as it splits MViTv2-B's."""
    cfg = tp_ssmast_gate_config()
    cfg["pretrain"]["num_negatives"] = 256
    return cfg


def shard_gate_step(kind: str, inputs: dict, dev, perm: np.ndarray | None = None, fault: str | None = None) -> dict:
    """One f32 step of ``kind`` on this rank's share of the inputs (one
    process: the whole batch, the state whole and the plain optimizer),
    seeded weights alike on every rank, ``fault`` planted, ``perm``
    reordering the rows first: "ssmast_fsdp" (TrainStep's loss and backward
    under fsdp), "ssmast_zero" (one AdamW step through ZeRO), "finetune_fsdp"
    (MAST tiny's classifier, the augmentations off, layer-decay AdamW with
    the clip engaged). Returns the loss (the axis's mean), the whole
    gradients (ZeRO: the whole update instead), the fine-tune's clip norm."""
    from audiossl_tpu_torch import no_tf32
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.parallel import dist, fsdp
    from audiossl_tpu_torch.train import finetune_mast as ft
    from audiossl_tpu_torch.train.layer_decay import adamw_layer_decay
    from audiossl_tpu_torch.train.loop import shard_objective_
    from audiossl_tpu_torch.train.step import TrainStep
    from audiossl_tpu_torch.train.zero import ZeroOptimizer

    rows = (lambda x: x) if perm is None else (lambda x: x[perm])
    share = lambda x: dist.share(torch.from_numpy(np.ascontiguousarray(rows(x)))).to(dev)  # noqa: E731
    sharded = dist.data_active()
    adamw = lambda ps: torch.optim.AdamW(ps, lr=3e-4, eps=1e-4, weight_decay=0.0)  # noqa: E731 (the CPU tests' eps)
    dist.calls.clear()
    reset_launches()
    out = {}
    with planted_shard_fault(fault):
        if kind == "finetune_fsdp":
            ft_cfg = finetune_tiny_config(augment=False)
            with torch.random.fork_rng(devices=[]):
                model = ft.init_classifier(ft_cfg, 8, 0, "cpu")
            model = model.to(dev).train()
            shards = fsdp.shard_(model, ft.FSDP_UNITS) if sharded else None
            opt = adamw_layer_decay(model.named_parameters(), 5e-4, depth=10, layer_decay=0.75,
                                    clip_grad_norm=SHARD_GATE_CLIP, shards=shards)
            step = ft.FinetuneStep(model, opt, ft_cfg, torch.Generator(dev).manual_seed(0), layout=shards)
            loss = step.loss_and_grads(share(inputs["waves"]), share(inputs["targets"]))
            with torch.no_grad():
                out["norm"] = float(shards.grad_norm(step.params) if shards is not None else
                                    torch.cat([p.grad.flatten() for p in step.params]).square().sum().sqrt())
            grads = {n: p.grad for n, p in model.named_parameters()}
        else:
            obj = init_objective("ssmast", shard_gate_config(), seed=0).to(dev).train()
            shards = shard_objective_(obj) if kind == "ssmast_fsdp" and sharded else None
            params = [p for p in obj.parameters() if p.requires_grad]
            opt = ZeroOptimizer(params, adamw) if kind == "ssmast_zero" and sharded else adamw(params)
            step = TrainStep(obj, None, None, opt, torch.Generator(dev).manual_seed(0),
                             layout=shards or (opt if kind == "ssmast_zero" and sharded else None))
            before = {n: p.detach().clone() for n, p in obj.named_parameters() if p.requires_grad}
            with no_tf32():
                loss = step.loss_and_grads(share(inputs["v1"]), share(inputs["v2"]))
            if kind == "ssmast_zero":
                step.update()
                grads = {n: p.detach() - before[n] for n, p in obj.named_parameters() if p.requires_grad}
            else:
                grads = {n: p.grad for n, p in obj.named_parameters() if p.requires_grad}
        if shards is not None:
            grads = shards.dense_state_dict(grads)
    torch.cuda.synchronize()
    return {**out, "loss": float(loss), "grads": {n: g.float().cpu() for n, g in grads.items()},
            "calls": dict(dist.calls), "counts": read_launches()}


def shard_gate_inputs() -> dict:
    """The gates' inputs from a generator of their own."""
    rng = np.random.default_rng(151)
    b = SHARD_GATE_BATCH
    ssmast = {"v1": rng.standard_normal((b, 1, 64, 96)).astype(np.float32),
              "v2": rng.standard_normal((b, 1, 64, 96)).astype(np.float32)}
    return {"ssmast_fsdp": ssmast, "ssmast_zero": ssmast,
            "finetune_fsdp": {"waves": (0.3 * rng.standard_normal((b, 16000))).astype(np.float32),
                              "targets": (rng.random((b, 8)) < 0.4).astype(np.float32)}}


def shard_gate_distance(a: dict, b: dict) -> dict[str, float]:
    """tp_gate_distance, and the clip's norm (relative) where there is one."""
    out = tp_gate_distance(a, b)
    if "norm" in b:
        out["norm"] = abs(a["norm"] - b["norm"]) / b["norm"]
    return out


def shard_moment_shapes(opt, names: dict, keys: tuple[str, ...]) -> dict[str, tuple]:
    """The AdamW moments' shapes this rank held for the parameters ``keys``
    (``names``: parameter -> name); ZeRO's slices are the inner optimizer's."""
    inner = getattr(opt, "inner", opt)
    params = getattr(opt, "slices", None)
    out = {}
    for i, p in enumerate(opt.params if params is not None else
                          [q for g in opt.param_groups for q in g["params"]]):
        if names.get(id(p)) in keys:
            held = params[i] if params is not None else p
            out[names[id(p)]] = tuple(inner.state[held]["exp_avg"].shape)
    return out


def shard_ssmast_run(d: dict, knob: str, steps: int, dev, resume: bool = False) -> dict:
    """SS-MAST through train_upstream on a copy of configs/ssmast.yaml with
    ``run.<knob>: true`` (B=64 as 32 a rank, bf16, MViTv2-B), ``steps``
    steps, counts and collectives from 0, peak memory above what the rank
    held before; the pieces and moments this rank held; with ``resume``
    then one step more from the run's dense checkpoint."""
    from audiossl_tpu_torch.parallel import dist
    from audiossl_tpu_torch.train.loop import train_upstream

    config = ssmast_config()
    config["run"].update(save_path=os.path.join(d["tmp"], f"shard_{knob}"), epochs=1, **{knob: True})
    from audiossl_tpu_torch.train import loop

    built, original = [], loop.build_zero_optimizer
    loop.build_zero_optimizer = lambda *a, **kw: built.append(original(*a, **kw)) or built[-1]
    built_plain, restore_plain = tp_capture_optimizer()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    dist.calls.clear()
    t0 = time.perf_counter()
    try:
        obj, step, ckpt_dir = train_upstream(config, d["mast_csv"], "ssmast", max_steps=steps, device=dev)
        built += built_plain
        torch.cuda.synchronize()
        out = {"step": step, "seconds": time.perf_counter() - t0, "counts": read_launches(),
               "calls": dict(dist.calls), "peak_bytes": torch.cuda.max_memory_allocated() - base, "ckpt_dir": ckpt_dir}
        keys = ("encoder.mast.blocks.5.attn.qkv.weight", "encoder.mast.blocks.5.mlp.fc2.weight",
                "encoder.mast.patch_embed.proj.weight", "encoder.mast.blocks.5.norm1.weight")
        sd = obj.state_dict()
        out["held"] = {k: tuple(sd[k].shape) for k in keys + ("encoder_k.mast.blocks.5.attn.qkv.weight", "queue")}
        names = {id(p): n for n, p in obj.named_parameters()}
        out["moments"] = shard_moment_shapes(built[0][0], names, keys)
        out["state_bytes"] = sum(v.numel() * v.element_size() for v in sd.values())
        del obj
        if resume:
            reset_launches()
            _, step2, _ = train_upstream(config, d["mast_csv"], "ssmast", load_checkpoint=ckpt_dir, max_steps=steps + 1,
                                         device=dev)
            torch.cuda.synchronize()
            out.update(resume_step=step2, resume_counts=read_launches())
    finally:
        restore_plain()
        loop.build_zero_optimizer = original
    return out


def shard_finetune_run(d: dict, dev) -> dict:
    """The fine-tune through its CLI entry (``finetune_mast.main``) on
    configs/mast_ft.yaml with --fsdp at world 2 (B=64 as 32 a rank, bf16,
    MAST-B; mixup, SpecMask, norm and noise on), SHARD_FT_STEPS steps and the
    eval, counts from 0, peak memory above what the rank held before."""
    from audiossl_tpu_torch.parallel import dist
    from audiossl_tpu_torch.train.finetune_mast import main as finetune_main

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    dist.calls.clear()
    t0 = time.perf_counter()
    stats, ckpt_dir = finetune_main(["-c", FT_CONFIG, "--train_json", d["ft_train"], "--label_csv", d["ft_labels"],
                                     "--eval_json", d["ft_eval"], "--max_steps", str(SHARD_FT_STEPS), "--fsdp",
                                     "--save_path", os.path.join(d["tmp"], "shard_ft"), "--device", str(dev)])
    torch.cuda.synchronize()
    return {"stats": stats, "ckpt_dir": ckpt_dir, "seconds": time.perf_counter() - t0, "counts": read_launches(),
            "calls": dict(dist.calls), "peak_bytes": torch.cuda.max_memory_allocated() - base}


def one_process_peaks(d: dict, dev) -> dict[str, int]:
    """One process at a rank's batch (B=32), fresh: SS-MAST through
    train_upstream (SHARD_ZERO_STEPS steps) and the fine-tune through its
    CLI (SHARD_FT_STEPS steps, no eval), each's peak device bytes above what
    the process held before it."""
    from audiossl_tpu_torch.train.finetune_mast import main as finetune_main
    from audiossl_tpu_torch.train.loop import train_upstream

    out = {}
    config = ssmast_config()
    config["run"].update(save_path=os.path.join(d["tmp"], "one_ssmast_b32"), epochs=1,
                         batch_size=MAST_BATCH // SHARD_WORLD)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_upstream(config, d["mast_csv"], "ssmast", max_steps=SHARD_ZERO_STEPS, device=dev)
    torch.cuda.synchronize()
    out["ssmast"] = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    finetune_main(["-c", FT_CONFIG, "--train_json", d["ft_train"], "--label_csv", d["ft_labels"], "--max_steps",
                   str(SHARD_FT_STEPS), "--batch_size", str(MAST_BATCH // SHARD_WORLD), "--save_path",
                   os.path.join(d["tmp"], "one_ft_b32"), "--device", str(dev)])
    torch.cuda.synchronize()
    out["finetune"] = torch.cuda.max_memory_allocated() - base
    return out


def shard_rank(rank: int, world: int, port: int, in_path: str, out_dir: str) -> None:
    """One gloo rank on the one card: at world SHARD_WORLD the f32 gates (each
    kind correct and with its fault), SS-MAST under run.fsdp (then a resume)
    and under run.zero_optimizer through train_upstream, the fine-tune with
    --fsdp through its CLI; at world 1 the one-process peaks at a rank's
    batch. Results to ``out_dir/rank<r>.pt``. Gloo is the script's choice
    (NCCL refuses two ranks on one GPU; the package takes NCCL for CUDA)."""
    sys.path.insert(0, ROOT)
    logging.basicConfig(level=logging.WARNING)
    d = torch.load(in_path, weights_only=False)
    dev = torch.device(d["device"])
    torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:  # the kernels load from the parent's build at first launch
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        if world == 1:
            out = {"peaks": one_process_peaks(d, dev)}
        else:
            out = {"gates": {}}
            for kind in SHARD_KINDS:
                out["gates"][kind] = shard_gate_step(kind, d["gates"][kind], dev)
                out["gates"][f"{kind} {SHARD_FAULTS[kind]}"] = shard_gate_step(kind, d["gates"][kind], dev,
                                                                               fault=SHARD_FAULTS[kind])
            out["fsdp"] = shard_ssmast_run(d, "fsdp", SHARD_FSDP_STEPS, dev, resume=True)
            out["zero"] = shard_ssmast_run(d, "zero_optimizer", SHARD_ZERO_STEPS, dev)
            out["finetune"] = shard_finetune_run(d, dev)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def shard_expected(kind: str, steps: int) -> dict[str, int]:
    """Launches a rank over ``steps`` steps of SS-MAST or the fine-tune (24 blocks)."""
    depth = 24
    fwd = 2 * depth if kind == "ssmast" else depth
    return {"fused_rows_kaldi": steps, "rel_attention_fwd": steps * fwd, "rel_attention_bwd_dq": steps * depth,
            "rel_attention_bwd_dkv": steps * depth}


def shard_runs(wav, tmp: str, dev, card) -> dict:
    """Phases 38-41: sharded training state over the data axis, gloo ranks
    sharing the card. The parent makes the f32 gates' one-process references
    and yardsticks; then one spawn of SHARD_WORLD ranks (the gates with their
    faults, SS-MAST under run.fsdp with a resume and under
    run.zero_optimizer, the fine-tune with --fsdp) and one of a single fresh
    process (the one-process peaks at a rank's batch). Checks every gate and
    fault, the launches and pieces a rank, the moments a rank, the dense
    checkpoint, its resume and its export served at world 1."""
    from audiossl_tpu_torch.parallel.fsdp import fsdp_spec
    from audiossl_tpu_torch.serve import export as serve

    mast_csv = ssmast_wavs(tmp, wav, (SHARD_FSDP_STEPS + 1) * MAST_BATCH)
    ft_data = audioset_style_data(tmp, wav, MAST_BATCH)
    gates = shard_gate_inputs()
    perm = np.random.default_rng(153).permutation(SHARD_GATE_BATCH)
    one = {kind: shard_gate_step(kind, gates[kind], dev) for kind in SHARD_KINDS}
    spread = {kind: shard_gate_distance(shard_gate_step(kind, gates[kind], dev, perm=perm), one[kind])
              for kind in SHARD_KINDS}
    floor = {**DDP_FLOOR, "norm": DDP_FLOOR["loss"]}
    bound = {kind: {k: DDP_SPREAD * v + floor[k] for k, v in e.items()} for kind, e in spread.items()}
    for kind in SHARD_KINDS:
        print(f"[{card}] f32 {kind} gate, one process on the same rows in another order against one process: "
              f"{spread[kind]}; the gate {bound[kind]}")
    ranks = {}
    for world in (1, SHARD_WORLD):
        sub = os.path.join(tmp, f"shard_world{world}")
        os.makedirs(sub)
        torch.save({"gates": gates, "tmp": tmp, "mast_csv": mast_csv, "ft_train": ft_data["train"],
                    "ft_eval": ft_data["eval"], "ft_labels": ft_data["label_csv"], "device": str(dev)},
                   os.path.join(sub, "in.pt"))
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(shard_rank, args=(world, free_port(), os.path.join(sub, "in.pt"), sub),
                                    nprocs=world, join=True)
        print(f"sharded state: {world} gloo rank(s) on this card, spawn and every phase {time.perf_counter() - t0:.1f} s")
        ranks[world] = [torch.load(os.path.join(sub, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    peaks = ranks.pop(1)[0]["peaks"]
    rs = ranks[SHARD_WORLD]

    report, failures = {"gate_spread": spread, "gate_bound": bound, "one_process_peak_bytes_b32": peaks}, []
    for r, res in enumerate(rs):
        for name, step in res["gates"].items():
            kind, _, fault = name.partition(" ")
            err = shard_gate_distance(step, one[kind])
            caught = [k for k in err if err[k] > bound[kind][k]]
            print(f"[{card}] f32 {kind} gate at world {SHARD_WORLD}, rank {r}"
                  + (f", planted fault {fault}" if fault else "") + f": {err}; "
                  + (f"fails the gate on {caught}" if caught else "passes the gate")
                  + ("" if fault else f"; collectives {step['calls']}"))
            report[f"gate rank{r} {name}"] = err
            if fault and not caught:
                failures.append(f"the {kind} gate does not catch {fault} on rank {r}: {err}")
            if not fault and caught:
                failures.append(f"rank {r}'s {kind} step strays from one process: {err}")
    if failures:
        raise RuntimeError("; ".join(failures))

    batch = MAST_BATCH // SHARD_WORLD
    for r, res in enumerate(rs):
        for knob, steps in (("fsdp", SHARD_FSDP_STEPS), ("zero", SHARD_ZERO_STEPS)):
            st = res[knob]
            expect_counts(f"SS-MAST run.{knob}, rank {r}, {steps} steps", st["counts"], shard_expected("ssmast", steps))
            if st["step"] != steps:
                raise RuntimeError(f"SS-MAST run.{knob}, rank {r}: {st['step']} steps")
            held, moments = st["held"], st["moments"]
            if knob == "fsdp":  # every piece and moment as fsdp_spec cuts the whole (MViTv2-B's) leaf
                whole = {"encoder.mast.blocks.5.attn.qkv.weight": (3 * 384, 192),
                         "encoder.mast.blocks.5.mlp.fc2.weight": (384, 4 * 384),
                         "encoder.mast.patch_embed.proj.weight": (96, 1, 16, 16),
                         "encoder.mast.blocks.5.norm1.weight": (192,),
                         "encoder_k.mast.blocks.5.attn.qkv.weight": (3 * 384, 192), "queue": (256, 65536)}
                jax_order = {4: (2, 3, 1, 0), 2: (1, 0), 1: (0,)}
                for k, shape in whole.items():
                    axes = (0, 1) if k == "queue" else jax_order[len(shape)]
                    dim = fsdp_spec([shape[a] for a in axes], SHARD_WORLD)
                    want = shape if dim is None else tuple(
                        s // SHARD_WORLD if i == axes[dim] else s for i, s in enumerate(shape))
                    if held[k] != want or (k in moments and moments[k] != want):
                        raise RuntimeError(f"rank {r} under run.fsdp held {k} {held[k]} (moments {moments.get(k)}), "
                                           f"expected {want}")
                expect_counts(f"SS-MAST run.fsdp resumed, rank {r}, 1 step", st["resume_counts"],
                              shard_expected("ssmast", 1))
                if st["resume_step"] != steps + 1:
                    raise RuntimeError(f"the fsdp resume on rank {r} ended at step {st['resume_step']}")
            else:  # ZeRO: the parameters whole, each moment this rank's flat slice
                for k, m in moments.items():
                    n = int(np.prod(held[k]))
                    if m != (-(-n // SHARD_WORLD),):
                        raise RuntimeError(f"rank {r} under run.zero_optimizer held {k}'s moments as {m} for {n} "
                                           "elements")
            print(f"SS-MAST run.{knob} through train_upstream (configs/ssmast.yaml, MViTv2-B, B={MAST_BATCH} as "
                  f"{batch} a rank, bf16), rank {r}: {steps} steps in {st['seconds']:.1f} s; launches {st['counts']}; "
                  f"collectives a step {({k: v / steps for k, v in st['calls'].items()})} (the checkpoint's "
                  f"included); held {held}; moments {moments}; state {st['state_bytes'] / 2**30:.3f} GiB")
            print(f"[{card}] SS-MAST run.{knob}, rank {r}: peak memory {st['peak_bytes'] / 2**30:.3f} GiB above what "
                  f"the rank held before; one fresh process at B={batch}: {peaks['ssmast'] / 2**30:.3f} GiB "
                  f"({st['peak_bytes'] / peaks['ssmast']:.3f} of it, {(peaks['ssmast'] - st['peak_bytes']) / 2**30:+.3f} "
                  "GiB less)")
        ftr = res["finetune"]
        eval_batches = -(-(-(-FT_EVAL // SHARD_WORLD)) // batch)
        expect_counts(f"fine-tune --fsdp, rank {r}", ftr["counts"],
                      {k: v + (eval_batches if k == "fused_rows_kaldi" else eval_batches * 24 if k == "rel_attention_fwd"
                               else 0) for k, v in shard_expected("finetune", SHARD_FT_STEPS).items()})
        for key in ("mAP", "AUC"):
            if not (math.isfinite(ftr["stats"][key]) and 0.0 <= ftr["stats"][key] <= 1.0):
                raise RuntimeError(f"the fsdp fine-tune's eval {key} = {ftr['stats'][key]}")
        print(f"fine-tune --fsdp through finetune_mast.main (configs/mast_ft.yaml, MAST-B, B={MAST_BATCH} as {batch} a "
              f"rank, bf16, every augmentation on), rank {r}: {SHARD_FT_STEPS} steps and an eval of {FT_EVAL} clips "
              f"({eval_batches} batches a rank) in {ftr['seconds']:.1f} s; stats {ftr['stats']}; launches "
              f"{ftr['counts']}; collectives {ftr['calls']}")
        print(f"[{card}] fine-tune --fsdp, rank {r}: peak memory {ftr['peak_bytes'] / 2**30:.3f} GiB; one fresh "
              f"process at B={batch}: {peaks['finetune'] / 2**30:.3f} GiB ({ftr['peak_bytes'] / peaks['finetune']:.3f} "
              f"of it, {(peaks['finetune'] - ftr['peak_bytes']) / 2**30:+.3f} GiB less)")
    ckpt = rs[0]["fsdp"]["ckpt_dir"]
    saved = torch.load(os.path.join(ckpt, "state", f"{SHARD_FSDP_STEPS + 1}.pt"), map_location="cpu",
                       weights_only=True)
    dense = (tuple(saved["objective"]["encoder.mast.blocks.5.attn.qkv.weight"].shape),
             tuple(saved["objective"]["queue"].shape))
    if dense != ((3 * 384, 192), (256, 65536)):
        raise RuntimeError(f"the fsdp checkpoint is not dense: {dense}")
    zsaved = torch.load(os.path.join(rs[0]["zero"]["ckpt_dir"], "state", f"{SHARD_ZERO_STEPS}.pt"), map_location="cpu",
                        weights_only=True)
    if zsaved["optimizer"]["zero_world"] != SHARD_WORLD or zsaved["optimizer"]["state"][0]["exp_avg"].shape[0] != 2:
        raise RuntimeError("the ZeRO checkpoint does not hold the moments as world-sized rows")
    art = os.path.join(tmp, "fsdp_export.pt")
    serve.main(["--checkpoint", ckpt, "--out", art, "--clip_samples", str(SLICE9_CLIP), "--device", str(dev)])
    enc = fixed_batch_encoder(art, dev)
    reset_launches()
    z = enc(slice9_requests(tmp, wav, 65))
    torch.cuda.synchronize()
    served = read_launches()
    if z.shape != (65, 768) or not np.isfinite(z).all():
        raise RuntimeError(f"the fsdp checkpoint's export served {z.shape} or non-finite embeddings")
    expect_counts("the fsdp checkpoint's export served at world 1", served,
                  {"fused_rows_kaldi": 2, "rel_attention_fwd": 48})
    print(f"the fsdp checkpoint (dense: block 5's qkv and the queue {dense}) exported and served at world 1: 65 clips "
          f"-> {z.shape}, finite; launches {served}")
    report.update({
        "fsdp_ssmast_launches_per_rank": rs[0]["fsdp"]["counts"], "zero_ssmast_launches_per_rank": rs[0]["zero"]["counts"],
        "fsdp_finetune_launches_per_rank": rs[0]["finetune"]["counts"],
        "collectives_a_step_per_rank": {knob: {k: v / steps for k, v in rs[0][knob]["calls"].items()}
                                        for knob, steps in (("fsdp", SHARD_FSDP_STEPS), ("zero", SHARD_ZERO_STEPS))},
        "finetune_collectives_per_rank": rs[0]["finetune"]["calls"],
        "peak_gib_per_rank": {knob: [res[knob]["peak_bytes"] / 2**30 for res in rs] for knob in ("fsdp", "zero",
                                                                                                "finetune")},
        "one_process_peak_gib_b32": {k: v / 2**30 for k, v in peaks.items()},
        "finetune_eval": {k: rs[0]["finetune"]["stats"][k] for k in ("mAP", "AUC", "d_prime")},
        "served_launches": served})
    return report



# ---------------------------------------------------------------- the parallelism library: pipeline, expert, sequence

PAR_WORLD = 2  # gloo ranks sharing the one card (NCCL refuses two ranks on one GPU)
PP_MICRO, PP_MB = 4, 2  # pp-serve and pp-train: B = 8 as M = 4 microbatches of 2 over PAR_WORLD stages
PP_DEPTH, PP_WIDTH, PP_HEADS, PP_TOKENS = 12, 768, 12, 1214  # AST-base: MLP 4 x 768, 1214 tokens at 128 x 1024
PP_SERVE_INPUT = (128, 1024)  # AST-base's published input: mels x frames
PP_SEED = 1601
# pp-serve keeps AST's bf16 attention operands: the pipelined forward and one
# process run the same kernels on the same rows, but the f32 GEMMs see
# batches of 2 against 8 and may sum in another order, which can move a bf16
# rounding of an attention operand; so a bound well above f32 round-off
TOL_PP_BF16 = 5e-3  # relative to max(1, max|ref|)
TOL_PAR = 1e-5  # f32 outputs, losses, aux losses and embeddings against one process on the card, relative
TOL_PAR_GRAD = (1e-3, 1e-5)  # each f32 gradient within 1e-3 of its own max|ref| + 1e-5 of the largest (the tp gates')
EP_EXPERTS, EP_WIDTH, EP_HIDDEN, EP_TOKENS = 8, 768, 3072, 2 * 1214  # AST-base's FFN; 4 experts, 2 x 1214 tokens a rank
EP_CAPACITY = {"ample": int(1.25 * EP_TOKENS / EP_EXPERTS), "drops": int(1.25 * EP_TOKENS / EP_EXPERTS) // 4}
SP_CLIP = 983040  # 61.44 s at 16 kHz: 6144 frames, 1536 tokens; 3072 frames and 768 tokens a rank
SP_FRAMES_CLIP = 160000  # JAX's test_sp_frontend case: 10 s clips, the default log-mel config
GLOO_PROBE_OPS = ("all_to_all_single", "batch_isend_irecv")


@contextlib.contextmanager
def planted_pp_fault(fault: str | None):
    """The pipeline's output collective with a summed backward for the block
    (the package is not changed): every stage gets PAR_WORLD times its
    gradient."""
    from audiossl_tpu_torch.parallel import dist, pipeline

    saved = pipeline.output_sum
    if fault == "summed_output_backward":
        pipeline.output_sum = lambda buffer, group: dist.all_reduce_sum(buffer, "pp_output", group)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        pipeline.output_sum = saved


def pp_serve_encoder(dev):
    """AST-base at its published 128 x 1024 input (1214 tokens), seeded weights, eval."""
    from audiossl_tpu_torch.models.ast import ASTEncoder

    torch.manual_seed(PP_SEED)
    return ASTEncoder(*PP_SERVE_INPUT, "base").eval().to(dev)


def pp_train_block(i: int, dev):
    """Block i of the vit_block stack at AST-base's widths, seeded, with f32
    attention operands (the f32 gate)."""
    from audiossl_tpu_torch.parallel.pipeline import vit_block

    torch.manual_seed(PP_SEED + 1 + i)
    return vit_block(PP_WIDTH, PP_HEADS, 4.0, attention_dtype=torch.float32).to(dev)


def sp_model(dev):
    """The blockwise AST at LongASTConfig's defaults (64 mels, time patch 4, D
    192, depth 4, 3 heads) over SP_CLIP's 1536 tokens, seeded."""
    from audiossl_tpu_torch.parallel.ring import LongASTConfig, init_long_ast_params

    cfg = LongASTConfig(tokens_global=SP_CLIP // 160 // 4)
    return init_long_ast_params(cfg, torch.Generator().manual_seed(PP_SEED + 40)).to(dev)


def grad_errors(grads: dict, ref: dict, largest: float) -> dict[str, float]:
    """Each gradient's max|d| over its bound (TOL_PAR_GRAD): > 1 fails."""
    rel, floor = TOL_PAR_GRAD
    return {k: float((grads[k] - r).abs().max()) / (rel * float(r.abs().max()) + floor * largest)
            for k, r in ref.items()}


def timed_phase(fn):
    """(fn(), seconds, launches, collectives): counts from 0 around the call,
    the host clock ending in a synchronize."""
    from audiossl_tpu_torch.parallel import dist

    torch.cuda.synchronize()
    dist.calls.clear()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches(), dict(dist.calls)


def pp_serve_rank(d: dict, dev) -> dict:
    """(pp-serve) AST-base pipelined over the two ranks, eval, B = 8 as M = 4."""
    from audiossl_tpu_torch.parallel import dist
    from audiossl_tpu_torch.parallel.pipeline_ast import pipelined_ast_forward

    _, group = dist.inner_grid(PAR_WORLD)
    enc = pp_serve_encoder(dev)
    x = torch.from_numpy(d["pp_serve_x"]).to(dev)
    with torch.no_grad():
        z, secs, counts, calls = timed_phase(lambda: pipelined_ast_forward(enc, x, PP_MICRO, group))
    return {"z": z.cpu(), "seconds": secs, "counts": counts, "calls": calls}


def pp_train_rank(d: dict, rank: int, dev) -> dict:
    """(pp-train) this rank's 6 blocks of the 12, forward and backward
    through the schedule, correct and with the planted fault; each
    gradient's error against the one-process reference of its blocks."""
    from audiossl_tpu_torch.parallel import dist, pipeline

    _, group = dist.inner_grid(PAR_WORLD)
    stage = pipeline.stack_stage_params(lambda i: pp_train_block(i, dev), PP_DEPTH, group)
    x, tgt = (torch.from_numpy(d[k]).to(dev) for k in ("pp_train_x", "pp_train_tgt"))
    ref = torch.load(d["pp_train_ref"][rank], map_location=dev, weights_only=True)
    out = {}
    for fault in (None, "summed_output_backward"):
        stage.zero_grad(set_to_none=True)

        def step():
            y = pipeline.pipeline_forward(stage, list(stage.parameters()), x, group)
            loss = ((y - tgt) ** 2).mean()
            loss.backward()
            return float(loss.detach())

        with planted_pp_fault(fault):
            loss, secs, counts, calls = timed_phase(step)
        grads = {k: p.grad for k, p in stage.named_parameters()}
        out[fault or "correct"] = {"loss": loss, "errors": grad_errors(grads, ref["grads"], d["pp_train_largest"]),
                                   "seconds": secs, "counts": counts, "calls": calls}
    return out


def ep_rank(d: dict, rank: int, dev) -> dict:
    """(ep) the Switch MoE over the two ranks (4 experts each), at each
    capacity: this rank's output, the aux loss, the router's gradient summed
    over the group and this rank's rows of w1's."""
    from audiossl_tpu_torch.parallel import dist, moe

    _, group = dist.inner_grid(PAR_WORLD)
    params = {k: v.detach().to(dev, copy=True).requires_grad_() for k, v in d["ep_params"].items()}
    x = torch.from_numpy(d["ep_x"][rank]).to(dev)
    k = EP_EXPERTS // PAR_WORLD
    out = {}
    for case, cap in EP_CAPACITY.items():
        for p in params.values():
            p.grad = None

        def step():
            y, aux = moe.moe_apply(params, x, cap, group)
            ((y ** 2).sum() / (EP_TOKENS * PAR_WORLD * y.shape[1]) + 0.01 * aux).backward()
            moe.sum_router_grad_(params["router"], group)
            return y.detach(), float(aux.detach())

        (y, aux), secs, counts, calls = timed_phase(step)
        out[case] = {"out": y.cpu(), "aux": aux, "router": params["router"].grad.cpu(),
                     "w1": params["w1"].grad[rank * k:(rank + 1) * k].cpu(), "seconds": secs, "counts": counts,
                     "calls": calls}
    return out


def sp_rank(d: dict, rank: int, dev) -> dict:
    """(sp) the 61.44 s clips through long_audio_forward over the two ranks,
    the ranks' mean gradient of sum(emb^2); then the 10 s clips' sp log-mel
    block of this rank."""
    from audiossl_tpu_torch.frontend import sp
    from audiossl_tpu_torch.frontend.stft import LogMelConfig
    from audiossl_tpu_torch.parallel import dist, ring

    _, group = dist.inner_grid(PAR_WORLD)
    model = sp_model(dev)
    wave = torch.from_numpy(d["sp_wave"]).to(dev).chunk(PAR_WORLD, dim=1)[rank].contiguous()
    emb, secs, counts, calls = timed_phase(lambda: ring.long_audio_forward(model, wave, LogMelConfig(center=False),
                                                                           group))
    (emb * emb).sum().backward()
    grads = {k: (dist.all_reduce_sum(p.grad, "sp_grad_mean", group) / PAR_WORLD).cpu()
             for k, p in model.named_parameters()}
    cfg = LogMelConfig()
    padded = sp.pad_for_sp(torch.from_numpy(d["sp_frames_wave"]).to(dev), cfg, PAR_WORLD)
    local = padded.chunk(PAR_WORLD, dim=1)[rank].contiguous()
    block, fsecs, fcounts, fcalls = timed_phase(lambda: sp.sp_log_mel_local(local, cfg, group))
    return {"emb": emb.detach().cpu(), "grads": grads, "seconds": secs, "counts": counts, "calls": calls,
            "frames": block.cpu(), "frames_seconds": fsecs, "frames_counts": fcounts, "frames_calls": fcalls}


def gloo_probe_ops(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of the gloo probe on the card: each operation the new
    helpers use, on CUDA tensors, its verdict written after each. A refused
    send may end the process (gloo throws on its own thread: SIGABRT), so
    the point-to-point goes last and the op being tried is written first."""
    import torch.distributed as tdist

    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    x = torch.arange(8, dtype=torch.float32, device="cuda") + 100 * rank
    res, peer, path = {}, 1 - rank, os.path.join(out_dir, f"probe{rank}.json")
    for op in GLOO_PROBE_OPS:
        with open(path, "w") as f:
            json.dump({**res, "trying": op}, f)
        out = torch.empty_like(x)
        try:
            if op == "all_to_all_single":
                tdist.all_to_all_single(out, x)
                want = torch.cat([torch.arange(4) + 4 * rank, torch.arange(4) + 4 * rank + 100]).float()
            else:
                for work in tdist.batch_isend_irecv([tdist.P2POp(tdist.isend, x, peer), tdist.P2POp(tdist.irecv, out, peer)]):
                    work.wait()
                want = torch.arange(8).float() + 100 * peer
            torch.cuda.synchronize()
            res[op] = "native" if torch.equal(out.cpu(), want) else "wrong values"
        except RuntimeError as e:  # the probe's question: does gloo take a CUDA tensor here
            res[op] = "refused: " + str(e).strip().splitlines()[0][-200:]
        with open(path, "w") as f:
            json.dump(res, f)
        if res[op] != "native":
            break
    os._exit(0)  # no teardown of a group that a refused send may have broken


def gloo_probe(tmp: str, card) -> dict[str, str]:
    """Phase 42: which operations of the new helpers gloo takes on CUDA
    tensors, two fresh processes on the card (a refused send may end them),
    60 s at most. Raises where gloo refuses an operation that
    parallel/dist.py sends natively."""
    import multiprocessing

    sub = os.path.join(tmp, "gloo_probe")
    os.makedirs(sub)
    ctx, port = multiprocessing.get_context("spawn"), free_port()
    procs = [ctx.Process(target=gloo_probe_ops, args=(r, PAR_WORLD, port, sub)) for r in range(PAR_WORLD)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + 60
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    verdicts: dict[str, list[str]] = {op: [] for op in GLOO_PROBE_OPS}
    for r, p in enumerate(procs):
        path = os.path.join(sub, f"probe{r}.json")
        res = json.load(open(path)) if os.path.exists(path) else {"trying": GLOO_PROBE_OPS[0]}
        if "trying" in res:  # the process ended (or hung) inside it
            res[res.pop("trying")] = f"refused: the process ended with exit code {p.exitcode}"
        for op, v in res.items():
            verdicts[op].append(f"rank {r} {v}")
    probe = {op: "native" if v and all(x.endswith(" native") for x in v) else "; ".join(v) or "not reached"
             for op, v in verdicts.items()}
    print(f"[{card}] gloo probe on CUDA tensors, two ranks on this card (torch {torch.__version__}): "
          + "; ".join(f"{op}: {v}" for op, v in probe.items())
          + "; parallel/dist.py stages point-to-point through the host, sends all_to_all_single natively")
    if probe["all_to_all_single"] != "native":
        raise RuntimeError(f"gloo does not take CUDA tensors for all_to_all_single ({probe['all_to_all_single']}), "
                           "which parallel/dist.py sends natively")
    return probe


def par_rank(rank: int, world: int, port: int, in_path: str, out_dir: str) -> None:
    """One gloo rank on the one card: pp-serve, pp-train (with its fault),
    ep and sp, results to ``out_dir/rank<r>.pt``."""
    sys.path.insert(0, ROOT)
    logging.basicConfig(level=logging.WARNING)
    d = torch.load(in_path, weights_only=False)
    dev = torch.device(d["device"])
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:  # the kernels load from the parent's build at first launch
        t0 = time.perf_counter()
        out = {"pp_serve": pp_serve_rank(d, dev), "pp_train": pp_train_rank(d, rank, dev), "ep": ep_rank(d, rank, dev),
               "sp": sp_rank(d, rank, dev)}
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def ep_reference(params: dict, xs: list, cap: int, dev) -> dict:
    """The MoE as one process computes it densely: each token's top-1 expert
    FFN scaled by its gate, a token past its source rank's capacity for its
    expert dropped; the aux loss over all tokens; the gradients of
    sum(out^2) / (N d) + 0.01 aux."""
    import torch.nn.functional as F

    p = {k: v.detach().to(dev, copy=True).requires_grad_() for k, v in params.items()}
    outs, onehots, probs_all, dropped = [], [], [], 0
    for x in xs:
        x = torch.from_numpy(x).to(dev)
        probs = torch.softmax(x @ p["router"], dim=-1)
        gate, expert = probs.max(dim=-1)
        onehot = F.one_hot(expert, EP_EXPERTS).float()
        pos = (torch.cumsum(onehot, 0) - onehot).gather(1, expert[:, None])[:, 0]
        kept = pos < cap
        dropped += int((~kept).sum())
        out = torch.zeros_like(x)
        for e in range(EP_EXPERTS):
            idx = torch.nonzero((expert == e) & kept).squeeze(1)
            h = F.gelu(x[idx] @ p["w1"][e] + p["b1"][e]) @ p["w2"][e] + p["b2"][e]
            out = out.index_put((idx,), gate[idx, None] * h)
        outs.append(out)
        onehots.append(onehot)
        probs_all.append(probs)
    n = sum(len(x) for x in xs)
    aux = EP_EXPERTS * torch.sum(torch.cat(onehots).sum(0) / n * (torch.cat(probs_all).sum(0) / n))
    loss = sum((o ** 2).sum() for o in outs) / (n * outs[0].shape[1]) + 0.01 * aux
    loss.backward()
    return {"outs": [o.detach().cpu() for o in outs], "aux": float(aux.detach()), "router": p["router"].grad.cpu(),
            "w1": p["w1"].grad.cpu(), "dropped": dropped}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def parallel_lib_runs(tmp: str, dev, card) -> dict:
    """Phases 42-46: the parallelism library modules (pipeline, pipelined
    AST, MoE, ring and sp), two gloo ranks sharing the card. The gloo probe
    first, in processes of its own; the parent makes every one-process
    reference on the card; then one spawn of PAR_WORLD ranks runs the four
    paths. Checks each path against its reference, the launches a rank and
    the planted fault."""
    from audiossl_tpu_torch.frontend.fused_stft import log_mel_fused
    from audiossl_tpu_torch.frontend.stft import LogMelConfig
    from audiossl_tpu_torch.parallel import dist, ring
    from audiossl_tpu_torch.parallel.moe import init_moe_params

    probe = gloo_probe(tmp, card)
    t_refs = time.perf_counter()
    rng = np.random.default_rng(PP_SEED)
    d = {"device": str(dev), "pp_serve_x": rng.standard_normal((PP_MICRO * PP_MB, 1, *PP_SERVE_INPUT)).astype(np.float32),
         "pp_train_x": (0.5 * rng.standard_normal((PP_MICRO, PP_MB, PP_TOKENS, PP_WIDTH))).astype(np.float32),
         "pp_train_tgt": rng.standard_normal((PP_MICRO, PP_MB, PP_TOKENS, PP_WIDTH)).astype(np.float32),
         "ep_params": init_moe_params(EP_WIDTH, EP_HIDDEN, EP_EXPERTS, torch.Generator().manual_seed(PP_SEED + 20)),
         "ep_x": [(0.7 * rng.standard_normal((EP_TOKENS, EP_WIDTH))).astype(np.float32) for _ in range(PAR_WORLD)],
         "sp_wave": (0.3 * rng.standard_normal((2, SP_CLIP))).astype(np.float32),
         "sp_frames_wave": (0.3 * rng.standard_normal((2, SP_FRAMES_CLIP))).astype(np.float32)}
    # pp-serve: one process's AST-base on the whole batch
    with torch.no_grad():
        serve_ref = pp_serve_encoder(dev)(torch.from_numpy(d["pp_serve_x"]).to(dev)).cpu()
    # pp-train: the sequential stack in one process on the whole batch; each stage's blocks' gradients to a file
    blocks = [pp_train_block(i, dev) for i in range(PP_DEPTH)]
    x = torch.from_numpy(d["pp_train_x"]).to(dev)
    y = x.reshape(-1, *x.shape[2:])
    for blk in blocks:
        y = blk(y)
    loss_ref = ((y.reshape(x.shape) - torch.from_numpy(d["pp_train_tgt"]).to(dev)) ** 2).mean()
    loss_ref.backward()
    per = PP_DEPTH // PAR_WORLD
    d["pp_train_largest"] = max(float(p.grad.abs().max()) for blk in blocks for p in blk.parameters())
    d["pp_train_ref"] = []
    for s in range(PAR_WORLD):
        path = os.path.join(tmp, f"pp_train_ref{s}.pt")
        torch.save({"grads": {f"{j}.{n}": p.grad.cpu() for j in range(per)
                              for n, p in blocks[s * per + j].named_parameters()}}, path)
        d["pp_train_ref"].append(path)
    del blocks, x, y
    loss_ref = float(loss_ref.detach())
    # ep: the dense one-process MoE at each capacity
    ep_ref = {case: ep_reference(d["ep_params"], d["ep_x"], cap, dev) for case, cap in EP_CAPACITY.items()}
    # sp: world 1 (one shard: the whole clips, one log-mel launch, one ring step) and the one-process kernel
    model = sp_model(dev)
    emb_ref = ring.long_audio_forward(model, torch.from_numpy(d["sp_wave"]).to(dev), LogMelConfig(center=False))
    (emb_ref * emb_ref).sum().backward()
    sp_grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    emb_ref = emb_ref.detach().cpu()
    frames_ref = log_mel_fused(torch.from_numpy(d["sp_frames_wave"]).to(dev), LogMelConfig()).cpu()
    torch.cuda.synchronize()
    t_refs = time.perf_counter() - t_refs

    sub = os.path.join(tmp, "parallel_lib")
    os.makedirs(sub)
    torch.save(d, os.path.join(sub, "in.pt"))
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(par_rank, args=(PAR_WORLD, free_port(), os.path.join(sub, "in.pt"), sub),
                                nprocs=PAR_WORLD, join=True)
    t_spawn = time.perf_counter() - t0
    rs = [torch.load(os.path.join(sub, f"rank{r}.pt"), weights_only=False) for r in range(PAR_WORLD)]

    failures, report = [], {"gloo_probe": probe, "references_seconds": t_refs, "spawn_seconds": t_spawn}

    # phase 43: pp-serve
    for r, res in enumerate(rs):
        ps = res["pp_serve"]
        err = rel_err(ps["z"], serve_ref)
        expect_counts(f"pp-serve, rank {r}", ps["counts"], {"rel_attention_fwd": PP_MICRO * PP_DEPTH // PAR_WORLD})
        print(f"[{card}] pp-serve: AST-base ({PP_DEPTH} blocks, {PP_TOKENS} tokens, seeded) pipelined over {PAR_WORLD} stages, B = "
              f"{PP_MICRO * PP_MB} as {PP_MICRO} microbatches, bf16 attention, rank {r}: {ps['seconds']:.3f} s; "
              f"against one process {err:.3e} (bound {TOL_PP_BF16}); launches {ps['counts']}; collectives "
              f"{ps['calls']}")
        report[f"pp_serve_rel_err_rank{r}"] = err
        if not err <= TOL_PP_BF16:
            failures.append(f"pp-serve rank {r}: {err:.3e} from one process")
    # phase 44: pp-train, the f32 gate and the planted fault
    for r, res in enumerate(rs):
        for case, pt in res["pp_train"].items():
            lerr = abs(pt["loss"] - loss_ref) / abs(loss_ref)
            worst = max(pt["errors"], key=pt["errors"].get)
            caught = lerr > TOL_PAR or pt["errors"][worst] > 1.0
            print(f"[{card}] pp-train f32: the vit_block stack ({PP_DEPTH} blocks, D {PP_WIDTH}, {PP_TOKENS} tokens) over "
                  f"{PAR_WORLD} stages, M = {PP_MICRO} of {PP_MB}, forward and backward, rank {r}, {case}: "
                  f"{pt['seconds']:.3f} s; loss rel {lerr:.2e} (bound {TOL_PAR}); worst gradient {worst} at "
                  f"{pt['errors'][worst]:.3e} of its bound; " + ("fails the gate" if caught else "passes the gate")
                  + f"; launches {pt['counts']}; collectives {pt['calls']}")
            report[f"pp_train_rank{r}_{case}"] = {"loss_rel": lerr, "worst_grad_of_bound": pt["errors"][worst]}
            if case == "correct":
                if caught:
                    failures.append(f"pp-train rank {r} strays from one process: loss {lerr:.2e}, {worst}")
                n = PP_MICRO * PP_DEPTH // PAR_WORLD
                expect_counts(f"pp-train, rank {r}", pt["counts"], {name: n for name in ATTN_KERNELS})
            elif not caught:
                failures.append(f"the pp-train gate does not catch {case} on rank {r}")
    # phase 45: ep
    for case, ref in ep_ref.items():
        for r, res in enumerate(rs):
            e = res["ep"][case]
            k = EP_EXPERTS // PAR_WORLD
            largest = max(float(ref["router"].abs().max()), float(ref["w1"].abs().max()))
            errs = {"out": rel_err(e["out"], ref["outs"][r]), "aux": abs(e["aux"] - ref["aux"]) / abs(ref["aux"]),
                    **{g: max(grad_errors({g: e[g]}, {g: want}, largest).values()) for g, want in
                       (("router", ref["router"]), ("w1", ref["w1"][r * k:(r + 1) * k]))}}
            print(f"[{card}] ep f32: the Switch MoE (d {EP_WIDTH}, hidden {EP_HIDDEN}, E = {EP_EXPERTS}, {k} a rank, "
                  f"{EP_TOKENS} tokens a rank, capacity {EP_CAPACITY[case]}: {ref['dropped']} of "
                  f"{EP_TOKENS * PAR_WORLD} tokens dropped), rank {r}: {e['seconds']:.3f} s; out {errs['out']:.2e}, aux "
                  f"{errs['aux']:.2e} (bound {TOL_PAR}); router and w1 gradients at {errs['router']:.3e} and "
                  f"{errs['w1']:.3e} of their bounds; collectives {e['calls']}; launches {e['counts']}")
            report[f"ep_{case}_rank{r}"] = {**errs, "dropped": ref["dropped"]}
            if errs["out"] > TOL_PAR or errs["aux"] > TOL_PAR or errs["router"] > 1.0 or errs["w1"] > 1.0:
                failures.append(f"ep {case} rank {r} strays from the dense computation: {errs}")
            expect_counts(f"ep {case}, rank {r}", e["counts"], {})
    if ep_ref["drops"]["dropped"] == 0:
        failures.append("the ep case with drops dropped no token")
    # phase 46: sp
    largest = max(float(g.abs().max()) for g in sp_grads.values())
    frames = torch.cat([res["sp"]["frames"] for res in rs], dim=2)[..., :frames_ref.shape[-1]]
    ferr = float((frames - frames_ref).abs().max())
    for r, res in enumerate(rs):
        spr = res["sp"]
        eerr = rel_err(spr["emb"], emb_ref)
        gerr = grad_errors(spr["grads"], sp_grads, largest)
        worst = max(gerr, key=gerr.get)
        print(f"[{card}] sp f32: long_audio_forward on {SP_CLIP / 16000:.2f} s clips, B = 2, over {PAR_WORLD} ranks "
              f"({SP_CLIP // PAR_WORLD} samples, {SP_CLIP // PAR_WORLD // 160} frames, {SP_CLIP // PAR_WORLD // 640} "
              f"tokens a rank), rank {r}: forward {spr['seconds']:.3f} s; embeddings {eerr:.2e} (bound {TOL_PAR}); the "
              f"ranks' mean gradient: worst {worst} at {gerr[worst]:.3e} of its bound; launches {spr['counts']}; "
              f"collectives {spr['calls']}")
        report[f"sp_rank{r}"] = {"emb_rel": eerr, "worst_grad_of_bound": gerr[worst]}
        if eerr > TOL_PAR or gerr[worst] > 1.0:
            failures.append(f"sp rank {r} strays from world 1: embeddings {eerr:.2e}, {worst}")
        expect_counts(f"sp long audio, rank {r}", spr["counts"], {"log_mel_fused": 1})
        expect_counts(f"sp frames, rank {r}", spr["frames_counts"], {"log_mel_fused": 1})
    print(f"[{card}] sp frames: {SP_FRAMES_CLIP / 16000:.0f} s clips (the default config) padded and split over "
          f"{PAR_WORLD} ranks, the blocks joined and cut to {frames_ref.shape[-1]} frames, against the one-process "
          f"kernel on the whole clips: max|d| {ferr:.3e} (bound {TOL_KERNEL}); "
          + ("bit for bit equal" if ferr == 0.0 else "not bit for bit equal"))
    report.update(sp_frames_max_abs=ferr, sp_frames_bit_equal=ferr == 0.0)
    if not ferr <= TOL_KERNEL:
        failures.append(f"the sp log-mel blocks are {ferr:.3e} from the one-process kernel")
    print(f"parallelism library: references in one process {t_refs:.1f} s; {PAR_WORLD} gloo ranks on this card, spawn "
          f"and every path {t_spawn:.1f} s (the paths {max(res['seconds'] for res in rs):.1f} s a rank)")
    if failures:
        raise RuntimeError("; ".join(failures))
    report.update({"pp_serve_launches_per_rank": rs[0]["pp_serve"]["counts"],
                   "pp_train_launches_per_rank": rs[0]["pp_train"]["correct"]["counts"],
                   "sp_long_audio_launches_per_rank": rs[0]["sp"]["counts"],
                   "sp_frames_launches_per_rank": rs[0]["sp"]["frames_counts"],
                   "seconds_per_rank": {k: [res[k]["seconds"] if k != "pp_train" else res[k]["correct"]["seconds"]
                                            for res in rs] for k in ("pp_serve", "pp_train", "sp")},
                   "host_staging_copies_per_rank": {k: rs[0][k]["calls"].get("host_staging_copy", 0)
                                                    for k in ("pp_serve", "sp")}})
    return report


if __name__ == "__main__":
    sys.exit(main())
