#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (audiossl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, started
together), holds each against its plain PyTorch version on the card, and
drives the port's two main paths at full width with seeded weights:

  * serving: WAV requests -> Hopper log-mel kernel -> AudioNTT-2048 ->
    embedding;
  * training: DeLoRes-S pretraining through the ``train_upstream`` entry
    point (configs/delores_s.yaml, B=256, bf16) for 3 steps, whose views
    come from the log-mel kernel and whose block 1 runs the three block-1
    kernels; its exported encoder then serves one batch, and one f32 step
    on the card is held against the same step on the CPU plain path.

It checks the outputs, times each kernel, its plain version and a library
composition, serving and training, and prints:

  * the card's name and power limit as nvidia-smi gives them;
  * one {"kernels": [...]} JSON line (launches on the main paths, error
    against the plain version, times and the bound of each kernel);
  * as the last line {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it exits non-zero at once. Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import logging
import math
import os
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
# f32 training step at B=8, card vs CPU on the same views: the loss, relative;
# all gradients as one vector, relative in norm; the worst single tensor,
# max|d| / max|ref|. At B=8 the gradients are not continuous at round-off
# (ReLU and max-pool routings flip, BatchNorm over 8 clips amplifies each
# flip): f32_step_check prints how far the CPU's own gradients move when
# the views change by 1e-6 relative; the per-tensor bound catches a wrong
# layer, not round-off
TOL_STEP_LOSS = 1e-5
TOL_STEP = 1e-3
TOL_STEP_TENSOR = 5e-2
TRAIN_STEPS = 3
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor
# FLOP/s, bf16 dense tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12


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

    # phase 3: the kernel against its plain version, both f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    default = LogMelConfig()
    cases = [
        ("[256, 15200] hop 160", (SERVE_BATCH, CLIP), default),
        ("[5, 12345] hop 160", (5, 12345), default),
        ("[8, 15200] hop 100", (8, CLIP), LogMelConfig(hop=100)),
    ]
    kernel_err = 0.0
    for label, shape, cfg in cases:
        w = torch.from_numpy((0.5 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        got = fused_stft.log_mel_fused(w, cfg)
        want = log_mel(w, cfg)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"log-mel kernel {label}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
        err = float((got - want).abs().max())
        print(f"log_mel kernel vs plain, {label}: max|d| = {err:.3e} (tol {TOL_KERNEL})")
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

    # phase 5: times at the serving shape, beside the card
    cfg = default
    w = torch.from_numpy((0.5 * rng.standard_normal((SERVE_BATCH, CLIP))).astype(np.float32)).to(dev)
    window = torch.hann_window(cfg.n_fft, periodic=True, device=dev)
    mfb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)).to(dev)

    def library():  # torch.stft (cuFFT) -> power -> mel matmul -> log: a yardstick only
        spec = torch.stft(w, cfg.n_fft, cfg.hop, window=window, center=True, pad_mode="reflect", return_complex=True)
        return torch.log(torch.matmul(mfb, spec.real.square() + spec.imag.square() + EPS64) + EPS32)

    lib_err = float((library() - log_mel(w, cfg)).abs().max())
    ms = cuda_ms(lambda: fused_stft.log_mel_fused(w, cfg))
    plain_ms = cuda_ms(lambda: log_mel(w, cfg))
    library_ms = cuda_ms(library)
    n_frames = cfg.num_frames(CLIP)
    flops = logmel_flops(cfg, SERVE_BATCH * n_frames, int(torch.count_nonzero(mfb)))
    design = fused_stft.design_flops(cfg, SERVE_BATCH * n_frames)
    nbytes = 4 * (SERVE_BATCH * CLIP + SERVE_BATCH * cfg.n_mels * n_frames)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[{card}] log-mel [256, 15200]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (torch.stft) {library_ms:.4f} ms (max|d| vs plain {lib_err:.2e}); "
          f"bound {bound_ms:.4f} ms (function {flops / 1e9:.4f} GFLOP -> {t_ops:.4f} ms, "
          f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms); the kernel's design does "
          f"{design / 1e9:.2f} GFLOP -> {design / PEAK_F32 * 1e3:.4f} ms")

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

    # phase 6: block 1's kernels against their plain versions
    b1_err, grad_errs = block1_checks(dev)

    # phase 7: the training main path through train_upstream, counts from 0
    pretrain = pre["pretrain"]
    with tempfile.TemporaryDirectory() as tmp:
        counts = training_run(pretrain, pool, wav, tmp, dev)
    step_err = f32_step_check(pretrain, pool, dev)

    # phase 8: times at the training shape, beside the card
    b1_times = block1_times(dev, card)
    train_times(pretrain, pool, dev, card)

    # phase 9: the kernel line
    entries = [{
        "name": "log_mel_fused",
        "route": "cuda",
        "source": "audiossl_tpu_torch/csrc/log_mel.cu",
        "replaces": "audiossl_tpu/frontend/pallas_stft.py:442",
        "also_replaces": ["audiossl_tpu/frontend/pallas_stft.py:292"],
        "launches": launches,
        "train_launches": counts["log_mel_fused"],
        "max_abs_err": kernel_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "design_gflop": design / 1e9,
    }]
    for name, line in (("block1_fwd", 174), ("block1_bwd_sums", 216), ("block1_bwd_weight", 235)):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "audiossl_tpu_torch/csrc/block1.cu",
            "replaces": f"audiossl_tpu/ops/block1.py:{line}",
            "launches": counts[name],
            "max_abs_err": b1_err[name],
            **b1_times[name],
        })
    print(json.dumps({"kernels": entries, "block1_grad_rel_err": grad_errs, "f32_step_rel_err": step_err}))
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
        torch.cuda.synchronize()
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


def write_manifest(pool_dir: str, wav, n_rows: int) -> str:
    """16 two-second sine WAVs and a manifest of ``n_rows`` rows cycling over them."""
    t = np.arange(32000) / 16000.0
    files = []
    for i in range(16):
        f0 = 100.0 * 2 ** (i / 4)
        files.append(os.path.join(pool_dir, f"train{i}.wav"))
        wav.write_wav(files[-1], (0.4 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2.7 * f0 * t)).astype(np.float32))
    csv = os.path.join(pool_dir, "manifest.csv")
    with open(csv, "w") as f:
        f.write("files\n" + "".join(f"{files[r % 16]}\n" for r in range(n_rows)))
    return csv


def training_run(pre, pool, wav, tmp, dev) -> dict[str, int]:
    """DeLoRes-S pretraining through train_upstream at full width for
    TRAIN_STEPS steps; checks the losses, the launches per step and that the
    exported encoder serves. Returns the launch counts of the run."""
    from audiossl_tpu_torch import config as cfgmod
    from audiossl_tpu_torch.frontend import build_frontend, fused_stft
    from audiossl_tpu_torch.ops import block1
    from audiossl_tpu_torch.serve.export import build_embedder
    from audiossl_tpu_torch.train.loop import train_upstream

    config = cfgmod.load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "delores_s.yaml"))
    batch = int(config["run"]["batch_size"])
    csv = write_manifest(tmp, wav, batch * TRAIN_STEPS)
    config["run"].update(save_path=os.path.join(tmp, "delores_s"), epochs=1)
    wrappers = {"log_mel_fused": fused_stft.log_mel_fused, "block1_fwd": block1.block1_fwd,
                "block1_bwd_sums": block1.block1_bwd_sums, "block1_bwd_weight": block1.block1_bwd_weight}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    _, step, ckpt_dir = train_upstream(config, csv, "delores_s", max_steps=TRAIN_STEPS, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    with open(os.path.join(ckpt_dir, "stats.jsonl")) as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    print(f"training: train_upstream delores_s, B={batch}, d={pre['base_encoder']['output_dim']}, bf16, "
          f"{step} steps in {seconds:.1f} s (set-up and loading included); losses {losses}; launches {counts}")
    if step != TRAIN_STEPS or len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"training took {step} steps with losses {losses}")
    per_step = {"log_mel_fused": 1, "block1_fwd": 2, "block1_bwd_sums": 2, "block1_bwd_weight": 2}
    for name, n in per_step.items():
        if counts[name] != n * TRAIN_STEPS:
            raise RuntimeError(f"{name} launched {counts[name]} times in {TRAIN_STEPS} steps, expected {n} per step")
    sd = torch.load(os.path.join(ckpt_dir, "encoder", f"{step}.pt"), map_location="cpu", weights_only=True)
    frontend = build_frontend(config["pretrain"]["input"])
    emb = build_embedder(sd, frontend, cfgmod.clip_samples(config), torch.bfloat16, dev)
    with torch.inference_mode():
        out = emb(torch.from_numpy(pool[:SERVE_BATCH]).to(dev))
    d = int(config["pretrain"]["base_encoder"]["output_dim"])
    if out.shape != (SERVE_BATCH, d) or not torch.isfinite(out).all():
        raise RuntimeError(f"the trained encoder's export served {tuple(out.shape)} or non-finite values")
    print(f"training: exported encoder/{step}.pt serves [{SERVE_BATCH}, {CLIP}] -> [{SERVE_BATCH}, {d}], finite")
    return counts


def f32_step_check(pre, pool, dev, b: int = 8) -> dict[str, float]:
    """One f32 DeLoRes-S step at full width on the card against the same step
    on the CPU plain path, from the same weights, waves and draws: the views
    (frontend and augmentation) are compared, then the loss and every
    gradient on the same views. The loss and gradients are compared on the
    CPU's views because at B=8 the gradients are not continuous at the
    views' round-off; to show how far, the CPU's gradients are also taken
    on its views changed by 1e-6 relative."""
    import copy

    from audiossl_tpu_torch import no_tf32
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.train.step import prepare_views

    cfg = {"pretrain": copy.deepcopy(pre), "run": {}}
    cfg["pretrain"]["base_encoder"].update(compute_dtype="float32", dropout=0.0)
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    n_frames = frontend.num_frames(CLIP)
    init = init_objective("delores_s", cfg, seed=0).train()
    card_obj, cpu_obj, noisy_obj = copy.deepcopy(init).to(dev), copy.deepcopy(init), copy.deepcopy(init)
    waves = torch.from_numpy(pool[:b])
    views = []
    for d in (dev, torch.device("cpu")):
        state = pipeline.init_state(frontend.n_mels, n_frames, d)
        draws = pipeline.sample_draws(state, b, frontend.n_mels, n_frames, torch.Generator().manual_seed(5))
        draws = tuple(type(v)(*(t.to(d) for t in v)) for v in draws)
        views.append(prepare_views(pipeline, frontend, "mean_var", state, waves.to(d), draws)[1:])
    view_err = max(float((c.cpu() - r).abs().max()) / max(1.0, float(r.abs().max())) for c, r in zip(*views))
    print(f"f32 step B={b}: views (log-mel kernel, RunningNorm, mixup, crop) card vs CPU: "
          f"max|d| / max(1, max|ref|) = {view_err:.3e} (tol {TOL_F32})")
    if not view_err <= TOL_F32:
        raise RuntimeError(f"the views on the card disagree with the CPU path: {view_err}")
    noise = torch.Generator().manual_seed(7)
    noisy = [v * (1.0 + 1e-6 * torch.randn(v.shape, generator=noise)) for v in views[1]]
    results = []
    for obj, d, vs in ((card_obj, dev, views[1]), (cpu_obj, torch.device("cpu"), views[1]),
                       (noisy_obj, torch.device("cpu"), noisy)):
        with no_tf32():
            loss = obj.loss(*(v.to(d) for v in vs))
            loss.backward()
        results.append((loss.item(), {n: p.grad.cpu() for n, p in obj.named_parameters()}))
    (loss_card, g_card), (loss_cpu, g_cpu), (_, g_noisy) = results
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    flat = lambda g: torch.cat([v.flatten() for v in g.values()])

    def compare(g):
        # per tensor, |d| / (max|ref| + 1e-2 * the largest gradient): the second
        # term covers the round-off of exactly-zero gradients (conv biases before
        # batch-statistics BN), as the CPU parity test holds them
        rels = {n: float((g[n] - ref).abs().max()) / (float(ref.abs().max()) + 1e-2 * scale) for n, ref in g_cpu.items()}
        return rels, float((flat(g) - flat(g_cpu)).norm() / flat(g_cpu).norm())

    rels, grad_err = compare(g_card)
    tensor_err = max(rels.values())
    noise_rels, noise_norm = compare(g_noisy)
    print(f"f32 step B={b}, the CPU alone on its views changed by 1e-6 relative: gradients move by "
          f"{noise_norm:.3e} in norm, the worst tensor by {max(noise_rels.values()):.3e}")
    for name in sorted(rels, key=rels.get, reverse=True)[:3]:
        print(f"  f32 step gradient {name}: max|ref| {float(g_cpu[name].abs().max()):.3e}, "
              f"max|d| {float((g_card[name] - g_cpu[name]).abs().max()):.3e}, relative {rels[name]:.3e}")
    print(f"f32 step B={b}, card vs CPU plain path on the same views: loss {loss_card:.7e} vs {loss_cpu:.7e} "
          f"(relative {loss_err:.3e}, tol {TOL_STEP_LOSS}); gradients |g_card - g_cpu| / |g_cpu| over all "
          f"parameters {grad_err:.3e} (tol {TOL_STEP}); largest per-tensor error {tensor_err:.3e} (tol {TOL_STEP_TENSOR})")
    if not (loss_err <= TOL_STEP_LOSS and grad_err <= TOL_STEP and tensor_err <= TOL_STEP_TENSOR):
        raise RuntimeError(f"the f32 training step on the card disagrees with the CPU path: {loss_err}, {grad_err}, {tensor_err}")
    return {"views": view_err, "loss": loss_err, "gradients": grad_err, "worst_tensor": tensor_err,
            "cpu_1e-6_views_gradients": noise_norm, "cpu_1e-6_views_worst_tensor": max(noise_rels.values())}


def block1_times(dev, card) -> dict[str, dict]:
    """ms, plain_ms, library_ms and the bound of each block-1 kernel at one
    training view ([256, 1, 64, 96] bf16)."""
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

    lib_out = composition()
    lib_fwd = cuda_ms(composition)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (wl, bl, gl, el), dp, retain_graph=True))
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
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=5)
        # each input read once, each output written once; 2 FLOP per MAC at the bf16 rate
        out_f32 = {"block1_fwd": 0, "block1_bwd_sums": 2, "block1_bwd_weight": 10}[name]
        nbytes = 2 * b * f * t + pooled_bytes + 4 * c * (block1.N_PARAMS + out_f32)
        flops = 2.0 * macs * b * c * f * t
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib_ms}
        print(f"[{card}] {name} [256, 1, 64, 96] bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms ({'forward' if name == 'block1_fwd' else 'whole backward'} of the "
              f"cuDNN conv -> batch norm -> ReLU -> max-pool composition); bound {max(t_bytes, t_ops):.4f} ms "
              f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms at the "
              f"bf16 rate, {flops / PEAK_F32 * 1e3:.4f} ms as f32 FFMA)")
    return out


def train_times(pre, pool, dev, card, b: int = 256) -> None:
    """train_clips_per_sec at B=256, bf16, full width on device-resident
    waves: the median of 3 windows of 10 steps on the host clock (each
    window ends in a synchronize), and the step split by CUDA events."""
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.train.optim import sgd_torch
    from audiossl_tpu_torch.train.step import TrainStep

    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    obj = init_objective("delores_s", {"pretrain": pre, "run": {}}, seed=0, device=dev).train()
    step = TrainStep(obj, pipeline, frontend, sgd_torch(obj.parameters(), 0.03), torch.Generator(dev).manual_seed(0))
    state = pipeline.init_state(frontend.n_mels, frontend.num_frames(CLIP), dev)
    waves = torch.from_numpy(pool[:b]).to(dev)
    for _ in range(3):
        state, loss = step(state, waves)
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(10):
            state, loss = step(state, waves)
        torch.cuda.synchronize()
        rates.append(10 * b / (time.perf_counter() - t0))
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"training loss became {loss.item()}")
    parts = {"frontend+augment": 0.0, "forward+backward": 0.0, "optimizer": 0.0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(10):
        ev[0].record()
        state, v1, v2 = step.views(state, waves)
        ev[1].record()
        step.loss_and_grads(v1, v2)
        ev[2].record()
        step.update()
        ev[3].record()
        torch.cuda.synchronize()
        for (name, _), e0, e1 in zip(parts.items(), ev[:3], ev[1:]):
            parts[name] += e0.elapsed_time(e1) / 10
    print(f"[{card}] training B={b} bf16 d={pre['base_encoder']['output_dim']}: train_clips_per_sec "
          f"{float(np.median(rates)):.1f} (median of windows {[round(r, 1) for r in rates]}); step split "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))

    # device time by kernel over 3 steps, and the device's busy share of the
    # window's host-clock time (the profiler's own overhead included)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state, loss = step(state, waves)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
    busy = sum(kernels_us.values())
    if not busy:
        print(f"[{card}] training profile: no device time recorded (not measured)")
        return
    print(f"[{card}] training profile, 3 steps: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"({busy / wall_us:.1%}); {len(kernels_us)} kernels; by device time per step:")
    for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 3e3:9.4f} ms  {us / busy:6.1%}  {name[:110]}")


if __name__ == "__main__":
    sys.exit(main())
