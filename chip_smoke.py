#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (audiossl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, drives the serving path (WAV requests ->
Hopper log-mel kernel -> AudioNTT-2048 -> embedding) at full width with
seeded weights, checks the outputs, times the kernel, its plain version,
a library composition and serving, and prints:

  * the card's name and power limit as nvidia-smi gives them;
  * one {"kernels": [...]} JSON line (launches on the serving run, error
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
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


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

    # phase 2: build every kernel from the checkout (nvcc's ptxas report goes to stderr)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    for name in kernels.SOURCES:
        t0 = time.perf_counter()
        kernels.load(name)
        print(f"build: {name} loaded in {time.perf_counter() - t0:.1f} s")

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

    # phase 6: the kernel line
    print(json.dumps({"kernels": [{
        "name": "log_mel_fused",
        "route": "cuda",
        "source": "audiossl_tpu_torch/csrc/log_mel.cu",
        "replaces": "audiossl_tpu/frontend/pallas_stft.py:442",
        "also_replaces": ["audiossl_tpu/frontend/pallas_stft.py:292"],
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "design_gflop": design / 1e9,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
