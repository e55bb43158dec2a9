"""How far a round-off-sized change of its views moves the f32 DeLoRes-S
gradients of the PyTorch port (audiossl_tpu_torch), on the CPU:

    python scripts/torch_step_flips.py --batch 8 --starts 0 8 100 200 --eps 1e-7 1e-6

Each batch is ``--batch`` clips of chip_smoke.py's serving pool from a start
index, with chip_smoke.py's f32 step (configs/delores_s.yaml at full width,
dropout 0, the same draws). For each eps it prints how far the gradients
move when the views are multiplied by 1 + eps * N(0, 1): all of them in
norm, and the worst tensor in norm relative to its own norm + 1e-3 of the
largest. The moves come in steps that do not shrink with eps: single ReLU,
max-pool and temporal-max routings flip, in some batches, which is why
chip_smoke.py's step gate asks half of its 12 batches to pass every bound.
"""
from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from audiossl_tpu_torch import config as cfgmod, no_tf32  # noqa: E402
from audiossl_tpu_torch.data import wav  # noqa: E402
from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline  # noqa: E402
from audiossl_tpu_torch.frontend import build_frontend  # noqa: E402
from audiossl_tpu_torch.objectives import init_objective  # noqa: E402
from audiossl_tpu_torch.train.step import prepare_views  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--starts", type=int, nargs="+", default=[0, 8, 100, 200])
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-6])
    args = ap.parse_args()
    pre = cfgmod.load_config(os.path.join(cfgmod.CONFIG_DIR, "delores_s.yaml"))["pretrain"]
    with tempfile.TemporaryDirectory() as tmp:
        pool = chip_smoke.sine_requests(300, np.random.default_rng(0), tmp, wav)
    cfg = {"pretrain": copy.deepcopy(pre), "run": {}}
    cfg["pretrain"]["base_encoder"].update(compute_dtype="float32", dropout=0.0)
    frontend = build_frontend(pre["input"])
    pipeline = AugmentPipeline(AugmentConfig.from_dict(pre), epoch_samples=10**6)
    n_frames = frontend.num_frames(chip_smoke.CLIP)
    init = init_objective("delores_s", cfg, seed=0).train()
    cpu = torch.device("cpu")

    def grads(views):
        obj = copy.deepcopy(init)
        with no_tf32():
            obj.loss(*views).backward()
        return {n: p.grad for n, p in obj.named_parameters()}

    flat = lambda g: torch.cat([v.flatten() for v in g.values()])
    for start in args.starts:
        waves = torch.from_numpy(pool[(np.arange(args.batch) + start) % len(pool)])
        state = pipeline.init_state(frontend.n_mels, n_frames, cpu)
        draws = pipeline.sample_draws(state, args.batch, frontend.n_mels, n_frames, torch.Generator().manual_seed(5))
        views = prepare_views(pipeline, frontend, "mean_var", state, waves, draws)[1:]
        g0 = grads(views)
        largest = max(float(v.norm()) for v in g0.values())
        for eps in args.eps:
            noise = torch.Generator().manual_seed(7)
            g1 = grads([v * (1.0 + eps * torch.randn(v.shape, generator=noise)) for v in views])
            whole = float((flat(g1) - flat(g0)).norm() / flat(g0).norm())
            per = {n: float((g1[n] - g0[n]).norm()) / (float(g0[n].norm()) + 1e-3 * largest) for n in g0}
            worst = max(per, key=per.get)
            print(f"B={args.batch} start={start} eps={eps:.0e}: gradients move {whole:.3e} in norm; "
                  f"worst tensor {worst} {per[worst]:.3e}", flush=True)


if __name__ == "__main__":
    main()
