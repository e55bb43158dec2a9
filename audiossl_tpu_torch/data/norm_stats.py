"""Dataset normalization statistics: the mean and std of log-mel or fbank
features over a manifest (port of ``audiossl_tpu.data.norm_stats``).

Rebuilds extras/mast_new/mast/get_norm_stats.py:16-30 for PrecomputedNorm
and the MAST input norm. The features come from the port's ``FrontendSpec``,
so on the card the fbank runs the dense-rows kernel and the log-mel the
log-mel kernel; each batch's sum and sum of squares are taken in float64 and
added up on the host.

Usage:
  python -m audiossl_tpu_torch.data.norm_stats --csv manifest.csv [--fbank]
      [--file_col files] [--duration 0.95] [--n_mels 64]
      [--target_length N] [--batch_size 256] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from audiossl_tpu_torch import resolve_device
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.frontend import FrontendSpec


def feature_moments(spec: FrontendSpec, loader: ManifestLoader, device: torch.device) -> dict[str, float]:
    """{"mean", "std", "n_elements"} of ``spec``'s features over one pass of
    ``loader`` (the population std, as the JAX CLI computes it)."""
    tot = sq = cnt = 0.0
    with torch.inference_mode():
        for waves, _ in loader.epoch(0):
            f = spec(torch.from_numpy(waves).to(device)).double()
            tot += float(f.sum())
            sq += float(f.square().sum())
            cnt += float(f.numel())
    mean = tot / cnt
    return {"mean": mean, "std": float(np.sqrt(max(sq / cnt - mean * mean, 0.0))), "n_elements": int(cnt)}


def main(argv: list[str] | None = None) -> dict[str, float]:
    p = argparse.ArgumentParser(description="mean / std of a manifest's log-mel or fbank features")
    p.add_argument("--csv", required=True)
    p.add_argument("--file_col", default="files")
    p.add_argument("--duration", type=float, default=0.95)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--n_mels", type=int, default=64)
    p.add_argument("--fbank", action="store_true")
    p.add_argument("--target_length", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    spec = FrontendSpec(kind="fbank" if args.fbank else "logmel", n_mels=args.n_mels, sample_rate=args.sample_rate,
                        target_length=args.target_length)
    loader = ManifestLoader(args.csv, args.batch_size, int(args.duration * args.sample_rate), args.sample_rate,
                            shuffle=False, drop_last=False, file_col=args.file_col)
    stats = feature_moments(spec, loader, dev)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
