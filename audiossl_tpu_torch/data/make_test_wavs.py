"""Tiny synthetic WAVs and manifest CSVs for smoke tests and verification
(port of ``audiossl_tpu.data.make_test_wavs``: the same files for a seed).

Usage: python -m audiossl_tpu_torch.data.make_test_wavs <out_dir> [n] [--unlabeled]
Writes <out_dir>/wav_XXX.wav, <out_dir>/pretrain.csv (column ``files``
[+ ``label``]) and <out_dir>/downstream_{train,test}.csv (columns ``wav``,
``label``).
"""
from __future__ import annotations

import os

import numpy as np
import pandas as pd

from audiossl_tpu_torch.data.wav import write_wav


def make(out_dir: str, n: int = 32, sr: int = 16000, labeled: bool = True, seed: int = 0) -> str:
    """``n`` clips of 0.7-1.4 s, a sine in one of four disjoint bands (the
    class, ``i % 4``) plus noise; returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    bands = (220.0, 650.0, 1900.0, 5200.0)
    for i in range(n):
        t = np.arange(int(rng.uniform(0.7, 1.4) * sr)) / sr
        klass = i % 4
        wave = 0.4 * np.sin(2 * np.pi * bands[klass] * rng.uniform(1.0, 1.25) * t)
        wave += 0.1 * rng.standard_normal(len(t))
        path = os.path.join(out_dir, f"wav_{i:03d}.wav")
        write_wav(path, wave.astype(np.float32), sr)
        rows.append({"files": path, "wav": path, "label": klass})
    df = pd.DataFrame(rows)
    df[["files", "label"] if labeled else ["files"]].to_csv(os.path.join(out_dir, "pretrain.csv"), index=False)
    half = n // 2
    df[["wav", "label"]][:half].to_csv(os.path.join(out_dir, "downstream_train.csv"), index=False)
    df[["wav", "label"]][half:].to_csv(os.path.join(out_dir, "downstream_test.csv"), index=False)
    return out_dir


def main(argv: list[str] | None = None) -> str:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default="runs/test_wavs")
    p.add_argument("n", nargs="?", type=int, default=32)
    p.add_argument("--unlabeled", action="store_true", help="omit the label column from pretrain.csv")
    a = p.parse_args(argv)
    make(a.out_dir, a.n, labeled=not a.unlabeled)
    print(a.out_dir)
    return a.out_dir


if __name__ == "__main__":
    main()
