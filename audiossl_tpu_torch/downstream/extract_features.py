"""Offline feature extraction: WAV manifests -> .npy log-mel or embeddings
(port of ``audiossl_tpu.downstream.extract_features``; reference:
extras/datasets/extract_features.py).

Host threads decode, the device computes the log-mel (the Hopper log-mel
kernel on the card) and, with ``--checkpoint``, the embeddings of a port
DeLoRes-style AudioNTT checkpoint (its newest ``encoder/<step>.pt``, the
time mean of the final features, bf16 compute as in JAX) in large batches.
One ``.npy`` per clip goes under ``--out`` at the clip's path relative to
the manifest's common directory, so equal basenames in different class
directories do not collide. ``--l2_norm`` L2-normalises each wave first (for
the log-mel only, as in JAX).

    python -m audiossl_tpu_torch.downstream.extract_features --csv manifest.csv \\
        --out feats_dir [--file_col wav] [--duration 1.0] [--l2_norm] \\
        [--checkpoint <save_path>_chkp] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from audiossl_tpu_torch import resolve_device
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.frontend import logmel_features
from audiossl_tpu_torch.frontend.stft import LogMelConfig
from audiossl_tpu_torch.ops.stats import l2_normalize


def get_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--csv", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--file_col", default="AudioPath")
    p.add_argument("--duration", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--n_mels", type=int, default=64)
    p.add_argument("--l2_norm", action="store_true", help="L2-normalise the waves (extract_features.py:68)")
    p.add_argument("--checkpoint", default=None, help="emit AudioNTT embeddings of this checkpoint instead of log-mels")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    """Writes the feature files; returns how many."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    clip = int(args.duration * args.sample_rate)
    mel_cfg = LogMelConfig(sample_rate=args.sample_rate, n_mels=args.n_mels)
    loader = ManifestLoader(args.csv, args.batch_size, clip, args.sample_rate, shuffle=False, drop_last=False,
                            file_col=args.file_col)

    model = None
    if args.checkpoint:
        from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6
        from audiossl_tpu_torch.models.surgery import newest_encoder

        sd = torch.load(newest_encoder(args.checkpoint), map_location="cpu", weights_only=True)
        model = AudioNTT2020Task6(n_mels=args.n_mels, d=int(sd["fc.3.weight"].shape[0]))
        model.load_state_dict(sd, strict=True)
        model = model.to(dev).eval()

    @torch.inference_mode()
    def features(waves: torch.Tensor) -> torch.Tensor:
        if model is not None:
            return model(logmel_features(waves, mel_cfg)[:, None]).mean(dim=1)
        if args.l2_norm:
            waves = l2_normalize(waves, dim=-1)
        return logmel_features(waves, mel_cfg)

    files = [os.path.abspath(f) for f in loader.files]
    common = os.path.commonpath(files) if len(files) > 1 else os.path.dirname(files[0])
    pos = 0
    for waves, _ in loader.epoch(0):
        out = features(torch.from_numpy(waves).to(dev)).cpu().numpy()
        for i in range(len(out)):
            dst = os.path.join(args.out, os.path.relpath(files[pos + i], common) + ".npy")
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            np.save(dst, out[i])
        pos += len(out)
    print(f"wrote {pos} feature files to {args.out}")
    return pos


if __name__ == "__main__":
    main()
