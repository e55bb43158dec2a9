"""Offline pseudo-labelling: features -> k-means -> labelled CSV (port of
``audiossl_tpu.objectives.make_pseudo_labels``).

extras/decar-v2/store_clusters.py (SURVEY.md §3.5): the frozen AudioNTT of a
pretraining run embeds every clip of the manifest (eval mode, the raw
log-mel, max+mean pooled), then PCA-whitening + k-means (585 clusters by
default, the UnFuSeD task_label lineage) labels them, and a ``files,label``
CSV is written, which ``train_upstream --upstream unfused`` reads.

    python -m audiossl_tpu_torch.objectives.make_pseudo_labels \\
        --csv pre_train.csv --checkpoint runs/delores_s_chkp --out labeled.csv \\
        [--clusters 585] [--save_centroids centroids.npy] [--device cuda|cpu]

``--checkpoint`` is a port run's ``<save_path>_chkp``: its newest
``encoder/<step>.pt`` (AudioNTT, reference layout). ``--save_centroids``
also writes the [K', n_mels] time-averaged log-mel means of the K'
non-empty clusters, the space Kmix measures distances in
(augmentations.py:146-151), for ``Kmix.centroid_path``. On the card the
log-mel kernel runs once a batch.
"""
from __future__ import annotations

import argparse
import csv

import numpy as np
import torch

from audiossl_tpu_torch import resolve_device
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.frontend import FrontendSpec
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6, max_mean_pool
from audiossl_tpu_torch.models.surgery import newest_encoder
from audiossl_tpu_torch.objectives.clustering import Kmeans


def get_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--csv", required=True)
    p.add_argument("--checkpoint", required=True, help="a pretraining run's <save_path>_chkp directory")
    p.add_argument("--out", required=True)
    p.add_argument("--clusters", type=int, default=585)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--length_wave", type=float, default=0.95)
    p.add_argument("--n_mels", type=int, default=64)
    p.add_argument("--output_dim", type=int, default=2048)
    p.add_argument("--file_col", default="files")
    p.add_argument("--save_centroids", default=None)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """-> {"labels": [N], "files": [N], "loss": k-means objective,
    "centroids": [K', n_mels] or None}."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    frontend = FrontendSpec("logmel", args.n_mels, 16000)
    clip = int(args.length_wave * frontend.sample_rate)
    model = AudioNTT2020Task6(n_mels=args.n_mels, d=args.output_dim)
    model.load_state_dict(torch.load(newest_encoder(args.checkpoint), map_location="cpu", weights_only=True),
                          strict=True)
    model = model.to(dev).eval()
    loader = ManifestLoader(args.csv, args.batch_size, clip, frontend.sample_rate, shuffle=False, drop_last=False,
                            file_col=args.file_col)
    feats, mel_avgs = [], []
    with torch.no_grad():
        for waves, _ in loader.epoch(0):
            lms = frontend(torch.from_numpy(waves).to(dev))
            feats.append(max_mean_pool(model(lms[:, None])))
            mel_avgs.append(lms.mean(dim=-1))
    features, mel_avg = torch.cat(feats), torch.cat(mel_avgs)

    km = Kmeans(args.clusters)
    loss = km.cluster(features)
    labels = np.empty(len(features), np.int64)
    for c, members in enumerate(km.images_lists):
        labels[members] = c
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["files", "label"])
        w.writerows(zip(loader.files, labels.tolist()))
    print(f"wrote {len(labels)} pseudo-labels ({args.clusters} clusters, kmeans loss {loss:.2f}) to {args.out}")
    cents = None
    if args.save_centroids:
        cents = torch.stack([mel_avg[m].mean(dim=0) for m in km.images_lists if m]).cpu().numpy()
        np.save(args.save_centroids, cents)
        print(f"wrote Kmix centroids {cents.shape} to {args.save_centroids}")
    return {"labels": labels, "files": loader.files, "loss": loss, "centroids": cents}


if __name__ == "__main__":
    main()
