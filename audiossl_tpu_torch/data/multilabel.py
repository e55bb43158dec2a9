"""AudioSet-style multi-label data: a JSON datafile and a label-index CSV
(port of ``audiossl_tpu.data.multilabel``).

The reference MAST fine-tune's input metadata
(extras/mast_new/mast/dataloader.py:21-29 make_index_dict, :58-96
AudiosetDataset): a JSON file {"data": [{"wav": ..., "labels":
"mid1,mid2"}]} and a CSV with columns index,mid,display_name. Targets are
multi-hot float vectors; the lambda-weighted label mixing that goes with the
waveform mixup happens on the device in the train step
(train/finetune_mast.py), not in the loader.

The audio rides ``ManifestLoader``, whose ``labels`` may be an [N, C]
matrix: its batches then yield [B, C] float32 targets.
"""
from __future__ import annotations

import csv
import json

import numpy as np
import pandas as pd

from audiossl_tpu_torch.data.pipeline import ManifestLoader


def make_index_dict(label_csv: str) -> dict[str, int]:
    """mid -> class index (dataloader.py:21-29)."""
    out: dict[str, int] = {}
    with open(label_csv) as f:
        for row in csv.DictReader(f):
            out[row["mid"]] = int(row["index"])
    return out


def load_datafile(data_json: str, index_dict: dict[str, int]) -> tuple[list[str], np.ndarray]:
    """-> (wav paths, [N, C] multi-hot float32 targets)."""
    with open(data_json) as f:
        data = json.load(f)["data"]
    files, targets = [], np.zeros((len(data), len(index_dict)), np.float32)
    for i, datum in enumerate(data):
        files.append(datum["wav"])
        for mid in str(datum["labels"]).split(","):
            targets[i, index_dict[mid.strip()]] = 1.0
    return files, targets


def multilabel_loader(
    data_json: str,
    label_csv: str,
    batch_size: int,
    clip_samples: int,
    sample_rate: int = 16000,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    num_workers: int = 8,
    wire_dtype: str = "int16",
    on_error: str = "raise",
    host_shard: tuple[int, int] | None = None,
) -> tuple[ManifestLoader, int]:
    """-> (loader yielding (waves [B, L], targets [B, C]), n_classes). Train
    loaders shuffle and drop the short last batch; eval loaders take
    ``shuffle=False, drop_last=False``."""
    index_dict = make_index_dict(label_csv)
    files, targets = load_datafile(data_json, index_dict)
    loader = ManifestLoader(
        pd.DataFrame({"files": files}), batch_size, clip_samples, sample_rate,
        shuffle=shuffle, drop_last=drop_last, seed=seed, num_workers=num_workers,
        wire_dtype=wire_dtype, on_error=on_error, host_shard=host_shard,
    )
    loader.labels = targets  # [N, C]: a batch indexes its rows -> [B, C]
    return loader, len(index_dict)
