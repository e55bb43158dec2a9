"""HuggingFace-datasets path of the downstream tasks (speech_commands v1 /
v2), a port of ``audiossl_tpu.data.hf`` (reference: DownstreamDatasetHF,
src/dataset/downstream_dataset.py:13-63, and the availability map,
src/utils/utils.py:31-41).

``HFLoader`` reads a ``datasets.save_to_disk`` directory (``data_dir``, or
the ``AUDIOSSL_HF_DATA_DIR`` environment variable), else
``datasets.load_dataset('speech_commands', 'v0.01' | 'v0.02')`` from the
local HF cache. ``datasets`` is imported when a loader is built; without it
the loader raises an ImportError that names it, so an HF task never skips
silently.

For a seed the batches are the JAX loader's: the epoch order is
``default_rng(seed + epoch)``'s shuffle or, with ``balanced``, its
inverse-class-frequency draw with replacement; one ``default_rng((seed,
epoch[, host]))`` crops the windows clip by clip in batch order;
``host_shard`` = (index, count) takes the rank-strided slice of the shared
order, padded to equal length per host.
"""
from __future__ import annotations

import os

import numpy as np

from audiossl_tpu_torch.ops.windowing import extract_window_np

HF_TASKS = {"speech_commands_v1": "v0.01", "speech_commands_v2": "v0.02", "speech_commands_v235": "v0.02"}


def hf_available(task: str) -> bool:
    return task in HF_TASKS


def _datasets():
    try:
        import datasets
    except ImportError as e:
        raise ImportError("the HF-hosted downstream tasks need the `datasets` package, which is not installed "
                          "(pass --train_csv / --test_csv instead)") from e
    return datasets


class HFLoader:
    """Same batch interface as ManifestLoader: epoch() -> (waves [B, L]
    f32, labels [B] int32)."""

    def __init__(
        self,
        task: str,
        split: str,
        batch_size: int,
        clip_samples: int,
        sample_rate: int = 16000,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        data_dir: str | None = None,
        balanced: bool = False,
        host_shard: tuple[int, int] | None = None,
    ):
        version = HF_TASKS[task]
        datasets = _datasets()
        data_dir = data_dir or os.environ.get("AUDIOSSL_HF_DATA_DIR")
        if data_dir:
            splits = datasets.load_from_disk(data_dir)
            if split not in splits:
                raise ValueError(f"split {split!r} not in offline dataset {data_dir}")
            self.dataset = splits[split]
        else:
            self.dataset = datasets.load_dataset("speech_commands", version, split=split)
        names = self.dataset.features["label"].names
        self.label_to_id = {n: i for i, n in enumerate(names)}
        self.no_of_classes = len(names)
        self.batch_size = batch_size
        self.clip_samples = clip_samples
        self.sample_rate = sample_rate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.balanced = balanced
        self.host_shard = host_shard
        if balanced:
            labels = np.asarray(self.dataset["label"], np.int64)
            w = 1.0 / np.bincount(labels, minlength=self.no_of_classes)[labels]
            self._balanced_p = w / w.sum()

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.host_shard is not None:
            n = -(-n // self.host_shard[1])  # the padded per-host count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _host_slice(self, order: np.ndarray) -> np.ndarray:
        index, count = self.host_shard
        total = -(-len(order) // count) * count
        if total > len(order):
            order = np.concatenate([order, order[: total - len(order)]])
        return order[index::count]

    def epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.balanced:
            order = np.random.default_rng(self.seed + epoch).choice(n, size=n, replace=True, p=self._balanced_p)
        else:
            order = np.arange(n)
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(order)
        return self._host_slice(order) if self.host_shard is not None else order

    def epoch(self, epoch: int = 0):
        order = self.epoch_order(epoch)
        host_key = [self.host_shard[0]] if self.host_shard else []
        rng = np.random.default_rng((self.seed, epoch, *host_key))
        for b in range(len(self)):
            waves, labels = [], []
            for i in order[b * self.batch_size : (b + 1) * self.batch_size]:
                row = self.dataset[int(i)]
                waves.append(extract_window_np(np.asarray(row["audio"]["array"], np.float32), self.clip_samples, rng))
                labels.append(row["label"])
            yield np.stack(waves), np.asarray(labels, np.int32)
