"""CSV-manifest input pipeline: decode on host threads, window, batch.

Port of the NumPy path of ``audiossl_tpu.data.pipeline.ManifestLoader``: the
host decodes WAVs and crops one random window per clip; the frontend runs on
the device inside the train step. Batches are ``[B, clip_samples]`` float32,
or int16 PCM with ``wire_dtype="int16"`` (half the host->device bytes; the
step rescales by 1/32768).

For a seed the loader gives the JAX loader's batches: the epoch order is
``default_rng(seed + epoch)``'s shuffle, and one ``default_rng((seed,
epoch))`` draws the window starts clip by clip in batch order. Decoding runs
on a thread pool a few batches ahead; the windows are drawn in order on the
consuming thread, so the batches do not depend on the number of workers.
After each batch ``position`` holds (epoch, next batch, window-rng state),
which a checkpoint stores so that a resumed run continues the same stream.

Labelled manifests (the downstream probe's) name their file and label
columns; ids come from ``labels_map`` or, as in JAX, from the sorted set of
the labels. ``labels`` may also be set to an [N, C] float32 matrix (the
multi-label fine-tune, data/multilabel.py): a batch then yields its [B, C]
rows. ``balanced`` draws the epoch's order with replacement, each clip
weighted by the inverse of its class's count, from ``default_rng(seed +
epoch)`` as the JAX loader does. Eval loaders take ``shuffle=False`` and
``drop_last=False``.

``host_shard=(rank, world)`` (one process per card, train/loop.py): every
process draws the same global order and takes its rank-strided slice,
padded by wrapping to equal length (DistributedSampler's rule, JAX's
``_host_slice``); ``len`` is the batches of one process, and the window rng
is ``default_rng((seed, epoch, rank))``, the rank mixed in only when
sharded, as in JAX.

Manifest rows may be tar-shard members, ``shard.tar::member.wav``, read as
a byte range (data/tar.py); a bare ``shard.tar`` row expands to its
``.wav`` members in archive order, in an unlabelled manifest only.

As in JAX, each batch is decoded and windowed in the C++ loader
(data/native.py) whenever its library builds, with the JAX native path's
per-batch seeds, ``SeedSequence([seed, epoch, batch(, rank)])``, one thread
preparing batches ahead; where it does not build, the loader takes the
NumPy path, as JAX falls back. The loader logs which path it took and
``native`` on it says so; ``native=False`` asks for the NumPy path (whose
windows equal JAX's NumPy path for any number of workers).
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import logging
import os
from typing import Any, Iterator

import numpy as np
import pandas as pd

from audiossl_tpu_torch.data import native as native_lib
from audiossl_tpu_torch.data import tar as tarmod
from audiossl_tpu_torch.data.wav import load_wave, load_wave_bytes
from audiossl_tpu_torch.ops.windowing import extract_window_np

log = logging.getLogger("audiossl_tpu_torch.data")

PREFETCH_BATCHES = 4


class ManifestLoader:
    """Iterates (waves [B, L], labels [B] int64, [B, C] float32 targets or
    None) batches from a CSV:
    the reference upstream dataset's ``files`` column
    (src/dataset/upstream_dataset.py:50-88), or a labelled manifest's file
    and label columns."""

    def __init__(
        self,
        csv_path: str | pd.DataFrame,
        batch_size: int,
        clip_samples: int,
        sample_rate: int = 16000,
        labeled: bool = False,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        file_col: str = "files",
        label_col: str = "label",
        labels_map: dict | None = None,
        path_prefix: str | None = None,
        wire_dtype: str = "float32",
        host_shard: tuple[int, int] | None = None,
        on_error: str = "raise",
        balanced: bool = False,
        native: bool = True,
    ):
        if on_error not in ("raise", "zeros"):
            raise ValueError(f"on_error must be 'raise' or 'zeros', got {on_error!r}")
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be 'float32' or 'int16', got {wire_dtype!r}")
        self.df = csv_path.reset_index(drop=True) if isinstance(csv_path, pd.DataFrame) else pd.read_csv(csv_path)
        self.files = self.df[file_col].tolist()
        if path_prefix:
            self.files = [os.path.join(path_prefix, f) for f in self.files]
        if any(f.endswith(".tar") and not tarmod.is_tar_entry(f) for f in self.files):
            if labeled:  # expansion changes the row count (JAX data/pipeline.py:82-95)
                raise ValueError(
                    "bare .tar manifest rows cannot carry labels; list "
                    "`shard.tar::member.wav` rows with a label column instead"
                )
            self.files = tarmod.expand_manifest(self.files)
        self._any_tar = any(tarmod.is_tar_entry(f) for f in self.files)
        if host_shard is not None and not 0 <= host_shard[0] < host_shard[1]:
            raise ValueError(f"host_shard must be (rank, world) with 0 <= rank < world, got {host_shard}")
        self.host_shard = host_shard
        self.labels = None
        if labeled:  # the train split's ids are reused for valid and test (train_downstream.py:59)
            self.label_to_id = labels_map or {lab: i for i, lab in enumerate(sorted(set(self.df[label_col])))}
            self.labels = np.asarray([self.label_to_id[lab] for lab in self.df[label_col]], np.int64)
        self.balanced = balanced
        if balanced:  # inverse class frequency, with replacement (moco_dataset.py:154-166)
            if self.labels is None:
                raise ValueError("balanced=True requires a labeled manifest")
            w = 1.0 / np.bincount(self.labels)[self.labels]
            self.balanced_p = w / w.sum()
        self.batch_size = batch_size
        self.clip_samples = clip_samples
        self.sample_rate = sample_rate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.wire_dtype = wire_dtype
        self.on_error = on_error
        self.native = bool(native) and native_lib.available()
        log.info("ManifestLoader: %s", "native C++ decode" if self.native else
                 "the native library is unavailable; NumPy decode" if native else "NumPy decode (asked)")
        self.position: dict[str, Any] | None = None

    def __len__(self) -> int:
        n = len(self.files)
        if self.host_shard is not None:
            n = -(-n // self.host_shard[1])  # the padded per-process count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self.files)

    def _decode(self, idx: int) -> np.ndarray | None:
        """The decoded wave, or None for a bad file under on_error='zeros'."""
        f = self.files[idx]
        try:
            if tarmod.is_tar_entry(f):
                return load_wave_bytes(tarmod.read_entry_bytes(f), self.sample_rate)
            return load_wave(f, self.sample_rate)
        except Exception:
            if self.on_error != "zeros":
                raise
            log.warning("bad audio file, substituting silence: %s", self.files[idx])
            return None

    def _window(self, waves: list[np.ndarray | None], rng: np.random.Generator) -> np.ndarray:
        # a bad file becomes silence without a draw, as the JAX loader does
        out = np.stack([
            np.zeros(self.clip_samples, np.float32) if w is None else extract_window_np(w, self.clip_samples, rng)
            for w in waves
        ]).astype(np.float32)
        if self.wire_dtype == "int16":
            out = np.clip(out * 32768.0, -32768, 32767).astype(np.int16)
        return out

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The clips of ``epoch`` in order: a weighted draw (balanced), a
        shuffle, or the manifest's own order."""
        if self.balanced:
            n = len(self.files)
            return np.random.default_rng(self.seed + epoch).choice(n, size=n, replace=True, p=self.balanced_p)
        order = np.arange(len(self.files))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def host_slice(self, order: np.ndarray) -> np.ndarray:
        """This process's rank-strided slice of the global order, wrapped to
        an equal length on every process (JAX's ``_host_slice``)."""
        if self.host_shard is None:
            return order
        rank, world = self.host_shard
        total = -(-len(order) // world) * world
        if total > len(order):
            order = np.concatenate([order, order[: total - len(order)]])
        return order[rank::world]

    def _native_batch(self, idxs: np.ndarray, epoch: int, b: int) -> np.ndarray:
        """The C++ loader's batch, seeded as JAX's native path seeds it."""
        host_key = [self.host_shard[0]] if self.host_shard else []
        seed = int(np.random.SeedSequence([self.seed, epoch, b, *host_key]).generate_state(1)[0])
        files = [self.files[i] for i in idxs]
        offsets = lengths = None
        if self._any_tar:
            files, offsets, lengths = tarmod.resolve_ranges(files)
        waves = native_lib.load_batch(files, self.clip_samples, self.sample_rate, seed=seed,
                                      n_threads=max(self.num_workers, 1), on_error=self.on_error,
                                      offsets=offsets, lengths=lengths)
        if self.wire_dtype == "int16":
            waves = np.clip(waves * 32768.0, -32768, 32767).astype(np.int16)
        return waves

    def epoch(self, epoch: int = 0, start: int = 0, rng_state: dict | None = None,
              order: np.ndarray | None = None) -> Iterator:
        """Batches ``start`` .. of ``epoch``; ``rng_state`` is the window-rng
        state a checkpoint saved at ``start`` (``position``). ``order``
        replaces the epoch's order with these clip indices (DeepCluster-v1's
        UnifLabelSampler epoch, utils.py:105-148)."""
        order = self.host_slice(self.epoch_order(epoch) if order is None else np.asarray(order))
        n_batches = len(order) // self.batch_size if self.drop_last else -(-len(order) // self.batch_size)
        # the rank enters the window stream only when sharded, as in JAX (pipeline.py:186-191)
        rng = np.random.default_rng((self.seed, epoch, *([self.host_shard[0]] if self.host_shard else [])))
        if rng_state is not None:
            rng.bit_generator.state = rng_state
        batch_idx = lambda b: order[b * self.batch_size : (b + 1) * self.batch_size]

        def finish(b: int, got) -> tuple[np.ndarray, np.ndarray | None]:
            """Batch b from the native batch, or from the decoded waves windowed here."""
            batch = got if self.native else self._window(got, rng)
            self.position = {"epoch": epoch, "batch": b + 1, "rng": rng.bit_generator.state}
            return batch, None if self.labels is None else self.labels[batch_idx(b)]

        if self.num_workers <= 1:
            for b in range(start, n_batches):
                yield finish(b, self._native_batch(batch_idx(b), epoch, b) if self.native
                             else [self._decode(i) for i in batch_idx(b)])
            return
        # the C++ loader threads inside a batch: one Python thread runs its batches ahead, as in JAX
        pool = cf.ThreadPoolExecutor(1 if self.native else self.num_workers)
        try:
            pending: collections.deque = collections.deque()
            nxt = start
            while nxt < n_batches or pending:
                while nxt < n_batches and len(pending) < PREFETCH_BATCHES:
                    pending.append((nxt, pool.submit(self._native_batch, batch_idx(nxt), epoch, nxt) if self.native
                                    else [pool.submit(self._decode, i) for i in batch_idx(nxt)]))
                    nxt += 1
                b, job = pending.popleft()
                yield finish(b, job.result() if self.native else [f.result() for f in job])
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
