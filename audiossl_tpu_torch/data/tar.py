"""Tar-shard corpora: millions of clips in a few large archives (a copy of
``audiossl_tpu.data.tar``, which the port does not import).

Production corpora cannot live as one file per clip — filesystem metadata
and small random reads dominate the data path long before decode does. A
tar shard is just a byte-range catalog over concatenated WAVs, so the
loader treats `shard.tar::member.wav` manifest entries exactly like plain
files: the index maps each member to (offset, length) inside the shard
once per process, and decode reads that byte range (pread on the C++
path, seek+read on the NumPy path). No reference equivalent — the
reference reads one file per clip through librosa
(src/dataset/upstream_dataset.py:55); this is the web-scale variant of
the same contract.

Manifest forms accepted by ManifestLoader:
  * ``shard.tar::inner/clip.wav`` — one member (labels work as usual,
    which is how UnFuSeD pseudo-label CSVs address sharded corpora);
  * a bare ``shard.tar`` row — expands to every ``.wav`` member in the
    archive, in archive order (unlabeled manifests only).

`python -m audiossl_tpu_torch.data.tar <wav_manifest.csv> <out_dir>` packs an
existing manifest into fixed-size shards and writes the new manifest.
"""
from __future__ import annotations

import logging
import os
import tarfile
import threading

log = logging.getLogger("audiossl_tpu_torch.data.tar")

SEP = ".tar::"  # entry separator: <shard path>.tar::<member name>

# per-process member index cache: tar path -> {member: (offset, length)}
_index_cache: dict[str, dict[str, tuple[int, int]]] = {}
_index_lock = threading.Lock()


def index_tar(tar_path: str) -> dict[str, tuple[int, int]]:
    """member name -> (data offset, byte length) for every regular file.

    One sequential header scan per shard per process (tarfile reads only
    the 512-byte headers); cached for the life of the process.
    """
    with _index_lock:
        hit = _index_cache.get(tar_path)
    if hit is not None:
        return hit
    idx: dict[str, tuple[int, int]] = {}
    with tarfile.open(tar_path, "r:") as tf:
        for m in tf.getmembers():
            if m.isfile():
                idx[m.name] = (m.offset_data, m.size)
    with _index_lock:
        _index_cache[tar_path] = idx
    return idx


def is_tar_entry(entry: str) -> bool:
    return SEP in entry


def split_entry(entry: str) -> tuple[str, str]:
    """'shard.tar::a/b.wav' -> ('shard.tar', 'a/b.wav')."""
    tar_path, member = entry.split(SEP, 1)
    return tar_path + ".tar", member


def entry_range(entry: str) -> tuple[str, int, int]:
    """-> (shard path, offset, length) for a tar entry."""
    tar_path, member = split_entry(entry)
    idx = index_tar(tar_path)
    try:
        off, ln = idx[member]
    except KeyError:
        raise FileNotFoundError(f"member {member!r} not in {tar_path}") from None
    return tar_path, off, ln


def expand_manifest(files: list[str]) -> list[str]:
    """Replace bare ``*.tar`` rows with one entry per ``.wav`` member
    (archive order — deterministic, so epoch seeds reproduce)."""
    out: list[str] = []
    for f in files:
        if f.endswith(".tar") and not is_tar_entry(f):
            idx = index_tar(f)
            members = [n for n in idx if n.lower().endswith(".wav")]
            if not members:
                raise ValueError(f"no .wav members in {f}")
            out.extend(f + "::" + n for n in members)
        else:
            out.append(f)
    return out


def read_entry_bytes(entry: str) -> bytes:
    """Byte range of one member (NumPy decode path)."""
    tar_path, off, ln = entry_range(entry)
    with open(tar_path, "rb") as fh:
        fh.seek(off)
        return fh.read(ln)


def resolve_ranges(files: list[str]) -> tuple[list[str], list[int], list[int]]:
    """-> (real paths, offsets, lengths) for the native ranged loader;
    plain files get (0, -1) = whole file."""
    paths, offs, lens = [], [], []
    for f in files:
        if is_tar_entry(f):
            try:
                p, o, ln = entry_range(f)
            except FileNotFoundError:
                # missing member behaves like a missing file: a zero-byte
                # range the native loader fails (and zero-fills under
                # on_error='zeros') exactly like an unreadable path
                p, o, ln = split_entry(f)[0], 0, 0
            paths.append(p)
            offs.append(o)
            lens.append(ln)
        else:
            paths.append(f)
            offs.append(0)
            lens.append(-1)
    return paths, offs, lens


def write_shards(
    files: list[str],
    out_dir: str,
    shard_clips: int = 2048,
    prefix: str = "shard",
) -> list[str]:
    """Pack WAV files into fixed-count tar shards -> tar::member entries.

    Uncompressed, member names are the source basenames (disambiguated
    with the running index on collision), so shards stream and seek well.
    """
    os.makedirs(out_dir, exist_ok=True)
    entries: list[str] = []
    seen: set[str] = set()
    tf = None
    tar_path = ""
    try:
        for i, f in enumerate(files):
            if i % shard_clips == 0:
                if tf is not None:
                    tf.close()
                tar_path = os.path.join(out_dir, f"{prefix}-{i // shard_clips:05d}.tar")
                tf = tarfile.open(tar_path, "w")
                seen = set()
            name = os.path.basename(f)
            if name in seen:
                name = f"{i}-{name}"
            seen.add(name)
            tf.add(f, arcname=name)
            entries.append(tar_path + "::" + name)
    finally:
        if tf is not None:
            tf.close()
    return entries


def main() -> None:
    import argparse

    import pandas as pd

    p = argparse.ArgumentParser(description="Pack a WAV manifest into tar shards")
    p.add_argument("manifest", help="CSV with a `files` column of WAV paths")
    p.add_argument("out_dir", help="directory for shards + sharded manifest")
    p.add_argument("--shard-clips", type=int, default=2048, help="clips per shard")
    p.add_argument("--file-col", default="files")
    args = p.parse_args()

    df = pd.read_csv(args.manifest)
    entries = write_shards(df[args.file_col].tolist(), args.out_dir, args.shard_clips)
    df[args.file_col] = entries
    out_csv = os.path.join(args.out_dir, "manifest.csv")
    df.to_csv(out_csv, index=False)
    n_shards = len({e.split(SEP)[0] for e in entries})
    log.info("wrote %d clips into %d shards; manifest: %s", len(entries), n_shards, out_csv)
    print(out_csv)


if __name__ == "__main__":
    main()
