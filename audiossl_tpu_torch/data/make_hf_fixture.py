"""A tiny speech_commands-shaped Hugging Face dataset, built offline (port of
``audiossl_tpu.data.make_hf_fixture``: the same rows for the same sizes).

The reference's HF downstream path loads speech_commands from the hub
(src/dataset/downstream_dataset.py:13-63). Offline, ``data.hf.HFLoader``
reads a ``datasets.save_to_disk`` directory instead
(``AUDIOSSL_HF_DATA_DIR`` / ``data_dir``); this module writes one: a
DatasetDict with train / validation / test splits whose rows have the shape
of decoded speech_commands rows, ``{"audio": {"array": float32[...],
"sampling_rate": 16000}, "label": ClassLabel}`` (a plain struct column of
decoded arrays, which is what ``HFLoader`` reads). The clips are tones of a
class-dependent frequency plus noise, so a linear probe can separate them.

It needs the ``datasets`` package, imported when the fixture is built; where
that package is missing it raises ImportError and builds nothing else.

Usage: python -m audiossl_tpu_torch.data.make_hf_fixture <out_dir> [n_train [n_valid [n_test]]]
"""
from __future__ import annotations

import sys

import numpy as np

# the 12-class speech_commands-v2 vocabulary (extras/datasets/speech_commands_v2_avg.py:21)
LABEL_NAMES = ["yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go", "_silence_", "_unknown_"]
SAMPLE_RATE = 16000
CLIP_SAMPLES = 3200  # 0.2 s


def _datasets():
    try:
        import datasets
    except ImportError as e:
        raise ImportError("make_hf_fixture needs the `datasets` package (pip install datasets); it is not "
                          "installed here") from e
    return datasets


def split_rows(n: int, seed: int) -> dict[str, list]:
    """One split's columns: ``audio`` rows and integer ``label``s."""
    rng = np.random.default_rng(seed)
    labels = [i % len(LABEL_NAMES) for i in range(n)]
    t = np.arange(CLIP_SAMPLES, dtype=np.float32) / SAMPLE_RATE
    rows = []
    for lab in labels:
        phase = rng.uniform(0, 2 * np.pi)
        wave = 0.5 * np.sin(2 * np.pi * (300.0 + 120.0 * lab) * t + phase) + 0.05 * rng.standard_normal(CLIP_SAMPLES)
        if LABEL_NAMES[lab] == "_silence_":
            wave = 0.01 * rng.standard_normal(CLIP_SAMPLES)
        rows.append({"array": wave.astype(np.float32), "sampling_rate": SAMPLE_RATE})
    return {"audio": rows, "label": labels}


def build_fixture(out_dir: str, n_train: int = 72, n_valid: int = 24, n_test: int = 24) -> None:
    ds = _datasets()
    features = ds.Features({
        "audio": {"array": ds.Sequence(ds.Value("float32")), "sampling_rate": ds.Value("int32")},
        "label": ds.ClassLabel(names=LABEL_NAMES),
    })
    ds.DatasetDict({
        split: ds.Dataset.from_dict(split_rows(n, seed), features=features)
        for split, n, seed in (("train", n_train, 0), ("validation", n_valid, 1), ("test", n_test, 2))
    }).save_to_disk(out_dir)


if __name__ == "__main__":
    build_fixture(sys.argv[1], *(int(a) for a in sys.argv[2:]))
