"""Logging and stats persistence (port of ``audiossl_tpu.utils.logging_utils``).

The reference's logging surface: a per-run log file (src/utils/utils.py:230-236),
logging on the first process only (mvit/utils/logging.py:38-54: here rank 0
of the ``torch.distributed`` group, or the only process), the pickle
``Logger`` (utils.py:151-164) and ``PD_Stats`` (decar-v2/utils.py:349-372,
as JSON lines with the same append-and-persist contract).
"""
from __future__ import annotations

import json
import logging
import os
import pickle

from audiossl_tpu_torch.parallel import dist


def get_logger(log_dir: str, name: str = "audiossl_tpu_torch", master_only: bool = True) -> logging.Logger:
    """``name``'s logger with a ``<log_dir>/train.log`` handler at INFO; on a
    rank other than 0 (``master_only``) a logger that drops everything."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    if master_only and dist.rank() != 0:
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        return logger
    os.makedirs(log_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(log_dir, "train.log"))
    fh.setLevel(logging.INFO)
    logger.addHandler(fh)
    return logger


class PickleLogger:
    """An append-and-persist training trace (the reference's ``Logger``)."""

    def __init__(self, path: str):
        self.path = path
        self.data: list = []

    def log(self, point) -> None:
        self.data.append(point)
        with open(self.path, "wb") as fp:
            pickle.dump(self.data, fp, -1)

    @staticmethod
    def load(path: str) -> list:
        with open(path, "rb") as fp:
            return pickle.load(fp)


class JsonStats:
    """``PD_Stats``: rows appended to a JSON-lines file, read back on resume."""

    def __init__(self, path: str, columns: list[str]):
        self.path = path
        self.columns = columns
        self.rows: list[dict] = []
        if os.path.isfile(path):
            with open(path) as f:
                self.rows = [json.loads(line) for line in f if line.strip()]

    def update(self, row, save: bool = True) -> None:
        rec = row if isinstance(row, dict) else dict(zip(self.columns, row))
        self.rows.append(rec)
        if save:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
