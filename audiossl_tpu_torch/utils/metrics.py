"""Training meters (port of the part of ``audiossl_tpu.utils.metrics`` the
downstream probe uses: ``AverageMeter`` and ``Accuracy``). The mAP, AUC and
d-prime metrics come with the supervised fine-tune (ROADMAP.md Queue 1)."""
from __future__ import annotations

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Accuracy:
    """Streaming accuracy over boolean prediction-correctness arrays (the
    reference's ``Metric``)."""

    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, correct_mask: np.ndarray):
        self.correct += int(np.sum(correct_mask))
        self.total += int(np.size(correct_mask))

    @property
    def avg(self) -> float:
        return self.correct / max(self.total, 1)
