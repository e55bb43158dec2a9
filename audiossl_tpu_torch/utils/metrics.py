"""Training meters, clustering agreement and multi-label scores (port of the
part of ``audiossl_tpu.utils.metrics`` the downstream probe, the clustering
family and the supervised MAST fine-tune use: ``AverageMeter``,
``Accuracy``, ``nmi``, ``mean_average_precision``, ``auc_roc`` and
``d_prime``). numpy and scipy only: the card's machine has no sklearn."""
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


def _entropy(labels: np.ndarray) -> float:
    """Shannon entropy (nats) of a labelling's class frequencies."""
    counts = np.unique(labels, return_counts=True)[1].astype(np.float64)
    if counts.size <= 1:
        return 0.0
    total = counts.sum()
    return float(-np.sum((counts / total) * (np.log(counts) - np.log(total))))


def nmi(labels_a: np.ndarray, labels_b: np.ndarray) -> float:
    """Normalized mutual information with the arithmetic-mean normaliser,
    sklearn's ``normalized_mutual_info_score`` (which the JAX package calls)
    in numpy: 1.0 when both labellings hold one class (or none), 0.0 when
    their mutual information is 0."""
    a, b = np.asarray(labels_a).ravel(), np.asarray(labels_b).ravel()
    if a.shape != b.shape:
        raise ValueError(f"labellings of different lengths: {a.shape} and {b.shape}")
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    if ua.size == ub.size and ua.size <= 1:
        return 1.0
    if ua.size == 1 or ub.size == 1:
        return 0.0
    pairs, nz = np.unique(ia.astype(np.int64) * ub.size + ib, return_counts=True)
    nzx, nzy = pairs // ub.size, pairs % ub.size
    nz = nz.astype(np.float64)
    total = nz.sum()
    pi, pj = np.bincount(ia).astype(np.float64), np.bincount(ib).astype(np.float64)
    p = nz / total
    outer = pi[nzx].astype(np.int64) * pj[nzy].astype(np.int64)
    mi = p * (np.log(nz) - np.log(total)) + p * (-np.log(outer) + np.log(pi.sum()) + np.log(pj.sum()))
    mi = float(np.clip(np.where(np.abs(mi) < np.finfo(np.float64).eps, 0.0, mi).sum(), 0.0, None))
    if mi == 0.0:
        return 0.0
    return mi / ((_entropy(a) + _entropy(b)) / 2.0)


def mean_average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """Macro mAP over classes (multi-label), average precision per class;
    classes with no positive are skipped, 0.0 when none is left."""
    aps = []
    for c in range(targets.shape[1]):
        t = targets[:, c]
        if t.sum() == 0:
            continue
        order = np.argsort(-scores[:, c])
        t_sorted = t[order]
        cum_pos = np.cumsum(t_sorted)
        precision = cum_pos / (np.arange(len(t_sorted)) + 1)
        aps.append(float((precision * t_sorted).sum() / t_sorted.sum()))
    return float(np.mean(aps)) if aps else 0.0


def auc_roc(scores: np.ndarray, targets: np.ndarray) -> float:
    """Macro ROC-AUC over classes in the rank-statistic form. Ranks are
    ordinal (``argsort().argsort()``), not tie-averaged, as in the JAX
    package: tied scores rank in index order. Classes with no positive or no
    negative are skipped, 0.0 when none is left."""
    aucs = []
    for c in range(targets.shape[1]):
        t = targets[:, c]
        pos, neg = t.sum(), (1 - t).sum()
        if pos == 0 or neg == 0:
            continue
        ranks = scores[:, c].argsort().argsort().astype(np.float64) + 1
        auc = (ranks[t > 0].sum() - pos * (pos + 1) / 2) / (pos * neg)
        aucs.append(float(auc))
    return float(np.mean(aucs)) if aucs else 0.0


def d_prime(auc: float) -> float:
    """d' from AUC (stats.py:55-60): sqrt(2) * Phi^-1(AUC)."""
    from scipy.stats import norm

    return float(norm.ppf(auc) * np.sqrt(2.0))
