"""Offline clustering toolbox: PCA-whitening, k-means, PIC, pseudo-labels
(port of ``audiossl_tpu.objectives.clustering``).

The reference's faiss pipeline (extras/delores-s/clustering.py) in torch on
the caller's device: PCA-whitening by ``eigh`` (faiss.PCAMatrix with
eigen_power -0.5, :31-40), Lloyd k-means after k-means++ seeding (faiss
Clustering, :44-88), and Power Iteration Clustering (:117-280) on the host
with ``scipy.sparse`` as the reference has it (``run_pic``), or as tensor
ops (``run_pic_device``: a gather and a scatter-add matvec, a segment max
and min, pointer doubling). The products run in f32 with TF32 off, as the
JAX package's run at full f32 precision; ``argmin`` ties take the first
index on both sides, and an empty cluster keeps its old centroid.

Draws come in as arguments: ``kmeans_l2`` takes k-means++'s first index
and one uniform in [0, 1) per later pick, which choose as
``jax.random.choice(p=...)`` does (the first index whose cumulative weight
reaches total * (1 - u)), so fed the same draws the two sides pick the
same points; when every remaining weight is 0 (near-duplicate data) that
rule picks index 0, where ``torch.multinomial`` would raise.
``kmeans_draws`` makes them from a numpy generator. ``uniform_label_epoch``
is numpy, bit-equal to the JAX package's for the same generator.

The ``Kmeans`` and ``PIC`` classes keep the reference's ``cluster(data)``
+ ``images_lists`` API, which DeepCluster-v1 (UnifLabelSampler) and the
pseudo-label export use.
"""
from __future__ import annotations

import numpy as np
import torch

from audiossl_tpu_torch import no_tf32


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def pca_whiten(x, dim: int = 128, eigen_power: float = -0.5) -> torch.Tensor:
    """PCA-reduce + whiten + L2-normalize (preprocess_features, :19-40), in
    f32 on ``x``'s device. Eigenvectors have no fixed sign, so columns may
    differ in sign from another library's."""
    x = _as_f32(x)
    with no_tf32():
        xc = x - x.mean(dim=0, keepdim=True)
        cov = (xc.T @ xc) / x.shape[0]
        eigval, eigvec = torch.linalg.eigh(cov)  # ascending
        w = eigvec[:, -dim:] * eigval[-dim:].clamp_min(1e-10).pow(eigen_power)[None, :]
        out = xc @ w
    return out / torch.linalg.vector_norm(out, dim=1, keepdim=True).clamp_min(1e-12)


def kmeans_draws(n: int, k: int, rng: np.random.Generator) -> tuple[int, np.ndarray]:
    """k-means++'s draws for ``n`` points and ``k`` centroids: the first
    index and k - 1 f32 uniforms in [0, 1)."""
    return int(rng.integers(0, n)), rng.random(max(k - 1, 0), dtype=np.float32)


def _sq_dists(x: torch.Tensor, x_sq: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return x_sq - 2.0 * x @ c.T + (c * c).sum(dim=1)[None, :]


def kmeans_l2(x, k: int, first: int, uniforms, n_iters: int = 20) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd k-means with L2 distances after k-means++ seeding, on ``x``'s
    device -> (assignments [N], centroids [k, D], the last iteration's
    objective). ``first`` and ``uniforms`` [k - 1] are the seeding's draws
    (``kmeans_draws``)."""
    x = _as_f32(x)
    n = x.shape[0]
    u = _as_f32(uniforms, x.device)
    with no_tf32():
        x_sq = (x * x).sum(dim=1, keepdim=True)
        cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
        cents[0] = x[first]
        min_d = (x - x[first][None, :]).square().sum(dim=1)
        for i in range(1, k):  # D^2-weighted picks, as jax.random.choice(p=...)
            probs = min_d.clamp_min(0.0)
            probs = probs / probs.sum().clamp_min(1e-12)
            cum = torch.cumsum(probs, dim=0)
            idx = torch.searchsorted(cum, (cum[-1] * (1.0 - u[i - 1])).reshape(1)).clamp_max(n - 1)
            c = x.index_select(0, idx)  # [1, D], no host sync
            cents[i] = c[0]
            min_d = torch.minimum(min_d, (x - c).square().sum(dim=1))
        arange_k = torch.arange(k, device=x.device)
        obj = torch.zeros((), device=x.device)
        for _ in range(n_iters):
            d = _sq_dists(x, x_sq, cents)
            assign = d.argmin(dim=1)
            onehot = (assign[:, None] == arange_k[None, :]).float()
            counts = onehot.sum(dim=0)
            sums = onehot.T @ x
            cents = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], cents)
            obj = d.min(dim=1).values.sum()
        assign = _sq_dists(x, x_sq, cents).argmin(dim=1)
    return assign, cents, obj


class Kmeans:
    """Reference-API k-means (clustering.py:91-115): PCA-whiten, then
    ``kmeans_l2`` with draws from ``np.random.default_rng(seed)``, on the
    data's device (the CPU for numpy data)."""

    def __init__(self, k: int, pca_dim: int = 128, seed: int = 0):
        self.k = k
        self.pca_dim = pca_dim
        self.seed = seed
        self.images_lists: list[list[int]] = []
        self.centroids: torch.Tensor | None = None

    def cluster(self, data, verbose: bool = False) -> float:
        data = _as_f32(data)
        xb = pca_whiten(data, min(self.pca_dim, data.shape[1]))
        first, u = kmeans_draws(xb.shape[0], self.k, np.random.default_rng(self.seed))
        assign, self.centroids, loss = kmeans_l2(xb, self.k, first, u)
        self.images_lists = [[] for _ in range(self.k)]
        for i, a in enumerate(assign.cpu().tolist()):
            self.images_lists[a].append(i)
        return float(loss)


def knn_graph(x, nnn: int) -> tuple[np.ndarray, np.ndarray]:
    """(I, D): ids and L2 distances of each point's self + ``nnn`` nearest
    neighbours (make_graph), nearest first."""
    x = _as_f32(x)
    with no_tf32():
        sq = (x * x).sum(dim=1, keepdim=True)
        d = sq - 2.0 * x @ x.T + sq.T
    neg, idx = torch.topk(-d, nnn + 1, dim=1)
    return idx.cpu().numpy(), np.maximum(-neg.cpu().numpy(), 0.0)


def run_pic(I: np.ndarray, D: np.ndarray, sigma: float = 0.2, alpha: float = 0.001, n_iters: int = 200) -> np.ndarray:
    """Power Iteration Clustering over the NN graph (clustering.py:167-231),
    on the host with ``scipy.sparse``."""
    from scipy.sparse import csr_matrix

    v_count, kk = I.shape
    k = kk - 1
    indices = I[:, 1:].reshape(-1)
    indptr = k * np.arange(v_count + 1)
    data = np.exp(-D[:, 1:] / sigma**2).reshape(-1)
    a = csr_matrix((data, indices, indptr), shape=(v_count, v_count))
    w = a + a.T

    v = np.ones(v_count, np.float32) / v_count
    for _ in range(n_iters):
        vnext = w.T.dot(v)
        vnext = alpha * vnext + (1 - alpha) / v_count
        v = vnext / vnext.sum()

    # local-maxima cluster assignment (find_maxima_cluster)
    wc = w.tocsr()
    pointers = np.arange(v_count)
    for i in range(v_count):
        best = 0.0
        for l in range(wc.indptr[i], wc.indptr[i + 1]):
            j = wc.indices[l]
            vi = wc.data[l] * (v[j] - v[i])
            if vi > best:
                best = vi
                pointers[i] = j
    cluster_ids = -np.ones(v_count, np.int64)
    n_clus = 0
    for i in range(v_count):
        if pointers[i] == i:
            cluster_ids[i] = n_clus
            n_clus += 1
    assign = np.zeros(v_count, np.int64)
    for i in range(v_count):
        cur = i
        while pointers[cur] != cur:
            cur = pointers[cur]
        assign[i] = cluster_ids[cur]
    return assign


def run_pic_device(I: np.ndarray, D: np.ndarray, sigma: float = 0.2, alpha: float = 0.001, n_iters: int = 200,
                   device: str | torch.device = "cpu") -> np.ndarray:
    """``run_pic``'s result from tensor ops on ``device``. w = a + aᵀ is
    symmetric, so (w v)[i] splits into a gather over i's own neighbour row
    and a scatter-add from the rows that list i (duplicate edges sum, as
    csr arithmetic does); the per-row local-maxima search is a segment max
    and a segment min over the directed edges (ties to the smallest column,
    as the host's csr order with a strict '>'); the pointer chase is
    log2(n) rounds of pointer doubling."""
    nb = torch.as_tensor(I[:, 1:], dtype=torch.long, device=device)
    data = torch.exp(-_as_f32(D[:, 1:], device) / sigma**2)
    n, k = nb.shape
    flat_dst = nb.reshape(-1)
    v = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    for _ in range(n_iters):
        fwd = (data * v[nb]).sum(dim=1)
        rev = torch.zeros_like(v).index_add_(0, flat_dst, (data * v[:, None]).reshape(-1))
        vnext = alpha * (fwd + rev) + (1.0 - alpha) / n
        v = vnext / vnext.sum()

    arange = torch.arange(n, device=device)
    # merged weight of each directed edge i -> j: a_ij + a_ji, where a_ji
    # exists iff i is in j's neighbour row
    rev_w = (data[nb] * (nb[nb] == arange[:, None, None])).sum(dim=2)
    w_edge = (data + rev_w).reshape(-1)
    src = arange.repeat_interleave(k)
    owners = torch.cat([src, flat_dst])
    cands = torch.cat([flat_dst, src])
    scores = torch.cat([w_edge, w_edge]) * (v[cands] - v[owners])
    best = torch.zeros_like(v).scatter_reduce(0, owners, scores, reduce="amax", include_self=True)
    is_max = (scores == best[owners]) & (best[owners] > 0)
    ptr = torch.full((n,), n, dtype=torch.long, device=device).scatter_reduce(
        0, owners, torch.where(is_max, cands, n), reduce="amin", include_self=True)
    pointers = torch.where(best > 0, ptr, arange)
    roots = pointers
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))))):
        roots = roots[roots]
    cluster_ids = torch.cumsum((pointers == arange).long(), dim=0) - 1  # ids in node order
    return cluster_ids[roots].cpu().numpy()


class PIC:
    """Reference-API PIC (clustering.py:232-280); ``device=True`` runs
    ``run_pic_device`` (on the data's device), the default the reference's
    host path."""

    def __init__(self, sigma: float = 0.2, nnn: int = 5, alpha: float = 0.001, distribute_singletons: bool = True,
                 device: bool = False):
        self.sigma = sigma
        self.nnn = nnn
        self.alpha = alpha
        self.distribute_singletons = distribute_singletons
        self.device = device
        self.images_lists: list[list[int]] = []

    def cluster(self, data, verbose: bool = False) -> int:
        data = _as_f32(data)
        xb = pca_whiten(data, min(128, data.shape[1]))
        I, D = knn_graph(xb, self.nnn)
        if self.device:
            clust = run_pic_device(I, D, self.sigma, self.alpha, device=data.device)
        else:
            clust = run_pic(I, D, self.sigma, self.alpha)
        images_lists: dict[int, list[int]] = {}
        for idx, c in enumerate(clust):
            images_lists.setdefault(int(c), []).append(idx)
        if self.distribute_singletons:
            moves = {}
            for c, members in images_lists.items():
                if len(members) == 1:
                    s = members[0]
                    for n in I[s, 1:]:
                        if len(images_lists.get(int(clust[n]), [])) != 1:
                            moves[s] = int(clust[n])
                            break
            for s, c in moves.items():
                images_lists[int(clust[s])].remove(s)
                images_lists[c].append(s)
        self.images_lists = [m for m in images_lists.values() if m]
        return 0


def uniform_label_epoch(images_lists: list[list[int]], n: int, rng: np.random.Generator) -> np.ndarray:
    """UnifLabelSampler (src/utils/utils.py:105-148): an epoch of ``n``
    indices drawn uniformly over the non-empty pseudo-label clusters."""
    nonempty = [l for l in images_lists if len(l)]
    per = n // len(nonempty) + 1
    res = np.concatenate([rng.choice(l, per, replace=len(l) <= per) for l in nonempty])
    rng.shuffle(res)
    res = res.astype(np.int64)
    if len(res) >= n:
        return res[:n]
    return np.concatenate([res, res[: n - len(res)]])
