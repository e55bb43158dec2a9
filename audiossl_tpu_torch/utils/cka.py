"""CKA representation similarity (port of ``audiossl_tpu.utils.cka``;
reference extras/CKA.py:1-51).

Linear and RBF-kernel Centered Kernel Alignment between two representation
matrices [N, D1] and [N, D2], on whatever device the tensors are.
"""
from __future__ import annotations

import torch


def _centering(k: torch.Tensor) -> torch.Tensor:
    n = k.shape[0]
    h = torch.eye(n, dtype=k.dtype, device=k.device) - 1.0 / n
    return h @ k @ h


def linear_hsic(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(_centering(x @ x.T) * _centering(y @ y.T))


def linear_cka(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return linear_hsic(x, y) / (torch.sqrt(linear_hsic(x, x)) * torch.sqrt(linear_hsic(y, y)))


def _rbf(x: torch.Tensor, sigma: float | torch.Tensor | None = None) -> torch.Tensor:
    gx = x @ x.T
    d = torch.diagonal(gx)
    kx = d[:, None] + d[None, :] - 2.0 * gx  # squared pairwise distances (extras/CKA.py:15-18)
    if sigma is None:
        i, j = torch.triu_indices(kx.shape[0], kx.shape[0], offset=1, device=kx.device)
        off = kx[i, j]
        # the median of an even count is the mean of the middle two, as np.median's
        mdist = torch.quantile(off, 0.5) if off.numel() else torch.ones((), dtype=kx.dtype, device=kx.device)
        sigma = torch.sqrt(torch.clamp_min(mdist, 1e-12))
    return torch.exp(-kx / (2.0 * sigma**2))


def kernel_hsic(x: torch.Tensor, y: torch.Tensor, sigma: float | None = None) -> torch.Tensor:
    return torch.sum(_centering(_rbf(x, sigma)) * _centering(_rbf(y, sigma)))


def kernel_cka(x: torch.Tensor, y: torch.Tensor, sigma: float | None = None) -> torch.Tensor:
    return kernel_hsic(x, y, sigma) / (torch.sqrt(kernel_hsic(x, x, sigma)) * torch.sqrt(kernel_hsic(y, y, sigma)))
