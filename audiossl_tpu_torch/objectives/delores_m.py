"""The MoCo queue pieces of DeLoRes-M (port of ``audiossl_tpu.objectives.delores_m``):
``info_nce`` and ``queue_update``, which SS-MAST shares. The rest of DeLoRes-M
(per-layer Barlow taps, shuffle-BN) is ROADMAP.md Queue 1, slice 4."""
from __future__ import annotations

import torch

from audiossl_tpu_torch import no_tf32


def info_nce(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor, temperature: float) -> torch.Tensor:
    """Cross-entropy over [positive | queue negatives] logits with label 0;
    q, k [B, d], queue [d, N]; f32 products with TF32 off."""
    with no_tf32():
        l_pos = (q * k).sum(1, keepdim=True)
        l_neg = torch.matmul(q, queue)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return (torch.logsumexp(logits, dim=1) - logits[:, 0]).mean()


def queue_update(queue: torch.Tensor, ptr: torch.Tensor, keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write keys [B, d] into a copy of queue [d, N] at columns ptr .. ptr + B
    (dequeue-and-enqueue) -> (queue', (ptr + B) % N). ``ptr`` stays a device
    tensor, so nothing waits for the card. The copy keeps the old queue intact
    for the backward of a loss that used it."""
    b, n = keys.shape[0], queue.shape[1]
    if n % b:
        # the reference asserts this too (upstream_expert.py:166)
        raise ValueError(f"num_negatives={n} must be divisible by the batch {b} (MoCo queue simplicity assert)")
    cols = ptr + torch.arange(b, device=queue.device)
    return queue.index_copy(1, cols, keys.T.to(queue.dtype)), (ptr + b) % n
