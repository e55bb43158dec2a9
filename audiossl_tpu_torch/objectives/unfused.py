"""UnFuSeD's losses (port of ``audiossl_tpu.objectives.unfused``): so far
only ``cross_entropy``, which the downstream probe uses. The objective
itself comes with ROADMAP.md Queue 1, item 6."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[label] over the batch, in f32."""
    logits = logits.float()
    return (torch.logsumexp(logits, dim=1) - logits.gather(1, labels[:, None].long())[:, 0]).mean()
