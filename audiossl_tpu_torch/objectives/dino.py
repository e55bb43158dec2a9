"""DINO-style centring loss (port of ``audiossl_tpu.objectives.dino``;
reference: extras/decar-v2/dino_loss.py:7-65).

The reference keeps this beside DECAR as an unused variant; nothing in the
JAX package calls it either. Teacher outputs are centred by an EMA centre,
sharpened by a warm-up-scheduled temperature, and the student is trained by
CE against them. Across processes the centre's batch mean is the group's
(the JAX package's psum over ``axis_name``, parallel/dist.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from audiossl_tpu_torch.parallel import dist


class DinoState(NamedTuple):
    center: torch.Tensor  # [1, out_dim]


def dino_init(out_dim: int) -> DinoState:
    return DinoState(center=torch.zeros((1, out_dim), dtype=torch.float32))


def teacher_temp_schedule(warmup_teacher_temp: float, teacher_temp: float, warmup_epochs: int,
                          nepochs: int) -> np.ndarray:
    return np.concatenate([np.linspace(warmup_teacher_temp, teacher_temp, warmup_epochs),
                           np.full(max(nepochs - warmup_epochs, 0), teacher_temp)])


def dino_loss(student_out: torch.Tensor, teacher_out: torch.Tensor, state: DinoState, teacher_temp: float,
              student_temp: float = 0.1, center_momentum: float = 0.9,
              simplified: bool = True) -> tuple[torch.Tensor, DinoState]:
    """-> (loss, new state). ``simplified=True`` is the path the reference
    returns (dino_loss.py:49-53): mean over rows of sum(teacher *
    log_softmax(student)), raw logits, positive sign, no centring.
    ``simplified=False`` is the published DINO form for one (student,
    teacher) pair (dino_loss.py:37-46 + 55-65). The centre advances either
    way: centre * m + batch mean * (1 - m)."""
    teacher_out = teacher_out.detach()
    if simplified:
        loss = (teacher_out * torch.log_softmax(student_out, dim=-1)).sum(dim=-1).mean()
    else:
        t = torch.softmax((teacher_out - state.center) / teacher_temp, dim=-1)
        loss = (-t * torch.log_softmax(student_out / student_temp, dim=-1)).sum(dim=-1).mean()
    batch_center = dist.all_reduce_sum(teacher_out.sum(dim=0, keepdim=True)) / (teacher_out.shape[0] * dist.dp_world())
    return loss, DinoState(center=state.center * center_momentum + batch_center * (1.0 - center_momentum))
