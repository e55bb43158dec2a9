"""SpecAugment-style frequency and time masking (port of ``audiossl_tpu.ops.masking``).

torchaudio FrequencyMasking / TimeMasking as the MAST dataloader uses them
(extras/mast_new/mast/dataloader.py:186-199): one mask per axis and clip,
its width ~ U{0..param}, its start uniform over the positions where it fits,
filled with zeros. The draws are tensors (``MaskDraws``) made by
``sample_mask_draws`` from an explicit generator, so tests can hand the same
numbers to the JAX function.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MaskDraws(NamedTuple):
    """Per clip [B] int64: start and width of the frequency mask, then of the time mask."""

    f_start: torch.Tensor
    f_width: torch.Tensor
    t_start: torch.Tensor
    t_width: torch.Tensor


def _axis_draws(b: int, size: int, max_width: int, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    dev = generator.device
    width = torch.randint(0, max_width + 1, (b,), generator=generator, device=dev)
    hi = (size - width).clamp_min(0)  # start ~ U{0..hi}
    start = torch.minimum((torch.rand(b, generator=generator, device=dev) * (hi + 1)).long(), hi)
    return start, width


def sample_mask_draws(b: int, f: int, t: int, freq_param: int, time_param: int, generator: torch.Generator) -> MaskDraws:
    """The draws of one view's masks for B clips of [F, T], on the generator's device."""
    fs, fw = _axis_draws(b, f, freq_param, generator)
    ts, tw = _axis_draws(b, t, time_param, generator)
    return MaskDraws(fs, fw, ts, tw)


def _span(start: torch.Tensor, width: torch.Tensor, size: int) -> torch.Tensor:
    idx = torch.arange(size, device=start.device)
    return (idx >= start[:, None]) & (idx < (start + width)[:, None])  # [B, size]


def spec_mask(x: torch.Tensor, draws: MaskDraws, mask_value: float | None = 0.0) -> torch.Tensor:
    """Mask every clip of ``x`` [B, ..., F, T] along F, then along T.
    ``mask_value=None`` fills with the clip's mean (the SpecAugment paper /
    decar-v2), 0.0 matches torchaudio."""
    b, f, t = x.shape[0], x.shape[-2], x.shape[-1]
    lead = (b,) + (1,) * (x.dim() - 3)
    if mask_value is None:
        fill = x.reshape(b, -1).mean(1).view(*lead, 1, 1).to(x.dtype)
    else:
        fill = torch.tensor(mask_value, dtype=x.dtype, device=x.device)
    x = torch.where(_span(draws.f_start, draws.f_width, f).view(*lead, f, 1), fill, x)
    return torch.where(_span(draws.t_start, draws.t_width, t).view(*lead, 1, t), fill, x)
