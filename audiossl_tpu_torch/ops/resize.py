"""Bicubic crop-resize as two matrix products (port of ``audiossl_tpu.ops.resize``).

The reference's RandomResizeCrop (src/augmentations/augmentations.py:14-61)
pads the spectrogram onto a virtual canvas, takes a random crop and resizes
it with ``F.interpolate(mode='bicubic', align_corners=True)``. Here the crop
and resize compose into interpolation-weight matrices, so every clip of a
batch takes its own box in one batched product:

    out[F, T] = W_f(i, h) @ canvas[cH, cW] @ W_t(j, w)ᵀ

Rows of W carry the 4-tap cubic convolution kernel (a = -0.75, as
``F.interpolate``) with the border replicated inside the crop. The boxes are
inputs, drawn by ``sample_crop_boxes`` from an explicit generator, so tests
can hand both frameworks the same boxes. Products run in f32 with TF32 off.
"""
from __future__ import annotations

import torch

from audiossl_tpu_torch import no_tf32


def _cubic_kernel(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Keys' cubic convolution kernel at |t|."""
    t = t.abs()
    near = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    far = (((t - 5.0) * t + 8.0) * t - 4.0) * a
    return torch.where(t <= 1.0, near, torch.where(t < 2.0, far, torch.zeros_like(t)))


def crop_resize_matrix(out_size: int, crop_start: torch.Tensor, crop_size: torch.Tensor, canvas_size: int) -> torch.Tensor:
    """[..., out_size, canvas_size] bicubic (align_corners=True) weights that
    resize ``canvas[crop_start : crop_start + crop_size]`` to ``out_size``
    samples; ``crop_start`` and ``crop_size`` are int tensors of shape [...]."""
    dev = crop_size.device
    size = crop_size.float()[..., None]  # [..., 1]
    u = torch.arange(out_size, dtype=torch.float32, device=dev)
    scale = (size - 1.0) / max(out_size - 1, 1) if out_size > 1 else torch.zeros_like(size)
    src = u * scale  # [..., out]
    f = torch.floor(src)
    t = src - f
    offsets = torch.arange(-1, 3, dtype=torch.float32, device=dev)
    w = _cubic_kernel(t[..., None] - offsets)  # [..., out, 4]
    # border replication inside the crop, then shift into canvas coordinates
    tap = torch.minimum((f[..., None] + offsets).clamp_min(0.0), size[..., None] - 1.0).long()
    tap = tap + crop_start.long()[..., None, None]
    onehot = (tap[..., None] == torch.arange(canvas_size, device=dev)).float()  # [..., out, 4, canvas]
    return (w[..., None] * onehot).sum(-2)


def crop_resize_2d(canvas: torch.Tensor, boxes: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """canvas [B, C, cH, cW], boxes [B, 4] int (i, j, h, w) -> [B, C, *out_hw]:
    each clip's crop resized bicubically."""
    i, j, h, w = boxes.unbind(-1)
    wf = crop_resize_matrix(out_hw[0], i, h, canvas.shape[-2])  # [B, F, cH]
    wt = crop_resize_matrix(out_hw[1], j, w, canvas.shape[-1])  # [B, T, cW]
    with no_tf32():
        return wf[:, None] @ canvas.float() @ wt[:, None].transpose(-1, -2)


def canvas_size(f_in: int, t_in: int, virtual_crop_scale: tuple[float, float]) -> tuple[int, int]:
    return int(f_in * virtual_crop_scale[0]), int(t_in * virtual_crop_scale[1])


def sample_crop_boxes(
    b: int, f_in: int, t_in: int, generator: torch.Generator,
    virtual_crop_scale: tuple[float, float] = (1.0, 1.5),
    freq_scale: tuple[float, float] = (0.6, 1.5),
    time_scale: tuple[float, float] = (0.6, 1.5),
) -> torch.Tensor:
    """[b, 4] int64 boxes (i, j, h, w) on ``generator``'s device, drawn as
    the JAX package's ``random_resize_crop`` draws them: h = floor(U(freq
    scale) F) and w = floor(U(time scale) T), clipped to [1, canvas], then a
    uniform top-left corner inside the canvas."""
    ch, cw = canvas_size(f_in, t_in, virtual_crop_scale)
    u = torch.rand((b, 4), generator=generator, device=generator.device)
    h = torch.floor((freq_scale[0] + u[:, 0] * (freq_scale[1] - freq_scale[0])) * f_in).clamp(1, ch)
    w = torch.floor((time_scale[0] + u[:, 1] * (time_scale[1] - time_scale[0])) * t_in).clamp(1, cw)
    i = torch.minimum(torch.floor(u[:, 2] * (ch - h + 1)), ch - h)
    j = torch.minimum(torch.floor(u[:, 3] * (cw - w + 1)), cw - w)
    return torch.stack([i, j, h, w], dim=1).long()


def random_resize_crop(
    lms: torch.Tensor, boxes: torch.Tensor, virtual_crop_scale: tuple[float, float] = (1.0, 1.5)
) -> torch.Tensor:
    """RandomResizeCrop of a batch ``[B, C, F, T]`` with the given ``boxes``:
    the clip is centred on a zero canvas, then each box is cropped and
    resized back to [F, T]."""
    b, c, f_in, t_in = lms.shape
    ch, cw = canvas_size(f_in, t_in, virtual_crop_scale)
    y, x = (ch - f_in) // 2, (cw - t_in) // 2
    canvas = lms.new_zeros((b, c, ch, cw))
    canvas[:, :, y : y + f_in, x : x + t_in] = lms
    return crop_resize_2d(canvas, boxes, (f_in, t_in))
