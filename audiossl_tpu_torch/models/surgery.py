"""Checkpoint surgery for the transformer encoders (port of
``audiossl_tpu.models.surgery``): positional-embedding grid resize,
relative-position table resize, and patch-projection channel folding, so
that an encoder pretrained at one input shape loads into a model built for
another.

The rules are JAX's (and the reference transplant's, src/encoder/mast.py:
100-173): the grid positional embedding is centre-cut along an axis that
shrinks and bilinearly interpolated along one that grows, the second grid
axis first; a rel_pos_h / rel_pos_w table is resized linearly along its
distance axis by explicit half-pixel sampling (no antialiasing); a patch
conv kernel that differs only in its input channels has them summed (the
torch weight's dim 1, the RGB -> mono DeiT transplant).

The surgery runs on flat state_dicts in the port's own time-major layout,
keyed by name suffix: ``pos_embed``, ``*.rel_pos_h`` / ``*.rel_pos_w`` and a
4-d conv weight. Checkpoints (``encoder/<step>.pt``) hold the reference's
freq-major layout, so ``load_pretrained_encoder`` turns the source into the
port's layout first (``models.convert.port_layout``), as JAX works on its
own time-major trees.
"""
from __future__ import annotations

import os
from typing import Mapping

import torch

from audiossl_tpu_torch.models.convert import port_layout


def token_grid(input_hw: tuple[int, int], patch: int = 16, strides: tuple[int, int] = (10, 10)) -> tuple[int, int]:
    """Patch grid (h, w) of a VALID (patch x patch) conv over ``input_hw``."""
    return (input_hw[0] - patch) // strides[0] + 1, (input_hw[1] - patch) // strides[1] + 1


def _linear_resize(t: torch.Tensor, new: int, dim: int) -> torch.Tensor:
    """Linear interpolation along ``dim`` at half-pixel centres, the source
    position clamped to the table (torch's ``align_corners=False`` rule
    without antialiasing, and jax.image.resize's when it grows); positions
    in f32, as JAX computes them."""
    old = t.shape[dim]
    pos = ((torch.arange(new, dtype=torch.float32) + 0.5) * (old / new) - 0.5).clamp(0.0, old - 1)
    lo = pos.floor().long()
    hi = (lo + 1).clamp_max(old - 1)
    shape = [1] * t.dim()
    shape[dim] = new
    w = (pos - lo).to(t.dtype).view(shape)
    return t.index_select(dim, lo) * (1.0 - w) + t.index_select(dim, hi) * w


def _cut_or_resize(grid: torch.Tensor, new: int, dim: int) -> torch.Tensor:
    """Centre-cut if the axis shrinks, bilinear if it grows."""
    old = grid.shape[dim]
    if new <= old:
        return grid.narrow(dim, old // 2 - new // 2, new)
    return _linear_resize(grid, new, dim)


def resize_grid_pos_embed(pos: torch.Tensor, src_grid: tuple[int, int], dst_grid: tuple[int, int],
                          prefix_tokens: int = 0) -> torch.Tensor:
    """[1, prefix + h0 * w0, D] -> [1, prefix + h1 * w1, D]: the prefix
    (cls / dist) tokens kept, the grid adapted along its second axis, then
    its first."""
    (h0, w0), (h1, w1) = src_grid, dst_grid
    if pos.shape[1] != prefix_tokens + h0 * w0:
        raise ValueError(f"pos_embed has {pos.shape[1]} tokens, expected {prefix_tokens} + {h0}*{w0}")
    d = pos.shape[-1]
    grid = pos[:, prefix_tokens:].reshape(1, h0, w0, d)
    grid = _cut_or_resize(grid, w1, 2)
    grid = _cut_or_resize(grid, h1, 1).reshape(1, h1 * w1, d)
    return torch.cat([pos[:, :prefix_tokens], grid], dim=1) if prefix_tokens else grid


def resize_rel_pos(table: torch.Tensor, new_len: int) -> torch.Tensor:
    """[L0, D] -> [L1, D] along the distance axis (identity at equal lengths)."""
    return table if table.shape[0] == new_len else _linear_resize(table, new_len, 0)


def fold_patch_proj_channels(weight: torch.Tensor) -> torch.Tensor:
    """[O, I, kh, kw] -> [O, 1, kh, kw]: the input channels summed."""
    return weight.sum(dim=1, keepdim=True)


def transplant_state_dict(
    target: Mapping[str, torch.Tensor],
    source: Mapping[str, torch.Tensor],
    src_grid: tuple[int, int] | None = None,
    dst_grid: tuple[int, int] | None = None,
    prefix_tokens: int = 0,
    stats: dict | None = None,
) -> dict[str, torch.Tensor]:
    """``source`` adapted onto ``target``'s keys and shapes (JAX's
    ``transplant_variables``): equal shapes copy; ``pos_embed`` takes the grid
    surgery (given both grids); rel-pos tables resize; a conv weight whose
    only mismatch is its input channels folds them. Irreconcilable
    mismatches ("kept_fresh") and target keys the source lacks ("missing")
    keep the target's values; source keys the target lacks are dropped.
    ``stats`` gets the counts {"copied", "adapted", "kept_fresh",
    "missing"}."""
    counts = {"copied": 0, "adapted": 0, "kept_fresh": 0, "missing": sum(k not in source for k in target)}
    out = dict(target)
    for key, src in source.items():
        if key not in out:
            continue
        tgt = out[key]
        name = key.rsplit(".", 1)[-1]
        if tgt.shape == src.shape:
            counts["copied"] += 1
            out[key] = src
            continue
        if name == "pos_embed" and src_grid and dst_grid:
            new = resize_grid_pos_embed(src, src_grid, dst_grid, prefix_tokens)
        elif name.startswith("rel_pos") and src.dim() == tgt.dim() == 2 and src.shape[1] == tgt.shape[1]:
            new = resize_rel_pos(src, tgt.shape[0])
        elif (src.dim() == tgt.dim() == 4 and tgt.shape[1] == 1 and src.shape[1] > 1
              and src.shape[:1] + src.shape[2:] == tgt.shape[:1] + tgt.shape[2:]):
            new = fold_patch_proj_channels(src)
        else:
            counts["kept_fresh"] += 1
            continue
        counts["adapted"] += 1
        out[key] = new.to(tgt.dtype)
    if stats is not None:
        stats.update(counts)
    return out


def newest_encoder(ckpt_dir: str) -> str:
    """The path of the newest ``encoder/<step>.pt`` of a checkpoint directory."""
    enc_dir = os.path.join(ckpt_dir, "encoder")
    steps = sorted(int(n[:-3]) for n in os.listdir(enc_dir) if n.endswith(".pt") and n[:-3].isdigit()) \
        if os.path.isdir(enc_dir) else []
    if not steps:
        raise FileNotFoundError(f"no encoder/<step>.pt under {ckpt_dir}")
    return os.path.join(enc_dir, f"{steps[-1]}.pt")


def load_pretrained_encoder(
    ckpt_dir: str,
    target: Mapping[str, torch.Tensor],
    encoder_type: str,
    src_input_hw: tuple[int, int],
    dst_input_hw: tuple[int, int],
    prefix_tokens: int = 0,
    stats: dict | None = None,
) -> dict[str, torch.Tensor]:
    """The checkpoint's newest encoder adapted onto ``target``, a model's
    ``state_dict()`` built for ``dst_input_hw``. ``src_input_hw`` /
    ``dst_input_hw`` are the (H, W) the patch conv sees: (input_tdim,
    input_fdim) for MAST and AST. Raises when nothing transfers: the
    checkpoint is not this architecture. ``stats`` gets the transplant's
    counts."""
    path = newest_encoder(ckpt_dir)
    src_grid, dst_grid = token_grid(src_input_hw), token_grid(dst_input_hw)
    source = port_layout(torch.load(path, map_location="cpu", weights_only=True), encoder_type, src_grid[::-1])
    stats = {} if stats is None else stats
    out = transplant_state_dict(target, source, src_grid, dst_grid, prefix_tokens, stats)
    if stats["copied"] + stats["adapted"] == 0:
        raise ValueError(
            f"encoder transplant from {path} transferred nothing (0 matching tensors, {stats['kept_fresh']} "
            "mismatches): the checkpoint does not correspond to this encoder architecture")
    return out
