"""MAST: MViTv2 over a log-fbank, as a plain function of its weights.

MViTv2 (Li et al., arXiv:2112.01526) with MAST's patch stem (Zhu and Omar,
arXiv:2211.01515): 16 x 16 patches at stride 10 over the time-major
spectrogram, pooled attention with conv-pooled q, k and v (each pooled
tensor LayerNorm'd), the decomposed relative-position bias, residual
pooling, a max-pooled skip path where q is strided, per-sample drop path
from U(0, 1) draws, no final norm, and the mean over tokens. The token grid
runs time-major (H = time), as the port lays it out; the published model
runs frequency-major, which is the same function under a transpose of the
grid, the kernels and the rel-pos tables.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.models import drop_path, linear, softmax_attention, sub
from portbench.reference.precision import F32, Precision

LN_EPS = 1e-6


# ---------------------------------------------------------------- the block schedule


def round_width(width, multiplier, min_width: int = 1, divisor: int = 1) -> int:
    if not multiplier:
        return int(width)
    width *= multiplier
    min_width = min_width or divisor
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def _out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def mvit_blocks(arch: dict, input_hw: tuple[int, int]) -> list[dict]:
    """The per-block shapes of an MViTv2 ``arch`` (embed_dim, depth,
    num_heads, stage_blocks, droppath_rate, patch, stride) over an input of
    ``input_hw`` (time, freq): dims, heads, grids, pooling kernels and strides."""
    depth, stages = int(arch["depth"]), tuple(arch["stage_blocks"])
    hw = tuple(_out(input_hw[i], arch["patch"], arch["stride"], 0) for i in range(2))
    dim, heads = int(arch["embed_dim"]), int(arch["num_heads"])
    kv_stride = list(arch.get("pool_kv_stride_adaptive", (4, 4)))
    dpr = np.linspace(0, float(arch["droppath_rate"]), depth)
    blocks = []
    for i in range(depth):
        stage = i in stages
        heads = round_width(heads, 2.0 if stage else 1.0)
        dim_out = round_width(dim, 2.0 if stage else 1.0, divisor=round_width(heads, 2.0 if stage else 1.0))
        sq = (2, 2) if stage else (1, 1)
        if stage:
            kv_stride = [max(s // q, 1) for s, q in zip(kv_stride, sq)]
        q_hw = tuple(_out(hw[d], 3, sq[d], 1) for d in range(2))
        k_hw = tuple(_out(hw[d], 3, kv_stride[d], 1) for d in range(2))
        blocks.append(dict(dim=dim, dim_out=dim_out, heads=heads, hw=hw, q_hw=q_hw, k_hw=k_hw, stride_q=sq,
                           stride_kv=tuple(kv_stride), droppath=float(dpr[i])))
        hw, dim = q_hw, dim_out
    return blocks


def _rel_index(q: int, k: int, device) -> torch.Tensor:
    qr, kr = max(k / q, 1.0), max(q / k, 1.0)
    d = np.arange(q)[:, None] * qr - np.arange(k)[None, :] * kr + (k - 1) * kr
    return torch.from_numpy(d.astype(np.int64)).to(device)


# ---------------------------------------------------------------- the trunk


def _pool(t, p: dict, name: str, hw, stride, prec: Precision):
    """[B, H, L, C] -> [B, H, L', C]: depthwise 3 x 3 conv at ``stride`` (pad 1), then LayerNorm."""
    b, h, _, c = t.shape
    grid = t.reshape(b * h, *hw, c).permute(0, 3, 1, 2)
    out = F.conv2d(prec.g(grid), prec.g(p[f"pool_{name}.weight"]), None, stride, 1, groups=c)
    out = out.flatten(2).transpose(1, 2).reshape(b, h, -1, c)
    return prec.layer_norm(out, p[f"norm_{name}.weight"], p[f"norm_{name}.bias"], LN_EPS)


def attention(x, p: dict, blk: dict, prec: Precision):
    b, n, _ = x.shape
    heads, dim_out = blk["heads"], blk["dim_out"]
    c = dim_out // heads
    qkv = linear(x, p["qkv.weight"], p["qkv.bias"], prec).reshape(b, n, 3, heads, c).permute(2, 0, 3, 1, 4)
    q = _pool(qkv[0], p, "q", blk["hw"], blk["stride_q"], prec)
    k = _pool(qkv[1], p, "k", blk["hw"], blk["stride_kv"], prec)
    v = _pool(qkv[2], p, "v", blk["hw"], blk["stride_kv"], prec)
    (qh, qw), (kh, kw) = blk["q_hw"], blk["k_hw"]
    rh = p["rel_pos_h"][_rel_index(qh, kh, x.device)]  # [qh, kh, c]
    rw = p["rel_pos_w"][_rel_index(qw, kw, x.device)]  # [qw, kw, c]
    r_q = prec.g(q).reshape(b, heads, qh, qw, c)
    bias = (torch.einsum("byhwc,hkc->byhwk", r_q, prec.g(rh))[..., :, None]
            + torch.einsum("byhwc,wkc->byhwk", r_q, prec.g(rw))[..., None, :])  # [B, H, qh, qw, kh, kw]
    lq, lk = qh * qw, kh * kw
    out = softmax_attention(q.reshape(b * heads, lq, c), k.reshape(b * heads, lk, c), v.reshape(b * heads, lk, c),
                            c ** -0.5, prec, bias.reshape(b * heads, lq, lk)).reshape(b, heads, lq, c)
    out = (out + q).transpose(1, 2).reshape(b, lq, dim_out)
    return linear(out, p["proj.weight"], p["proj.bias"], prec)


def block(x, p: dict, blk: dict, prec: Precision, u1=None, u2=None):
    x_norm = prec.layer_norm(x, p["norm1.weight"], p["norm1.bias"], LN_EPS)
    x_block = attention(x_norm, sub(p, "attn."), blk, prec)
    if blk["dim"] != blk["dim_out"]:
        x = linear(x_norm, p["proj.weight"], p["proj.bias"], prec)
    if blk["stride_q"] != (1, 1):  # the skip path's max pool, kernel stride + 1
        b, _, c = x.shape
        ks = tuple(s + 1 if s > 1 else s for s in blk["stride_q"])
        grid = x.reshape(b, *blk["hw"], c).permute(0, 3, 1, 2)
        x = F.max_pool2d(grid, ks, blk["stride_q"], tuple(k // 2 for k in ks)).flatten(2).transpose(1, 2)
    x = x + drop_path(x_block, blk["droppath"], u1)
    h = prec.layer_norm(x, p["norm2.weight"], p["norm2.bias"], LN_EPS)
    h = linear(F.gelu(linear(h, p["mlp.fc1.weight"], p["mlp.fc1.bias"], prec)), p["mlp.fc2.weight"],
               p["mlp.fc2.bias"], prec)
    return x + drop_path(h, blk["droppath"], u2)


def forward(x, p: dict, arch: dict, prec: Precision = F32, draws=None):
    """[B, 1, F, T] -> [B, D] token mean. ``draws``: the drop-path U(0, 1)
    [B] tensors, two per block whose rate is above 0, in block order (None: eval)."""
    x = x.transpose(-1, -2)  # [B, 1, T, F]: time is the grid's first axis
    blocks = mvit_blocks(arch, tuple(x.shape[-2:]))
    s = arch["stride"]
    x = F.conv2d(prec.g(x), prec.g(p["patch_embed.proj.weight"]), p["patch_embed.proj.bias"], (s, s))
    x = x.flatten(2).transpose(1, 2)
    draws = iter(draws) if draws is not None else None
    for i, blk in enumerate(blocks):
        u = (next(draws), next(draws)) if draws is not None and blk["droppath"] > 0 else (None, None)
        x = block(x, sub(p, f"blocks.{i}."), blk, prec, *u)
    return x.mean(1)


def drop_path_blocks(arch: dict) -> int:
    """Blocks that take drop-path draws (the rate rises from 0 at block 0)."""
    return int(arch["depth"]) - 1 if float(arch["droppath_rate"]) > 0 else 0
