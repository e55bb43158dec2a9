"""MViTv2, the MAST backbone (port of ``audiossl_tpu.models.mvit``).

Stage wiring, pooled attention with conv-pooled q / k / v, the decomposed
relative-position bias (cal_rel_pos_spatial), residual pooling, Mlp and
DropPath as in the JAX module and the reference spec it transcribes
(extras/mast_new/mast/mvit/models). Rectangular token grids, with separate
rel_pos_h / rel_pos_w tables per axis.

Layout: the JAX package's. The input is NCHW [B, C, H, W] with H the first
grid axis (time for MAST), tokens run row-major over (H, W), and rel_pos_h
indexes H. Parameter names are the reference's (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ``attn.pool_q`` + ``attn.norm_q``, ...), but the
reference runs MAST freq-major: ``models/convert.py:mvit_reference_layout``
transposes the conv kernels and swaps the rel-pos tables at that boundary
only, so the port's per-block outputs and the attention kernel's [Lq, Lk]
order compare directly with the JAX module's.

Precision, as in the JAX module: with a compute dtype (bf16) dense and conv
layers run in it on f32 parameters, while LayerNorm statistics and the
softmax stay f32; with ``compute_dtype=None`` everything is IEEE f32 (TF32
off).

Attention: every block runs ops/attention.py's ``fused_rel_attention``: the
Hopper kernels on a CUDA tensor, their plain versions on a CPU tensor.
``fused_attention`` is kept because the JAX configs carry it, and checked,
but the port does not act on it: the JAX package's "auto" gate (Lq * Lk >=
2^18, engaged only on the TPU) is a TPU v5e measurement; under tensor
parallelism, where JAX turns its kernel off, the port keeps its kernels on.

Pooling: each depthwise pooling conv runs as a grouped conv. ``pool_impl``
("conv" | "unrolled") is kept because the JAX configs carry it, and
checked, but not acted on: JAX's ``_UnrolledDepthwise`` works around its
SPMD partitioner's grouped-conv gradients under ``pretrain.tp``; the port
has no partitioner, and pools replicated q, k and v with replicated weights.

Tensor parallelism (parallel/tp_mvit.py): after ``shard_mvit_`` each
block's attention and Mlp hold their shards (``tp`` > 1) and run the
Megatron forward: qkv column-parallel and all-gathered, the pooling and
the attention replicated, ``attn.proj`` row-parallel on this rank's
columns of the attention output, then the column / row Mlp.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.ops.attention import fused_rel_attention
from audiossl_tpu_torch.parallel import tp as tpar

LN_EPS = 1e-6


def round_width(width, multiplier, min_width: int = 1, divisor: int = 1) -> int:
    if not multiplier:
        return int(width)
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


@dataclasses.dataclass(frozen=True)
class MViTConfig:
    embed_dim: int = 96
    depth: int = 16
    num_heads: int = 1
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    droppath_rate: float = 0.1
    patch_kernel: tuple[int, int] = (7, 7)
    patch_stride: tuple[int, int] = (4, 4)
    patch_padding: tuple[int, int] = (3, 3)
    dim_mul: tuple[tuple[int, float], ...] = ()
    head_mul: tuple[tuple[int, float], ...] = ()
    pool_q_stride: tuple[tuple[int, int, int], ...] = ()
    pool_kvq_kernel: tuple[int, int] = (3, 3)
    pool_kv_stride_adaptive: tuple[int, int] | None = (4, 4)
    cls_embed_on: bool = False
    use_abs_pos: bool = False
    rel_pos_spatial: bool = True
    residual_pooling: bool = True
    dim_mul_in_att: bool = True
    dropout_rate: float = 0.0
    compute_dtype: Any = None  # torch.bfloat16, or None for exact f32
    fused_attention: str = "auto"  # "auto" | "on" | "off": the JAX configs' key, not acted on
    pool_impl: str = "conv"  # "conv" | "unrolled": the JAX configs' key, not acted on

    @staticmethod
    def _variant(depth: int, droppath: float, stage_blocks: tuple[int, ...], kw) -> "MViTConfig":
        base = dict(
            depth=depth,
            droppath_rate=droppath,
            dim_mul=tuple((i, 2.0) for i in stage_blocks),
            head_mul=tuple((i, 2.0) for i in stage_blocks),
            pool_q_stride=tuple((i, 2, 2) if i in stage_blocks else (i, 1, 1) for i in range(depth)),
        )
        base.update(kw)
        return MViTConfig(**base)

    @staticmethod
    def tiny(**kw) -> "MViTConfig":
        return MViTConfig._variant(10, 0.1, (1, 3, 8), kw)

    @staticmethod
    def small(**kw) -> "MViTConfig":
        return MViTConfig._variant(16, 0.2, (1, 3, 14), kw)

    @staticmethod
    def base(**kw) -> "MViTConfig":
        return MViTConfig._variant(24, 0.3, (2, 5, 21), kw)


def prepare_block_schedule(cfg: MViTConfig):
    """Per-block (dim_mul, head_mul, kernel/stride q, kernel/stride kv): _prepare_mvit_configs."""
    depth = cfg.depth
    dim_mul = np.ones(depth + 1)
    head_mul = np.ones(depth + 1)
    for i, m in cfg.dim_mul:
        dim_mul[i] = m
    for i, m in cfg.head_mul:
        head_mul[i] = m
    pool_q = [() for _ in range(depth)]
    stride_q = [() for _ in range(depth)]
    for entry in cfg.pool_q_stride:
        i = entry[0]
        stride_q[i] = tuple(entry[1:])
        pool_q[i] = tuple(cfg.pool_kvq_kernel)
    pool_kv = [() for _ in range(depth)]
    stride_kv = [() for _ in range(depth)]
    if cfg.pool_kv_stride_adaptive is not None:
        _s = list(cfg.pool_kv_stride_adaptive)
        for i in range(depth):
            if len(stride_q[i]) > 0:
                _s = [max(_s[d] // stride_q[i][d], 1) for d in range(len(_s))]
            stride_kv[i] = tuple(_s)
            pool_kv[i] = tuple(cfg.pool_kvq_kernel)
    return dim_mul, head_mul, pool_q, pool_kv, stride_q, stride_kv


def _pool_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def _pools(kernel: tuple[int, ...], stride: tuple[int, ...]) -> bool:
    """The AttentionPool trigger condition of MultiScaleAttention."""
    return bool(len(kernel) and int(np.prod(stride)) * int(np.prod(kernel)) > 1)


def block_out_hw(hw: tuple[int, int], kernel_q: tuple[int, int], stride_q: tuple[int, int]) -> tuple[int, int]:
    """Token-grid size after a block's q pooling (padding = kernel // 2)."""
    if not _pools(kernel_q, stride_q):
        return hw
    return (
        _pool_out(hw[0], kernel_q[0], stride_q[0], kernel_q[0] // 2),
        _pool_out(hw[1], kernel_q[1], stride_q[1], kernel_q[1] // 2),
    )


def _rel_dist_index(q_size: int, k_size: int) -> np.ndarray:
    """Distance-index matrix into a rel-pos table (cal_rel_pos_spatial:61-76)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    dist = np.arange(q_size)[:, None] * q_ratio - np.arange(k_size)[None, :] * k_ratio
    dist += (k_size - 1) * k_ratio
    return dist.astype(np.int64)


def _bias(m: nn.Linear, dt: torch.dtype) -> torch.Tensor | None:
    return m.bias.to(dt) if m.bias is not None else None


def _linear(x: torch.Tensor, m: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """A dense layer in the compute dtype on f32 parameters."""
    return F.linear(x.to(dt), m.weight.to(dt), _bias(m, dt))


def _layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics and an f32 result."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps)


def drop_path(x: torch.Tensor, rate: float, keep_draw: torch.Tensor | None) -> torch.Tensor:
    """Per-sample stochastic depth from a U(0, 1) draw [B] (None: identity)."""
    if keep_draw is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.floor(keep + keep_draw).view(-1, *(1,) * (x.dim() - 1)).to(x.dtype)
    return x / keep * mask


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, input_hw: tuple[int, int],
                 kernel_q, kernel_kv, stride_q, stride_kv, qkv_bias: bool, rel_pos_spatial: bool,
                 residual_pooling: bool):
        super().__init__()
        self.tp = 1
        self.dim_out, self.num_heads = dim_out, num_heads
        self.head_dim = dim_out // num_heads
        self.scale = self.head_dim**-0.5
        self.input_hw = tuple(input_hw)
        self.rel_pos_spatial, self.residual_pooling = rel_pos_spatial, residual_pooling
        self.qkv = nn.Linear(dim, dim_out * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim_out, dim_out)
        c = self.head_dim
        self.q_hw = self.k_hw = self.input_hw
        for name, kernel, stride in (("q", kernel_q, stride_q), ("k", kernel_kv, stride_kv), ("v", kernel_kv, stride_kv)):
            if _pools(kernel, stride):
                pad = tuple(k // 2 for k in kernel)
                self.add_module(f"pool_{name}", nn.Conv2d(c, c, tuple(kernel), tuple(stride), pad, groups=c, bias=False))
                self.add_module(f"norm_{name}", nn.LayerNorm(c, eps=LN_EPS))
                out_hw = tuple(_pool_out(self.input_hw[i], kernel[i], stride[i], pad[i]) for i in range(2))
                if name == "q":
                    self.q_hw = out_hw
                elif name == "k":
                    self.k_hw = out_hw
        if rel_pos_spatial:
            (qh, qw), (kh, kw) = self.q_hw, self.k_hw
            self.rel_pos_h = nn.Parameter(torch.empty(2 * max(qh, kh) - 1, c))
            self.rel_pos_w = nn.Parameter(torch.empty(2 * max(qw, kw) - 1, c))
            for table in (self.rel_pos_h, self.rel_pos_w):  # flax's truncated_normal(0.02)
                nn.init.trunc_normal_(table, 0.0, 0.02, -0.04, 0.04)
            self._dist = (_rel_dist_index(qh, kh), _rel_dist_index(qw, kw))
        self._dist_on: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def _pool(self, name: str, t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """[B, heads, L, C] -> pooled [B, heads, L', C]: a depthwise conv over
        each head's grid, then LayerNorm in f32."""
        if f"pool_{name}" not in self._modules:
            return t
        conv, norm = getattr(self, f"pool_{name}"), getattr(self, f"norm_{name}")
        b, h, _, c = t.shape
        grid = t.reshape(b * h, *self.input_hw, c).permute(0, 3, 1, 2)
        out = F.conv2d(grid.to(dt), conv.weight.to(dt), None, conv.stride, conv.padding, groups=c)
        out = out.flatten(2).transpose(1, 2).reshape(b, h, -1, c)
        return _layer_norm(out, norm).to(dt)

    def _dist_index(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        if device not in self._dist_on:
            self._dist_on[device] = tuple(torch.from_numpy(d).to(device) for d in self._dist)
        return self._dist_on[device]

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        b, n, _ = x.shape
        heads, c = self.num_heads, self.head_dim
        if tpar.sharded(self.tp):  # column-parallel, then every rank holds all of q, k and v
            qkv = tpar.gather_from_model(tpar.column_parallel(x, self.qkv.weight.to(dt), _bias(self.qkv, dt)))
        else:
            qkv = _linear(x, self.qkv, dt)
        qkv = qkv.reshape(b, n, 3, heads, c).permute(2, 0, 3, 1, 4)
        q, k, v = (self._pool(name, t, dt) for name, t in zip("qkv", qkv))
        (qh, qw), (kh, kw) = self.q_hw, self.k_hw
        lq, lk = q.shape[2], k.shape[2]
        bias = grid = None
        if self.rel_pos_spatial:
            ih, iw = self._dist_index(x.device)
            r_q = q.reshape(b, heads, qh, qw, c)
            bias = torch.cat([
                torch.einsum("byhwc,hkc->byhwk", r_q, self.rel_pos_h[ih].to(dt)).reshape(b * heads, lq, kh),
                torch.einsum("byhwc,wkc->byhwk", r_q, self.rel_pos_w[iw].to(dt)).reshape(b * heads, lq, kw),
            ], dim=-1)  # [B * H, Lq, kh + kw]
            grid = (kh, kw)
        out = fused_rel_attention(
            q.reshape(b * heads, lq, c), k.reshape(b * heads, lk, c), v.reshape(b * heads, lk, c), bias, grid, self.scale,
        ).reshape(b, heads, lq, c)
        if self.residual_pooling:
            out = out + q
        out = out.transpose(1, 2).reshape(b, -1, self.dim_out)
        if tpar.sharded(self.tp):  # row-parallel on this rank's columns of the output
            return tpar.row_parallel(tpar.scatter_to_model(out), self.proj.weight.to(dt), self.proj.bias.to(dt))
        return _linear(out, self.proj, dt)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.tp = 1

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        if tpar.sharded(self.tp):  # column -> GELU -> row
            return tpar.tp_mlp(x, self.fc1.weight.to(dt), self.fc2.weight.to(dt), self.fc1.bias.to(dt),
                               self.fc2.bias.to(dt), F.gelu)
        return _linear(F.gelu(_linear(x, self.fc1, dt)), self.fc2, dt)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, input_hw: tuple[int, int], mlp_ratio: float,
                 qkv_bias: bool, droppath: float, kernel_q, kernel_kv, stride_q, stride_kv,
                 rel_pos_spatial: bool, residual_pooling: bool, dim_mul_in_att: bool):
        super().__init__()
        self.dim, self.dim_out, self.dim_mul_in_att = dim, dim_out, dim_mul_in_att
        self.input_hw, self.stride_q, self.droppath = tuple(input_hw), tuple(stride_q), droppath
        att_dim = dim_out if dim_mul_in_att else dim
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiScaleAttention(dim, att_dim, num_heads, input_hw, kernel_q, kernel_kv, stride_q, stride_kv,
                                        qkv_bias, rel_pos_spatial, residual_pooling)
        self.norm2 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.mlp = Mlp(att_dim, int(att_dim * mlp_ratio), dim_out)
        if dim != dim_out:
            self.proj = nn.Linear(dim if dim_mul_in_att else att_dim, dim_out)

    def forward(self, x: torch.Tensor, dt: torch.dtype, keep1: torch.Tensor | None = None,
                keep2: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, N, dim] -> [B, N', dim_out]; keep1 / keep2 are the drop-path
        draws of the attention and the Mlp branch (None: no drop path)."""
        x_norm = _layer_norm(x, self.norm1).to(dt)
        x_block = self.attn(x_norm, dt)
        if self.dim_mul_in_att and self.dim != self.dim_out:
            x = _linear(x_norm, self.proj, dt)
        if len(self.stride_q) and int(np.prod(self.stride_q)) > 1:  # skip-path max pool, kernel stride + 1
            ks = tuple(s + 1 if s > 1 else s for s in self.stride_q)
            b, _, c = x.shape
            grid = x.reshape(b, *self.input_hw, c).permute(0, 3, 1, 2)
            grid = F.max_pool2d(grid, ks, self.stride_q, tuple(k // 2 for k in ks))
            x = grid.flatten(2).transpose(1, 2)
        x = x + drop_path(x_block, self.droppath, keep1)
        x_norm2 = _layer_norm(x, self.norm2).to(dt)
        x_mlp = self.mlp(x_norm2, dt)
        if not self.dim_mul_in_att and self.dim != self.dim_out:
            x = _linear(x_norm2, self.proj, dt)
        return x + drop_path(x_mlp, self.droppath, keep2)


class MViT(nn.Module):
    """Token trunk: [B, C_in, H, W] -> [B, N_final, C_final] (callers pool)."""

    def __init__(self, cfg: MViTConfig, input_hw: tuple[int, int], in_chans: int = 1, final_norm: bool = True,
                 remat: bool = False):
        super().__init__()
        if cfg.cls_embed_on or cfg.use_abs_pos or cfg.dropout_rate > 0.0:
            raise NotImplementedError("cls_embed_on, use_abs_pos and dropout_rate > 0 are not ported (MAST uses none)")
        if cfg.fused_attention not in ("auto", "on", "off"):
            raise ValueError(f"fused_attention must be auto|on|off, got {cfg.fused_attention!r}")
        if cfg.pool_impl not in ("conv", "unrolled"):
            raise ValueError(f"pool_impl must be conv|unrolled, got {cfg.pool_impl!r}")
        self.cfg, self.remat = cfg, remat
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(in_chans, cfg.embed_dim, cfg.patch_kernel, cfg.patch_stride, cfg.patch_padding)
        hw = tuple(_pool_out(input_hw[i], cfg.patch_kernel[i], cfg.patch_stride[i], cfg.patch_padding[i]) for i in range(2))
        self.grid_hw = hw
        dim_mul, head_mul, pool_q, pool_kv, stride_q, stride_kv = prepare_block_schedule(cfg)
        dpr = np.linspace(0, cfg.droppath_rate, cfg.depth)
        embed_dim, num_heads = cfg.embed_dim, cfg.num_heads
        blocks = []
        for i in range(cfg.depth):
            num_heads = round_width(num_heads, head_mul[i])
            if cfg.dim_mul_in_att:
                dim_out = round_width(embed_dim, dim_mul[i], divisor=round_width(num_heads, head_mul[i]))
            else:
                dim_out = round_width(embed_dim, dim_mul[i + 1], divisor=round_width(num_heads, head_mul[i + 1]))
            blocks.append(MultiScaleBlock(
                embed_dim, dim_out, num_heads, hw, cfg.mlp_ratio, cfg.qkv_bias, float(dpr[i]), pool_q[i],
                pool_kv[i], stride_q[i], stride_kv[i], cfg.rel_pos_spatial, cfg.residual_pooling,
                cfg.dim_mul_in_att,
            ))
            hw = block_out_hw(hw, pool_q[i], stride_q[i])
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)
        self.embed_dim = embed_dim
        self.final_norm = final_norm
        if final_norm:
            self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, *, draws=None) -> torch.Tensor:
        """In training mode with drop path, ``generator`` gives its draws
        (two per block, drawn before the block runs, so a rematerialised
        block sees the same masks); ``draws``, an iterator of U(0, 1) [B]
        tensors in that order, gives them instead."""
        cfg = self.cfg
        dt = cfg.compute_dtype or x.dtype
        drops = self.training and cfg.droppath_rate > 0.0
        if drops and generator is None and draws is None:
            raise ValueError("MViT in training mode with drop path needs a generator for its masks")
        with no_tf32() if dt == torch.float32 else contextlib.nullcontext():
            proj = self.patch_embed.proj
            x = F.conv2d(x.to(dt), proj.weight.to(dt), proj.bias.to(dt), proj.stride, proj.padding)
            x = x.flatten(2).transpose(1, 2)  # [B, h * w, E], row-major over (h, w)
            b = x.shape[0]
            for blk in self.blocks:
                keep = [None, None]
                if drops and blk.droppath > 0.0:
                    keep = [next(draws).to(x.device) if draws is not None else
                            torch.rand(b, generator=generator, device=generator.device).to(x.device) for _ in range(2)]
                if self.remat and self.training:
                    x = checkpoint(blk, x, dt, *keep, use_reentrant=False)
                else:
                    x = blk(x, dt, *keep)
            if self.final_norm:
                x = _layer_norm(x, self.norm)
        return x
