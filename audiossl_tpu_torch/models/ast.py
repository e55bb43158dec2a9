"""AST: the plain-ViT (DeiT) Audio Spectrogram Transformer (port of
``audiossl_tpu.models.ast``).

A 1-channel 16x16 patchify with overlapping (tstride, fstride) strides, cls
and distillation tokens, a learned positional embedding over the patch grid,
ViT blocks, a final LayerNorm, and the mean of the cls and dist tokens as
the output. Variants tiny / small / base are 192 / 384 / 768 wide, depth 12,
3 / 6 / 12 heads. AST-base at its published 128 x 1024 input has a 12 x 101
patch grid: 1214 tokens with 64-wide heads.

Layout: the JAX package's. The input is the port's view layout [B, 1, F, T];
the module turns it time-major, so the patch grid's H axis is time and the
tokens run row-major over (time, freq) as in JAX. Parameter names are timm's
(``patch_embed.proj``, ``blocks.{i}.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm``); ``models/convert.py:ast_reference_layout``
writes the reference's freq-major order.

Precision, as the JAX module's dtype flow gives it: with no compute dtype
(the probe's, on the log-mel's f32) the whole trunk is IEEE f32 (TF32 off),
LayerNorm's eps 1e-6, GELU exact. A ``compute_dtype`` reaches only the
patch conv, as in JAX: its output meets the f32 cls / dist tokens and
positional embedding and leaves the conv as f32.

Attention follows the JAX adapter ``_fused_attention_fn``: q, k and v fold to
[B * H, L, Dh] and go through ``ops.attention.fused_rel_attention`` with no
bias and scale Dh^-0.5 (the Hopper kernels on a CUDA tensor, their plain
versions on a CPU tensor). The operands are cast to ``attention_dtype``,
whose default is chosen by device: bf16 on CUDA (JAX's hardware branch),
the input's dtype on the CPU (its interpret branch); an f32 check on the
card passes torch.float32. The port has no ``auto`` size or train-only gate
(that gate is a TPU measurement): on CUDA the kernels run in training and in
eval. Attention dropout > 0 takes the plain attention with its dropout, as
the JAX gate does (models/ast.py:86-92).

Tensor parallelism (parallel/tp_ast.py): after ``shard_ast_`` each block's
attention holds the q, k and v rows of its H/tp heads and runs them end to
end (the kernels see [B·H/tp, L, Dh]); ``attn.proj`` and ``mlp.fc2`` are
row-parallel and all-reduce, ``mlp.fc1`` column-parallel. Attention
dropout draws the whole [B, H, L, L] mask and keeps this rank's heads, so
the ranks together apply the mask one process would.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.ops.attention import fused_rel_attention
from audiossl_tpu_torch.ops.tokens import gather_tokens
from audiossl_tpu_torch.ops.tokens import patch_drop as drop_tokens
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel import tp as tpar

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ASTConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    fstride: int = 10
    tstride: int = 10
    patch: int = 16
    dropout: float = 0.0  # attention dropout

    @staticmethod
    def tiny(**kw) -> "ASTConfig":
        return ASTConfig(embed_dim=192, num_heads=3, **kw)

    @staticmethod
    def small(**kw) -> "ASTConfig":
        return ASTConfig(embed_dim=384, num_heads=6, **kw)

    @staticmethod
    def base(**kw) -> "ASTConfig":
        return ASTConfig(**kw)


VARIANTS = {"tiny": ASTConfig.tiny, "small": ASTConfig.small, "base": ASTConfig.base}


def patch_grid(input_fdim: int, input_tdim: int, cfg: ASTConfig) -> tuple[int, int]:
    """(time, freq) patches of a [F, T] input: 101 x 12 at 128 x 1024."""
    return ((input_tdim - cfg.patch) // cfg.tstride + 1, (input_fdim - cfg.patch) // cfg.fstride + 1)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dropout: float, attention_dtype: torch.dtype | None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.dropout, self.attention_dtype = dropout, attention_dtype
        self.tp = 1
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def _plain(self, q, k, v, generator):
        """flax's dot_product_attention with its dropout on the weights."""
        p = torch.softmax((q * self.head_dim**-0.5) @ k.transpose(-1, -2), dim=-1)
        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("AST attention dropout in training mode needs an explicit torch.Generator")
            b, h = p.shape[:2]
            draw = torch.rand((b, h * self.tp, *p.shape[2:]), generator=generator, device=generator.device)
            keep = draw[:, dist.tp_rank() * h:(dist.tp_rank() + 1) * h].to(p.device) < 1.0 - self.dropout
            p = torch.where(keep, p / (1.0 - self.dropout), 0.0)
        return p @ v

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, n, _ = x.shape
        h, dh = self.num_heads // self.tp, self.head_dim
        sharded = tpar.sharded(self.tp)
        linear = tpar.column_parallel if sharded else F.linear
        qkv = linear(x, self.qkv.weight, self.qkv.bias).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, H, L, Dh]
        if self.dropout > 0.0:
            out = self._plain(q, k, v, generator)
        else:
            dt = self.attention_dtype or (torch.bfloat16 if x.device.type == "cuda" else x.dtype)
            fold = lambda t: t.reshape(b * h, n, dh).to(dt)
            out = fused_rel_attention(fold(q), fold(k), fold(v), None, None, dh**-0.5).to(x.dtype).reshape(b, h, n, dh)
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        linear = tpar.row_parallel if sharded else F.linear  # row-parallel over the heads
        return linear(out, self.proj.weight, self.proj.bias)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.tp = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tpar.sharded(self.tp):  # column -> GELU -> row
            return tpar.tp_mlp(x, self.fc1.weight, self.fc2.weight, self.fc1.bias, self.fc2.bias, F.gelu)
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dropout: float, attention_dtype: torch.dtype | None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, dropout, attention_dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), generator)
        return x + self.mlp(self.norm2(x))


class ASTEncoder(nn.Module):
    """[B, 1, F, T] log-fbank -> [B, embed_dim] ((cls + dist) / 2), f32."""

    def __init__(self, input_fdim: int = 128, input_tdim: int = 1024, cfg: ASTConfig | str = "base",
                 patch_drop: float = 0.0, attention_dtype: torch.dtype | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        cfg = VARIANTS[cfg]() if isinstance(cfg, str) else cfg
        self.cfg, self.patch_drop, self.compute_dtype = cfg, patch_drop, compute_dtype
        c = cfg.embed_dim
        self.grid_tf = patch_grid(input_fdim, input_tdim, cfg)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(1, c, cfg.patch, (cfg.tstride, cfg.fstride))  # H = time, W = freq
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid_tf[0] * self.grid_tf[1] + 2, c))
        for p in (self.cls_token, self.dist_token, self.pos_embed):  # flax's truncated_normal(0.02)
            nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04)
        self.blocks = nn.ModuleList(
            ViTBlock(c, cfg.num_heads, cfg.mlp_ratio, cfg.dropout, attention_dtype) for _ in range(cfg.depth)
        )
        self.norm = nn.LayerNorm(c, eps=LN_EPS)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """In training mode ``generator`` draws the patch-drop tokens and the
        attention dropout; ``keep`` [B, N_keep] gives the kept patch tokens
        instead (the parity tests pass JAX's)."""
        with no_tf32():
            x = self.embed(x)
            if self.training and self.patch_drop > 0.0:
                if keep is not None:
                    kept = gather_tokens(x[:, 2:], keep)
                elif generator is None:
                    raise ValueError("AST patch drop in training mode needs an explicit torch.Generator or kept indices")
                else:
                    kept = drop_tokens(x[:, 2:], self.patch_drop, generator)
                x = torch.cat([x[:, :2], kept], dim=1)
            for blk in self.blocks:
                x = blk(x, generator)
            return self.pool(x)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, F, T] -> [B, N + 2, C] tokens: the patch conv, the cls and
        dist tokens, the positional embedding (TF32 off on the caller's side)."""
        dt = self.compute_dtype or torch.float32
        proj = self.patch_embed.proj
        x = x.to(dt).transpose(-1, -2)  # [B, 1, T, F]: time on H as in the JAX module
        x = F.conv2d(x, proj.weight.to(dt), proj.bias.to(dt), proj.stride).float()
        x = x.flatten(2).transpose(1, 2)  # [B, t * f, C], row-major over (t, f)
        b = x.shape[0]
        return torch.cat([self.cls_token.expand(b, -1, -1), self.dist_token.expand(b, -1, -1), x], dim=1) + self.pos_embed

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N + 2, C] -> [B, C]: the final LayerNorm, then the mean of the
        cls and dist tokens."""
        x = self.norm(x)
        return (x[:, 0] + x[:, 1]) / 2.0
