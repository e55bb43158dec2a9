"""Ring attention and a blockwise AST over the time-split spectrogram (port
of ``audiossl_tpu.parallel.ring``).

Pairs with frontend/sp.py: for minutes-long audio the time axis stays split
over a group end to end. ``sp_log_mel_local`` gives each rank its block of
the spectrogram; ``long_ast_forward`` patchifies it and attends over the
whole sequence without gathering it: ``ring_attention`` streams each
rank's K and V round the ring (``dist.ppermute``, one hop a step, K and V
as one tensor) with the running max and sum corrections, so the result is
exactly softmax(QK^T)V. It is plain torch, as JAX computes it: feeding a
hop through the attention kernel would need the forward kernel to return
its row statistics.

The blocks are the port's ``models.ast.ViTBlock`` (JAX's keys ``ln1``,
``qkv``, ``proj``, ``ln2``, ``fc1``, ``fc2``: ``models.convert.
long_ast_from_jax``), with ring attention in place of their own. The
pooled token mean is ``dist.all_reduce_sum`` over the group, whose backward
sums the cotangents: a rank's gradient is then JAX's per-device gradient
inside ``shard_map``, and the replicated parameters' gradient is the
ranks' mean (as the data-parallel step takes it). ``dist.calls`` counts
"sp_ring" (W - 1 hops a block, each way), "sp_halo" and "sp_pool".
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from audiossl_tpu_torch import no_tf32
from audiossl_tpu_torch.frontend.sp import sp_log_mel_local
from audiossl_tpu_torch.models.ast import LN_EPS, ViTBlock
from audiossl_tpu_torch.parallel import dist


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None) -> torch.Tensor:
    """Exact attention over a sequence split along ``group``: q, k, v [B, H,
    T_local, Dh] a rank -> [B, H, T_local, Dh]. W steps, K and V one hop
    downstream a step (none after the last), online softmax."""
    w = dist.world(group)
    scale = q.shape[-1] ** -0.5
    perm = [(j, (j + 1) % w) for j in range(w)]
    kv = torch.stack([k, v])
    for step in range(w):
        s = (q @ kv[0].transpose(-1, -2)) * scale
        if step == 0:
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l, acc = p.sum(dim=-1, keepdim=True), p @ kv[1]
        else:
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p, corr = torch.exp(s - m_new), torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ kv[1]
            m = m_new
        if step < w - 1:
            kv = dist.ppermute(kv, perm, group, "sp_ring")
    return acc / l


@dataclasses.dataclass(frozen=True)
class LongASTConfig:
    n_mels: int = 64
    time_patch: int = 4  # frames per token (non-overlapping: shard-local)
    embed_dim: int = 192
    depth: int = 4
    num_heads: int = 3
    mlp_ratio: float = 4.0
    tokens_global: int = 64  # total tokens across all shards (pos table size)
    num_classes: int = 0  # 0 = return pooled embedding


class LongAST(nn.Module):
    """The blockwise AST's weights; ``forward`` is ``long_ast_forward``."""

    def __init__(self, cfg: LongASTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch = nn.Linear(cfg.n_mels * cfg.time_patch, d)
        self.pos = nn.Parameter(torch.zeros(1, cfg.tokens_global, d))
        self.blocks = nn.ModuleList(ViTBlock(d, cfg.num_heads, cfg.mlp_ratio, 0.0, None) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, cfg.num_classes) if cfg.num_classes else None

    def forward(self, x_local: torch.Tensor, group=None) -> torch.Tensor:
        return long_ast_forward(self, x_local, group)


def init_long_ast_params(cfg: LongASTConfig, generator: torch.Generator) -> LongAST:
    """A LongAST with JAX's initialisation drawn from ``generator``: every
    kernel and the positional table truncated normal (std 0.02, at two
    std), biases zero, LayerNorms one and zero."""
    model = LongAST(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "pos" or (name.endswith("weight") and p.dim() == 2):
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)
            elif name.endswith("bias"):
                p.zero_()
    return model


def long_ast_forward(model: LongAST, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's spectrogram block [B, n_mels, T_local] -> the logits or the
    pooled embedding [B, ...], whole on every rank (the token mean summed
    over the group)."""
    cfg = model.cfg
    b, f, t_loc = x_local.shape
    if t_loc % cfg.time_patch:
        raise ValueError(f"local frame count {t_loc} not divisible by time_patch {cfg.time_patch}")
    n_loc, w = t_loc // cfg.time_patch, dist.world(group)
    if w * n_loc != cfg.tokens_global:
        raise ValueError(f"{w} shards x {n_loc} tokens/shard != tokens_global={cfg.tokens_global}")
    nh, dh = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    with no_tf32():
        x = model.patch(x_local.transpose(1, 2).reshape(b, n_loc, cfg.time_patch * f))  # frame-major in a patch
        start = dist.rank(group) * n_loc  # this rank's tokens are the global [start, start + n_loc)
        x = x + model.pos[0, start:start + n_loc]
        for blk in model.blocks:
            qkv = blk.attn.qkv(blk.norm1(x)).reshape(b, n_loc, 3, nh, dh).permute(2, 0, 3, 1, 4)
            att = ring_attention(qkv[0], qkv[1], qkv[2], group)
            x = x + blk.attn.proj(att.transpose(1, 2).reshape(b, n_loc, cfg.embed_dim))
            x = x + blk.mlp(blk.norm2(x))
        x = model.norm(x)
        pooled = dist.all_reduce_sum(x.sum(dim=1), "sp_pool", group) / (w * n_loc)
        return model.head(pooled) if model.head is not None else pooled


def long_audio_forward(model: LongAST, wave_local: torch.Tensor, mel_cfg, group=None) -> torch.Tensor:
    """The long-audio path: this rank's waveform slice [B, L / W] -> its
    sp log-mel block -> the blockwise AST -> logits or the embedding. The
    whole sequence is never on one rank."""
    return long_ast_forward(model, sp_log_mel_local(wave_local, mel_cfg, group), group)
