"""Pooled attention with a decomposed relative-position bias (port of
``audiossl_tpu.ops.attention``).

MViT's attention is, per (batch * head):

    scores = (q * scale) @ k^T + bias @ E          # [Lq, Lk]
    out    = softmax(scores) @ v                   # [Lq, D]

where ``bias = [q·rel_pos_h | q·rel_pos_w]`` ([Lq, kh + kw]) and ``E`` is the
0/1 expansion ``rel_expand_matrix(kh, kw)`` that broadcasts the height and
width biases over the flattened [kh, kw] key grid. ``bias=None`` is plain
attention (the no-bias mode, for AST).

The TPU kernels (forward ``_fwd_kernel``, backward ``_bwd_kernel``) become
three Hopper kernels (csrc/attention.cu), each with a plain PyTorch version
of the same function beside it and a ``launches`` counter:

  ``rel_attention_fwd``     <- ``_fwd_kernel``: out
  ``rel_attention_bwd_dq``  <- ``_bwd_kernel`` (dq, dbias) + each row's softmax
                               max, sum and rowsum(dp * p)
  ``rel_attention_bwd_dkv`` <- ``_bwd_kernel`` (dk, dv), from those row statistics

In bf16 the three kernels run their products on the tensor cores
(mma.sync; the forward keeps its FFMA kernel for a head width that is not a
multiple of 8); in f32 (the parity path) every kernel is f32 FFMA. In bf16
the no-bias forward and dq (AST) always stream the keys through shared
memory in chunks and take any key length; with a bias they keep k and v
resident, and the dq has that limit (MAST-B's keys, 306 at most, fit). In
f32 the forward and dq stream the keys where they do not fit beside the
tiles (AST-base's 1214 keys), with or without a bias, up to over 3,000 keys
(the whole score rows stay in shared memory). ``_tile_or_raise`` names the
limit of a shape that does not fit. A wrapper
takes the plain version for a CPU tensor only; on a CUDA tensor it
launches the kernel or raises. The kernels read the bias decomposed, so on
CUDA ``expand`` must be ``rel_expand_matrix(kh, kw)`` (given as the pair
``(kh, kw)``, or as that matrix, which is checked); the plain versions take
any E. ``fused_rel_attention`` ties them into one ``autograd.Function``:
it saves q, k, v and the bias, never the score matrix.

Rounding follows the JAX kernel: q is scaled in its own dtype before the
kernel (attention.py:168), p is rounded to v's dtype before p @ v, ds and p
before the dk, dv and dq products, dq before its scale; every sum is f32.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from audiossl_tpu_torch import kernels, no_tf32


def rel_expand_matrix(kh: int, kw: int, kb_pad: int | None = None) -> np.ndarray:
    """[kh + kw (padded), kh * kw] 0/1 expansion: bias_flat = bias_cat @ E.
    Row i < kh selects the keys in grid row i, row kh + j those in grid
    column j, so (bias_cat @ E)[q, r * kw + c] = rel_h[q, r] + rel_w[q, c]."""
    e = np.zeros((kb_pad or (kh + kw), kh * kw), np.float32)
    cols = np.arange(kh * kw)
    e[cols // kw, cols] = 1.0
    e[kh + cols % kw, cols] = 1.0
    return e


# ---------------------------------------------------------------- plain versions


def _dense_expand(expand, kb: int, device: torch.device) -> torch.Tensor:
    """E [kb, Lk] f32 from a (kh, kw) pair or a matrix (extra padded rows cut)."""
    if isinstance(expand, tuple):
        expand = rel_expand_matrix(*expand)
    return torch.as_tensor(expand, dtype=torch.float32, device=device)[:kb]


def scale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q's dtype, the scale first rounded to it (attention.py:168)."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _scores(qs, k, bias, expand) -> torch.Tensor:
    s = torch.matmul(qs.float(), k.float().transpose(1, 2))
    if bias is not None:
        s = s + torch.matmul(bias.float(), _dense_expand(expand, bias.shape[-1], s.device))
    return s


def attention_fwd_plain(qs, k, v, bias, expand) -> torch.Tensor:
    """softmax(qs @ k^T + bias @ E) @ v for the scaled q, out in v's dtype."""
    with no_tf32():
        p = torch.softmax(_scores(qs, k, bias, expand), dim=-1)
        return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def attention_bwd_dq_plain(qs, k, v, bias, expand, scale, do):
    """(dq, dbias or None, row statistics [BH, Lq, 3] f32: the softmax's max
    and sum and rowsum(dp * p)); dq in q's dtype, dbias in the bias's."""
    dt = v.dtype
    with no_tf32():
        s = _scores(qs, k, bias, expand)
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(-1, keepdim=True)
        p = e / l
        dp = torch.matmul(do.float(), v.float().transpose(1, 2))
        delta = (dp * p).sum(-1, keepdim=True)
        ds = p * (dp - delta)
        dq = torch.matmul(ds.to(dt).float(), k.float()).to(dt)
        dq = (dq.float() * scale).to(qs.dtype)
        dbias = None
        if bias is not None:
            dbias = torch.matmul(ds, _dense_expand(expand, bias.shape[-1], ds.device).T).to(bias.dtype)
    return dq, dbias, torch.cat([m, l, delta], dim=-1)


def attention_bwd_dkv_plain(qs, k, v, bias, expand, do, stats):
    """(dk, dv) in k's and v's dtype, p and ds rebuilt from the row statistics."""
    dt = v.dtype
    with no_tf32():
        s = _scores(qs, k, bias, expand)
        p = torch.exp(s - stats[..., 0:1]) / stats[..., 1:2]
        dp = torch.matmul(do.float(), v.float().transpose(1, 2))
        ds = p * (dp - stats[..., 2:3])
        dk = torch.matmul(ds.to(dt).float().transpose(1, 2), qs.float()).to(k.dtype)
        dv = torch.matmul(p.to(dt).float().transpose(1, 2), do.float()).to(dt)
    return dk, dv


# ---------------------------------------------------------------- kernel wrappers


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = kernels.load("attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.audiossl_attn_tile.argtypes = [i, i, i, i, i]
    lib.audiossl_attn_tile.restype = i
    lib.audiossl_attn_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, p]
    lib.audiossl_attn_fwd.restype = i
    lib.audiossl_attn_bwd_dq.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, p, p, p, p]
    lib.audiossl_attn_bwd_dq.restype = i
    lib.audiossl_attn_bwd_dkv.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p]
    lib.audiossl_attn_bwd_dkv.restype = i
    lib.audiossl_attn_dkv_scratch.argtypes = [i, i, i, i, i, i]
    lib.audiossl_attn_dkv_scratch.restype = ctypes.c_longlong
    return lib


def kernel_grid(expand, lk: int) -> tuple[int, int]:
    """(kh, kw) of an E that is rel_expand_matrix(kh, kw) with kh * kw = Lk,
    given as the pair or as the matrix; (0, 0) for None. Raises otherwise:
    the kernels read the bias decomposed and take no other E."""
    if expand is None:
        return 0, 0
    if isinstance(expand, tuple):
        kh, kw = expand
        if kh * kw != lk:
            raise ValueError(f"key grid {kh}x{kw} does not hold {lk} keys")
        return int(kh), int(kw)
    e = torch.as_tensor(expand).detach().cpu().float()
    kb = e.shape[0]
    disc = kb * kb - 4 * lk
    if e.dim() == 2 and e.shape[1] == lk and disc >= 0:
        root = math.isqrt(disc)
        for kh in {(kb - root) // 2, (kb + root) // 2}:
            kw = kb - kh
            if kh * kw == lk and root * root == disc and torch.equal(e, torch.from_numpy(rel_expand_matrix(kh, kw))):
                return kh, kw
    raise ValueError("the attention kernels take only E = rel_expand_matrix(kh, kw) (the decomposed rel-pos bias)")


def _check(q, k, v, bias, kb: int, extra=()) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels take a CPU or CUDA tensor, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the attention kernels take f32 or bf16, got {q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2] or v.shape != k.shape:
        raise ValueError(f"expected q [BH, Lq, D] and k, v [BH, Lk, D], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] > 128:
        raise ValueError(f"the attention kernels take head widths up to 128, got {q.shape[2]}")
    tensors = [q, k, v, *extra] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError("q, k, v, bias and dO must be contiguous, of one dtype, on one device")
    if bias is not None and tuple(bias.shape) != (q.shape[0], q.shape[1], kb):
        raise ValueError(f"bias must be [BH, Lq, {kb}], got {tuple(bias.shape)}")
    for t in extra:
        if t.shape != q.shape:
            raise ValueError(f"dO must be {tuple(q.shape)}, got {tuple(t.shape)}")


def _tile_or_raise(which: int, q, k, kb: int) -> None:
    lk, d = k.shape[1], k.shape[2]
    bf16 = int(q.dtype == torch.bfloat16)
    if bf16 and which > 0 and d % 8:
        raise ValueError(f"the bf16 backward kernels take head widths that are a multiple of 8, got {d}")
    tile = lambda n: _lib().audiossl_attn_tile(which, n, d, kb, bf16)
    if tile(lk) == 0:
        lo, hi = 0, lk  # the fit shrinks as the keys grow: the largest n that fits
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if tile(mid) else (lo, mid)
        raise ValueError(f"{lk} keys do not fit the attention kernel's shared memory (at D={d}, "
                         f"{q.dtype}, the limit is {lo} keys)")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def rel_attention_fwd(qs, k, v, bias, expand) -> torch.Tensor:
    """qs (q already scaled), k, v [BH, L, D] and bias [BH, Lq, kh + kw]
    or None -> out [BH, Lq, D] in v's dtype."""
    if qs.device.type == "cpu":
        return attention_fwd_plain(qs, k, v, bias, expand)
    kh, kw = kernel_grid(expand, k.shape[1]) if bias is not None else (0, 0)
    _check(qs, k, v, bias, kh + kw)
    _tile_or_raise(0, qs, k, kh + kw)
    (bh, lq, d), lk = qs.shape, k.shape[1]
    out = torch.empty_like(qs)
    with torch.cuda.device(qs.device):
        err = _lib().audiossl_attn_fwd(
            _ptr(qs), _ptr(k), _ptr(v), _ptr(bias), bh, lq, lk, d, kh, kw, int(qs.dtype == torch.bfloat16),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rel_attention_fwd kernel launch failed: CUDA error {err}")
    rel_attention_fwd.launches += 1
    return out


def rel_attention_bwd_dq(qs, k, v, bias, expand, scale: float, do):
    """-> (dq, dbias or None, row statistics [BH, Lq, 3] f32)."""
    if qs.device.type == "cpu":
        return attention_bwd_dq_plain(qs, k, v, bias, expand, scale, do)
    kh, kw = kernel_grid(expand, k.shape[1]) if bias is not None else (0, 0)
    _check(qs, k, v, bias, kh + kw, (do,))
    _tile_or_raise(1, qs, k, kh + kw)
    (bh, lq, d), lk = qs.shape, k.shape[1]
    dq = torch.empty_like(qs)
    dbias = torch.empty_like(bias) if bias is not None else None
    stats = torch.empty((bh, lq, 3), dtype=torch.float32, device=qs.device)
    with torch.cuda.device(qs.device):
        err = _lib().audiossl_attn_bwd_dq(
            _ptr(qs), _ptr(k), _ptr(v), _ptr(bias), _ptr(do), bh, lq, lk, d, kh, kw,
            int(qs.dtype == torch.bfloat16), float(scale), dq.data_ptr(), _ptr(dbias), stats.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rel_attention_bwd_dq kernel launch failed: CUDA error {err}")
    rel_attention_bwd_dq.launches += 1
    return dq, dbias, stats


def rel_attention_bwd_dkv(qs, k, v, bias, expand, do, stats):
    """-> (dk, dv), from the row statistics of ``rel_attention_bwd_dq``."""
    if qs.device.type == "cpu":
        return attention_bwd_dkv_plain(qs, k, v, bias, expand, do, stats)
    kh, kw = kernel_grid(expand, k.shape[1]) if bias is not None else (0, 0)
    _check(qs, k, v, bias, kh + kw, (do,))
    _tile_or_raise(2, qs, k, kh + kw)
    (bh, lq, d), lk = qs.shape, k.shape[1]
    if stats.shape != (bh, lq, 3) or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError(f"stats must be contiguous [{bh}, {lq}, 3] f32")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    bf16 = int(qs.dtype == torch.bfloat16)
    with torch.cuda.device(qs.device):
        n_scratch = _lib().audiossl_attn_dkv_scratch(bh, lq, lk, d, kh + kw, bf16)
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=qs.device) if n_scratch else None
        err = _lib().audiossl_attn_bwd_dkv(
            _ptr(qs), _ptr(k), _ptr(v), _ptr(bias), _ptr(do), stats.data_ptr(), bh, lq, lk, d, kh, kw,
            bf16, dk.data_ptr(), dv.data_ptr(), _ptr(scratch), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rel_attention_bwd_dkv kernel launch failed: CUDA error {err}")
    rel_attention_bwd_dkv.launches += 1
    return dk, dv


# kernel launches; the chip smoke run resets and reads them
rel_attention_fwd.launches = rel_attention_bwd_dq.launches = rel_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------- autograd


class RelAttention(torch.autograd.Function):
    """(q, k, v, bias) -> out; the backward runs the two backward kernels
    (plain versions on the CPU) from the saved q, k, v and bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, expand, scale):
        ctx.expand, ctx.scale = expand, scale
        ctx.save_for_backward(q, k, v, bias)
        return rel_attention_fwd(scale_q(q, scale), k, v, bias, expand)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        qs = scale_q(q, ctx.scale)
        do = do.to(v.dtype).contiguous()
        dq, dbias, stats = rel_attention_bwd_dq(qs, k, v, bias, ctx.expand, ctx.scale, do)
        dk, dv = rel_attention_bwd_dkv(qs, k, v, bias, ctx.expand, do, stats)
        return dq, dk, dv, dbias, None, None


def fused_rel_attention(q, k, v, bias, expand, scale: float) -> torch.Tensor:
    """softmax((q * scale) @ k^T [+ bias @ E]) @ v, differentiable in q, k, v
    and bias. q [BH, Lq, D]; k, v [BH, Lk, D]; bias [BH, Lq, kh + kw] or
    None; ``expand`` the pair (kh, kw), an E matrix (any E on the CPU, only
    rel_expand_matrix on CUDA) or None with no bias. Out in v's dtype."""
    if (bias is None) != (expand is None):
        raise ValueError("bias and expand go together: both or neither")
    return RelAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                              bias.contiguous() if bias is not None else None, expand, scale)
