"""AudioNTT block 1 in training: Conv3x3 (C_in = 1) -> BatchNorm (batch
statistics) -> ReLU -> MaxPool 2x2, without writing the conv activation.

Port of ``audiossl_tpu/ops/block1.py``. Its three TPU kernels become three
hand-written Hopper kernels (csrc/block1.cu), each with a plain PyTorch
version of the same function beside it and a ``launches`` counter:

  ``block1_fwd``        <- ``_apply_kernel``: pooled relu(BN(conv(x)))
  ``block1_bwd_sums``   <- ``_bwd1_kernel``: per-channel sum(dy), sum(dy * y_raw)
  ``block1_bwd_weight`` <- ``_bwd2_kernel``: dW and dbias of the BN backward

A wrapper takes the plain version for a CPU tensor only; on a CUDA tensor it
launches the kernel or raises. In bf16 (the training path) all three run on
tensor-core tiles and take the block's 64 channels only; in f32 they run on
f32 FFMAs at any width. ``batch_stats`` is plain torch on every device,
as on the TPU it is XLA: Gram-matrix quadratic forms, so the conv output is
never formed. ``FusedBlock1`` ties them into one ``autograd.Function``.

Layouts are the port's: x [B, 1, F, T] (freq, time), weight [C, 1, 3, 3]
(the reference ``Conv2d``), pooled output NCHW [B, C, F/2, T/2]. The kernels
take the per-channel values packed as ``params`` [C, 16] f32: w[0..8] (the
weights rounded to x's dtype), bias, a, b2, k1, k2, k3 (``pack_params``).

Two weight precisions, as in the JAX package: the batch statistics use the
f32 weights; the forward and backward passes use the weights rounded to the
stream dtype (bf16 in training).

The maxpool gradient goes to the window's FIRST maximum in the JAX package's
time-major order (t0,f0), (t0,f1), (t1,f0), (t1,f1) — not ``F.max_pool2d``'s
(f, t) order — so the plain versions route dy explicitly. The input gradient
is not computed: ``fused_block1`` raises for an input that requires grad.

SyncBN across processes (parallel/dist.py), as the JAX block does under
``axis_name``: the forward all-reduces the batch mean and mean of squares
between ``batch_moments`` and ``block1_fwd`` (``_batch_stats``'s pmean), and
the backward all-reduces Σ dxhat and Σ dxhat·xhat between
``block1_bwd_sums`` and ``block1_bwd_weight`` and divides by the global
count (``_bwd``'s psum). The kernels see only their process's clips. With no
process group nothing changes: the same launches and the same bits.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from audiossl_tpu_torch import kernels, no_tf32
from audiossl_tpu_torch.parallel import dist

BN_EPS = 1e-5  # ConvBlock's BatchNorm epsilon
N_PARAMS = 16
_W, _BIAS, _A, _B2, _K1, _K2, _K3 = 0, 9, 10, 11, 12, 13, 14
# window elements (df, dt) in the JAX kernels' quadrant order (ops/block1.py:188-213)
WINDOW_ORDER = ((0, 0), (1, 0), (0, 1), (1, 1))


def feasible(t: int, f: int, c: int) -> bool:
    """The JAX package's dispatch rule for the fused block (even t/f grids and
    its TPU lane alignment); the port takes the fused path exactly where the
    JAX package does."""
    return t % 2 == 0 and f % 2 == 0 and ((f // 2) * c) % 128 == 0 and (3 * f) % 8 == 0


def banded_matrix(weight: torch.Tensor, f: int) -> torch.Tensor:
    """[C, 1, 3, 3] f32 conv weight -> [3F, F*C]: row (dj, f_in), column
    (f_out, c), so that rows of three time-shifted inputs times it give the
    conv output (the TPU package's ``banded_matrix`` in the port's layout)."""
    # made on weight's device: no host-to-device copy, so that a CUDA graph can capture it
    eye = torch.stack([torch.ones(f - abs(1 - di), device=weight.device).diag(1 - di) for di in range(3)])
    m = torch.einsum("dio,cdj->jioc", eye, weight[:, 0].float())
    return m.reshape(3 * f, f * weight.shape[0])


def batch_moments(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch mean and mean of squares per channel of conv(x) + bias over
    (B, F, T), from the f32 weights, as ``_batch_stats`` computes them:
    sum(y) = (1ᵀX) M and sum(y²) = Σ M ⊙ ((XᵀX) M) over rows X of the three
    time shifts, so only a [3F, 3F] Gram matrix is formed. No gradient."""
    with torch.no_grad(), no_tf32():
        b, _, f, t = x.shape
        c = weight.shape[0]
        xp = F.pad(x[:, 0].float(), (1, 1))  # [B, F, T + 2]
        rows = torch.cat([xp[:, :, 0:t], xp[:, :, 1 : t + 1], xp[:, :, 2 : t + 2]], dim=1)
        rows = rows.transpose(1, 2).reshape(b * t, 3 * f)  # row (b, t), column (dj, f_in)
        gram = rows.T @ rows
        colsum = rows.sum(0)
        m = banded_matrix(weight, f)
        s_q = colsum @ m  # per column (f_out, c): sum of conv
        ssq_q = (m * (gram @ m)).sum(0)  # sum of conv²
        bias_cols = bias.float().repeat(f)
        n2 = b * t
        s_raw = s_q + n2 * bias_cols
        ssq_raw = ssq_q + 2.0 * bias_cols * s_q + n2 * bias_cols**2
        n = n2 * f
        mean = s_raw.view(f, c).sum(0) / n
        msq = ssq_raw.view(f, c).sum(0) / n
        return mean, msq


def batch_stats(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch mean and biased variance (E[y²] − E[y]²) per channel of
    conv(x) + bias over this process's (B, F, T). No gradient."""
    mean, msq = batch_moments(x, weight, bias)
    return mean, msq - mean**2


def pack_params(
    weight: torch.Tensor, bias: torch.Tensor, a: torch.Tensor, b2: torch.Tensor,
    k1: torch.Tensor | None = None, k2: torch.Tensor | None = None, k3: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-channel kernel inputs [C, 16] f32; the weights are rounded to
    ``dtype`` (the stream dtype) first."""
    c = weight.shape[0]
    zero = torch.zeros(c, dtype=torch.float32, device=weight.device)
    cols = [weight.reshape(c, 9).to(dtype).float()]
    cols += [v.float()[:, None] for v in (bias, a, b2, *(zero if k is None else k for k in (k1, k2, k3)))]
    cols.append(zero[:, None])
    return torch.cat(cols, dim=1).contiguous()


# ---------------------------------------------------------------- plain versions


def _conv(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """f32 conv without bias, [B, C, F, T], as a product with the 3x3
    patches: the same sum of 9 products at every position (a cuDNN
    algorithm such as Winograd need not be, and would break exact ties)."""
    b, _, f, t = x.shape
    patches = F.unfold(x.float(), 3, padding=1)  # [B, 9, F*T], tap order (di, dj)
    with no_tf32():
        return torch.matmul(params[:, _W : _W + 9], patches).view(b, -1, f, t)


def _col(params: torch.Tensor, i: int) -> torch.Tensor:
    return params[:, i].view(1, -1, 1, 1)


def _windows(y: torch.Tensor) -> list[torch.Tensor]:
    """[B, C, F, T] -> the four window elements [B, C, F/2, T/2], in WINDOW_ORDER."""
    b, c, f, t = y.shape
    v = y.view(b, c, f // 2, 2, t // 2, 2)
    return [v[:, :, :, df, :, dt] for df, dt in WINDOW_ORDER]


def _recompute(x: torch.Tensor, dp: torch.Tensor, params: torch.Tensor):
    """(y_raw, dy) per window element: dp routed to the first maximum of
    relu(bn) in WINDOW_ORDER, times relu'(bn)."""
    y_raw = _conv(x, params) + _col(params, _BIAS)
    bns = _windows(y_raw * _col(params, _A) + _col(params, _B2))
    outs = [b.clamp_min(0.0) for b in bns]
    mx = torch.maximum(torch.maximum(outs[0], outs[1]), torch.maximum(outs[2], outs[3]))
    taken = torch.zeros_like(mx, dtype=torch.bool)
    dpf = dp.float()
    dys = []
    for o, b in zip(outs, bns):
        first = (o == mx) & ~taken
        taken |= first
        dys.append(torch.where(first & (b > 0.0), dpf, 0.0))
    return _windows(y_raw), dys


def block1_fwd_plain(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    a = _col(params, _A)
    bapp = _col(params, _B2) + _col(params, _BIAS) * a  # the TPU kernel's folded shift
    val = (_conv(x, params) * a + bapp).clamp_min(0.0)
    return F.max_pool2d(val, 2, 2).to(x.dtype)


def block1_bwd_sums_plain(x: torch.Tensor, dp: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    yraws, dys = _recompute(x, dp, params)
    sdy = sum(dy.sum((0, 2, 3)) for dy in dys)
    sdyy = sum((dy * y).sum((0, 2, 3)) for dy, y in zip(dys, yraws))
    return torch.stack([sdy, sdyy], dim=1)


def block1_bwd_weight_plain(x: torch.Tensor, dp: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    yraws, dys = _recompute(x, dp, params)
    k1, k2, k3 = (_col(params, i) for i in (_K1, _K2, _K3))
    b, _, f, t = x.shape
    c = params.shape[0]
    dconv = torch.empty((b, c, f // 2, 2, t // 2, 2), dtype=torch.float32, device=x.device)
    for (df, dt), y, dy in zip(WINDOW_ORDER, yraws, dys):
        dconv[:, :, :, df, :, dt] = k1 * dy + k2 * y + k3
    dconv = dconv.view(b, c, f * t)
    patches = F.unfold(x.float(), 3, padding=1)  # [B, 9, F*T], tap order (di, dj)
    with no_tf32():
        dw = torch.einsum("bcn,bkn->ck", dconv, patches)
    return torch.cat([dw, dconv.sum((0, 2))[:, None]], dim=1)


# ---------------------------------------------------------------- kernel wrappers


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = kernels.load("block1")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.audiossl_block1_blocks.argtypes = [i, i, i, i, i, i]
    lib.audiossl_block1_blocks.restype = i
    lib.audiossl_block1_fwd.argtypes = [p, i, i, i, i, i, p, i, p, p]
    lib.audiossl_block1_fwd.restype = i
    for fn in (lib.audiossl_block1_bwd_sums, lib.audiossl_block1_bwd_weight):
        fn.argtypes = [p, p, i, i, i, i, i, p, i, p, p, p]
        fn.restype = i
    return lib


def _check(x: torch.Tensor, params: torch.Tensor, dp: torch.Tensor | None = None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"block-1 kernels take a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.shape[1] != 1 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"expected x [B, 1, F, T] with F and T even, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32 or bf16, got {x.dtype}")
    if params.dtype != torch.float32 or params.dim() != 2 or params.shape[1] != N_PARAMS:
        raise ValueError(f"params must be [C, {N_PARAMS}] f32, got {tuple(params.shape)} {params.dtype}")
    if not params.is_contiguous() or params.device != x.device:
        raise ValueError("params must be contiguous and on x's device")
    if dp is not None:
        b, _, f, t = x.shape
        want = (b, params.shape[0], f // 2, t // 2)
        if tuple(dp.shape) != want or dp.dtype != x.dtype or not dp.is_contiguous() or dp.device != x.device:
            raise ValueError(f"dp must be contiguous {want} {x.dtype} on x's device, got {tuple(dp.shape)} {dp.dtype}")


def _raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


_FWD, _SUMS, _DW = 0, 1, 2  # the passes, as the kernel library's grid query names them


@functools.lru_cache(maxsize=None)
def _blocks(device: int, pass_: int, b: int, f: int, t: int, c: int, bf16: bool) -> int:
    """A pass's grid (for a backward pass, the rows of its partials) for this
    shape on this device; the kernel library may set a shared-memory
    attribute here, so it is asked once, before any graph capture that
    launches the pass."""
    if bf16 and c != 64:
        raise ValueError(f"the bf16 block-1 kernels take 64 channels (AudioNTT's block 1), got {c}")
    with torch.cuda.device(device):
        blocks = _lib().audiossl_block1_blocks(pass_, b, f, t, c, int(bf16))
    if blocks == 0:
        raise ValueError(f"clips of {t} frames are too long for the block-1 kernels' shared-memory tile")
    return blocks


def block1_fwd(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """x [B, 1, F, T] -> pooled [B, C, F/2, T/2] in x's dtype."""
    if x.device.type == "cpu":
        return block1_fwd_plain(x, params)
    _check(x, params)
    b, _, f, t = x.shape
    c = params.shape[0]
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((b, c, f // 2, t // 2), dtype=x.dtype, device=x.device)
    if b:
        blocks = _blocks(x.device.index, _FWD, b, f, t, c, bf16)
        with torch.cuda.device(x.device):
            err = _lib().audiossl_block1_fwd(
                x.data_ptr(), int(bf16), b, f, t, c, params.data_ptr(), blocks,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
        _raise_if(err, "block1_fwd")
        block1_fwd.launches += 1
    return out


# eager calls reuse one partials buffer per (device, stream, host thread, shape): the
# passes one thread launches on one stream run one after another, so no two calls in
# flight share a buffer
_partials: dict[tuple, torch.Tensor] = {}


def _partial_buffer(x: torch.Tensor, blocks: int, c: int, n_out: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():  # a captured graph keeps its own
        return torch.empty((blocks, c, n_out), dtype=torch.float32, device=x.device)
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream, threading.get_ident(), blocks, c, n_out)
    if key not in _partials:
        _partials[key] = torch.empty((blocks, c, n_out), dtype=torch.float32, device=x.device)
    return _partials[key]


def _bwd(fn_name: str, n_out: int, x: torch.Tensor, dp: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    _check(x, params, dp)
    b, _, f, t = x.shape
    c = params.shape[0]
    bf16 = x.dtype == torch.bfloat16
    blocks = _blocks(x.device.index, _DW if n_out == 10 else _SUMS, b, f, t, c, bf16)
    out = torch.empty((c, n_out), dtype=torch.float32, device=x.device)
    partial = _partial_buffer(x, blocks, c, n_out)
    with torch.cuda.device(x.device):
        err = getattr(_lib(), fn_name)(
            x.data_ptr(), dp.data_ptr(), int(bf16), b, f, t, c, params.data_ptr(), blocks,
            partial.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_if(err, fn_name)
    return out


def block1_bwd_sums(x: torch.Tensor, dp: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """-> [C, 2] f32: per-channel sum(dy) and sum(dy * y_raw)."""
    if x.device.type == "cpu":
        return block1_bwd_sums_plain(x, dp, params)
    out = _bwd("audiossl_block1_bwd_sums", 2, x, dp, params)
    block1_bwd_sums.launches += 1
    return out


def block1_bwd_weight(x: torch.Tensor, dp: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """-> [C, 10] f32: dW[c, 0, di, dj] at column di * 3 + dj, then dbias."""
    if x.device.type == "cpu":
        return block1_bwd_weight_plain(x, dp, params)
    out = _bwd("audiossl_block1_bwd_weight", 10, x, dp, params)
    block1_bwd_weight.launches += 1
    return out


# kernel launches; the chip smoke run resets and reads them
block1_fwd.launches = block1_bwd_sums.launches = block1_bwd_weight.launches = 0


# ---------------------------------------------------------------- autograd


class FusedBlock1(torch.autograd.Function):
    """(x, weight, bias, gamma, beta) -> (pooled, batch mean, batch var).

    The batch statistics are outputs without gradient (the caller updates
    its running statistics from them); the backward carries their loss paths
    analytically, as ``_bwd`` does (ops/block1.py:445-509)."""

    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta):
        mean, msq = batch_moments(x, weight, bias)
        if dist.data_active():  # SyncBN: the group's moments (JAX pmean, ops/block1.py:368-370)
            mean, msq = dist.all_reduce_mean(torch.stack([mean, msq]), "syncbn").unbind(0)
        var = msq - mean**2
        istd = torch.rsqrt(var + BN_EPS)
        a = gamma.detach() * istd
        b2 = beta.detach() - mean * a
        pooled = block1_fwd(x, pack_params(weight.detach(), bias.detach(), a, b2, dtype=x.dtype))
        ctx.save_for_backward(x, weight, bias, gamma, beta, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, dp, _dmean, _dvar):
        x, weight, bias, gamma, beta, mean, var = ctx.saved_tensors
        dp = dp.to(x.dtype).contiguous()
        istd = torch.rsqrt(var + BN_EPS)
        a = gamma * istd
        b2 = beta - mean * a
        sums = block1_bwd_sums(x, dp, pack_params(weight, bias, a, b2, dtype=x.dtype))
        sdy, sdyy = sums[:, 0], sums[:, 1]
        dbeta = sdy
        dgamma = (sdyy - mean * sdy) * istd  # sum(dy * xhat)
        b, _, f, t = x.shape
        s1 = gamma * sdy  # Σ dxhat
        s2 = gamma * dgamma  # Σ dxhat · xhat
        if dist.data_active():  # the group's sums over its global count (JAX psum, ops/block1.py:470-478)
            s1, s2 = dist.all_reduce_sum(torch.stack([s1, s2]), "syncbn").unbind(0)
        n = b * f * t * dist.dp_world()
        s1 = s1 / n
        s2 = s2 / n
        k1 = istd * gamma
        k2 = -(istd**2) * s2
        k3 = -istd * s1 + istd**2 * s2 * mean
        g = block1_bwd_weight(x, dp, pack_params(weight, bias, a, b2, k1, k2, k3, dtype=x.dtype))
        dweight = g[:, :9].reshape(weight.shape).to(weight.dtype)
        return None, dweight, g[:, 9].to(bias.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


def fused_block1(x, weight, bias, gamma, beta):
    """Block 1 on batch statistics: x [B, 1, F, T] (data, no gradient) ->
    (pooled [B, C, F/2, T/2] in x's dtype, batch mean [C], batch var [C])."""
    if x.requires_grad:
        raise ValueError(
            "fused_block1 does not compute the input gradient (the JAX kernel returns "
            "zeros there, ops/block1.py:33-36); its input must not require grad. Use "
            "the plain conv block when something trainable feeds block 1."
        )
    # the kernels read x densely; a strided view (a transposed log-mel) is copied once
    return FusedBlock1.apply(x.contiguous(), weight, bias, gamma, beta)
