"""The port's rel-pos attention (audiossl_tpu_torch.ops.attention) against the
JAX package's Pallas kernel in interpret mode (f32, the HIGHEST parity path):
the forward, and dq, dk, dv, dbias through the port's autograd Function, whose
backward runs the two backward kernels' plain versions on the CPU. Inputs
are numpy from a seed; the bounds are the JAX kernel test's own
(tests/test_attention_kernel.py:38,56)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiossl_tpu.ops.attention import fused_rel_attention as jax_fused
from audiossl_tpu.ops.attention import rel_expand_matrix as jax_expand
from audiossl_tpu_torch.ops import attention

TOL_FWD = 1e-5
TOL_GRAD = 2e-4


def _case(bh, lq, lk, d, kb, seed, expand=None):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((bh, n, d)).astype(np.float32) for n in (lq, lk, lk))
    bias = None if kb is None else (0.5 * r.standard_normal((bh, lq, kb))).astype(np.float32)
    do = r.standard_normal((bh, lq, d)).astype(np.float32)
    return q, k, v, bias, do


def _jax(q, k, v, bias, e, scale, do):
    args = [jnp.asarray(a) for a in (q, k, v)]
    if bias is None:
        f = lambda q, k, v: jax_fused(q, k, v, None, None, scale, True, True)
    else:
        f = lambda q, k, v, b: jax_fused(q, k, v, b, jnp.asarray(e), scale, True, True)
        args.append(jnp.asarray(bias))
    out, vjp = jax.vjp(f, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(q, k, v, bias, expand, scale, do):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_()
    out = attention.fused_rel_attention(*ts, tb, expand, scale)
    out.backward(torch.from_numpy(do))
    grads = [t.grad.numpy() for t in ts] + ([] if tb is None else [tb.grad.numpy()])
    return out.detach().numpy(), grads


@pytest.mark.parametrize(
    "bh,lq,grid,d",
    [(3, 72, (5, 8), 24), (2, 1100, (13, 10), 96)],  # the second: 3 q-tiles of the JAX kernel
)
def test_matches_jax_kernel_with_rel_expand(bh, lq, grid, d):
    kh, kw = grid
    q, k, v, bias, do = _case(bh, lq, kh * kw, d, kh + kw, seed=lq)
    scale = d**-0.5
    e = jax_expand(kh, kw)
    np.testing.assert_array_equal(attention.rel_expand_matrix(kh, kw), e)
    out_j, g_j = _jax(q, k, v, bias, e, scale, do)
    for expand in ((kh, kw), e):  # the pair (the kernels' form) and the matrix
        out_p, g_p = _port(q, k, v, bias, expand, scale, do)
        assert np.abs(out_p - out_j).max() < TOL_FWD
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), g_p, g_j):
            assert np.abs(a - b).max() < TOL_GRAD, name


def test_no_bias_mode_matches_jax_kernel():
    q, k, v, _, do = _case(2, 600, 130, 64, None, seed=4)
    scale = 64**-0.5
    out_j, g_j = _jax(q, k, v, None, None, scale, do)
    out_p, g_p = _port(q, k, v, None, None, scale, do)
    assert np.abs(out_p - out_j).max() < TOL_FWD
    for name, a, b in zip(("dq", "dk", "dv"), g_p, g_j):
        assert np.abs(a - b).max() < TOL_GRAD, name


def test_plain_takes_any_expand_matrix():
    """The JAX kernel test's random 0/1 E: the plain versions take it; the
    kernels' E check refuses it."""
    r = np.random.default_rng(0)
    q, k, v, bias, do = _case(3, 72, 40, 24, 13, seed=1)
    e = (r.random((13, 40)) < 0.3).astype(np.float32)
    out_j, g_j = _jax(q, k, v, bias, e, 24**-0.5, do)
    out_p, g_p = _port(q, k, v, bias, e, 24**-0.5, do)
    assert np.abs(out_p - out_j).max() < TOL_FWD
    for a, b in zip(g_p, g_j):
        assert np.abs(a - b).max() < TOL_GRAD
    with pytest.raises(ValueError, match="rel_expand_matrix"):
        attention.kernel_grid(e, 40)
    assert attention.kernel_grid(attention.rel_expand_matrix(5, 8), 40) == (5, 8)
    assert attention.kernel_grid(attention.rel_expand_matrix(8, 5), 40) == (8, 5)


def test_bf16_plain_rounds_like_the_jax_kernel():
    """bf16 operands: the plain forward and backward round where the JAX
    kernel (interpret mode) rounds, so they agree to a bf16 ulp."""
    q, k, v, bias, do = _case(2, 64, 30, 32, 11, seed=3)
    scale = 32**-0.5
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    e = jax_expand(5, 6)
    f = lambda q, k, v, b: jax_fused(q, k, v, b, jnp.asarray(e), scale, False, True)
    out_j, vjp = jax.vjp(f, bf(q), bf(k), bf(v), bf(bias))
    g_j = vjp(bf(do))
    tb = lambda a: torch.from_numpy(np.array(bf(a).astype(jnp.float32))).to(torch.bfloat16)
    ts = [tb(a).requires_grad_() for a in (q, k, v, bias)]
    out_p = attention.fused_rel_attention(*ts[:3], ts[3], (5, 6), scale)
    out_p.backward(tb(do))
    assert out_p.dtype == torch.bfloat16
    as_np = lambda t: t.detach().float().numpy()
    ulp = lambda a: 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)
    ref = np.asarray(out_j.astype(jnp.float32))
    assert np.abs(as_np(out_p) - ref).max() <= ulp(ref)
    for t, g in zip(ts, g_j):
        ref = np.asarray(g.astype(jnp.float32))
        assert np.abs(as_np(t.grad) - ref).max() <= 2 * ulp(ref)


def test_two_part_backward_matches_the_one_pass_formula():
    """dkv's p and ds, rebuilt from dq's row statistics, are the one-pass ones."""
    q, k, v, bias, do = (torch.from_numpy(a) for a in _case(2, 40, 12, 16, 7, seed=5))
    qs = attention.scale_q(q, 0.25)
    dq, dbias, stats = attention.attention_bwd_dq_plain(qs, k, v, bias, (3, 4), 0.25, do)
    dk, dv = attention.attention_bwd_dkv_plain(qs, k, v, bias, (3, 4), do, stats)
    e = torch.from_numpy(attention.rel_expand_matrix(3, 4))
    p = torch.softmax(qs @ k.transpose(1, 2) + bias @ e, -1)
    torch.testing.assert_close(dv, p.transpose(1, 2) @ do, rtol=1e-5, atol=1e-6)
    ds = p * (do @ v.transpose(1, 2) - ((do @ v.transpose(1, 2)) * p).sum(-1, keepdim=True))
    torch.testing.assert_close(dk, ds.transpose(1, 2) @ qs, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dbias, ds @ e.T, rtol=1e-5, atol=1e-6)
    assert stats.shape == (2, 40, 3)


def _fwd_tile_model(qs, k, v, bias, grid, chunk: int = 16):
    """Torch (CPU, f32 arithmetic) model of the bf16 tensor-core forward
    (csrc/attention.cu attn_fwd_mma) in its tile order: pass A over 16-key
    chunks keeps the row max and the row sum online (the sum rescaled as the
    max grows); pass B recomputes each chunk's scores, normalises p =
    exp(s - m) * (1 / l), rounds it to bf16 and adds p v for the chunk with
    f32 sums; out is rounded to bf16. qs, k, v, bias are bf16."""
    qf, kf, vf = qs.float(), k.float(), v.float()
    lk = kf.shape[1]
    be = bias.float() @ torch.from_numpy(attention.rel_expand_matrix(*grid)) if grid else None

    def scores(kc):
        s = qf @ kf[:, kc:kc + chunk].transpose(1, 2)
        return s if be is None else s + be[..., kc:kc + chunk]

    m = torch.full(qf.shape[:2], -torch.inf)
    l = torch.zeros(qf.shape[:2])
    for kc in range(0, lk, chunk):
        s = scores(kc)
        mn = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - mn) + torch.exp(s - mn[..., None]).sum(-1)
        m = mn
    out = torch.zeros_like(qf)
    for kc in range(0, lk, chunk):
        p = (torch.exp(scores(kc) - m[..., None]) * (1.0 / l)[..., None]).to(torch.bfloat16).float()
        out = out + p @ vf[:, kc:kc + chunk]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize(
    "bh,lq,grid,d",
    [(3, 72, (5, 8), 24), (2, 78, (26, 3), 96), (2, 306, (51, 6), 96), (2, 64, None, 32)],
)
def test_bf16_forward_tile_model_matches_jax_and_plain(bh, lq, grid, d):
    """The tensor-core forward's two-pass tile order (the no-bias case with
    40 keys: a ragged last chunk) against JAX's fused_rel_attention(f32=False)
    in interpret mode and the plain forward, all in bf16, within 2 bf16 ulps
    of max|ref|."""
    lk = grid[0] * grid[1] if grid else 40
    q, k, v, bias, _ = _case(bh, lq, lk, d, sum(grid) if grid else None, seed=lq + d)
    scale = d**-0.5
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(np.array(bf(a).astype(jnp.float32))).to(torch.bfloat16)
    if grid:
        ref_j = jax_fused(bf(q), bf(k), bf(v), bf(bias), jnp.asarray(jax_expand(*grid)), scale, False, True)
    else:
        ref_j = jax_fused(bf(q), bf(k), bf(v), None, None, scale, False, True)
    qs = attention.scale_q(tb(q), scale)
    tbias = tb(bias) if grid else None
    got = _fwd_tile_model(qs, tb(k), tb(v), tbias, grid)
    plain = attention.attention_fwd_plain(qs, tb(k), tb(v), tbias, grid)
    assert got.dtype == plain.dtype == torch.bfloat16
    ulp = lambda a: 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)
    for ref in (np.asarray(ref_j.astype(jnp.float32)), plain.float().numpy()):
        assert got.shape == ref.shape == (bh, lq, d)
        assert np.abs(got.float().numpy() - ref).max() <= 2 * ulp(ref)


def _stream_steps(lk: int, chunk: int = 64, step: int = 16):
    """The (start, stop) key ranges of the streamed kernels' 16-key steps: the
    keys go through shared memory ``chunk`` at a time, and a step past the
    chunk's last key is skipped (a step's keys past Lk score -inf)."""
    for c0 in range(0, lk, chunk):
        valid = min(chunk, lk - c0)
        for kc in range(0, valid, step):
            yield c0 + kc, c0 + min(kc + step, valid)


def _stream_models(qs, k, v, do, scale, chunk: int = 64):
    """Torch (CPU, f32 arithmetic) models of the streamed bf16 kernels
    (attn_fwd_mma_stream, attn_bwd_dq_mma_stream; no bias) in their order:
    the keys in ``chunk``-key stages of 16-key steps; pass A keeps the row max
    and sum (and dq's rowsum(dp p)) online, pass B normalises p = exp(s - m) *
    (1 / l) and rounds p (forward) or ds = p (dp - delta) (dq) to bf16 before
    the product, with f32 sums. Returns (out, dq, [m, l, delta]) in bf16 /
    f32 as the kernels write them."""
    qf, kf, vf, dof = qs.float(), k.float(), v.float(), do.float()
    m = torch.full(qf.shape[:2], -torch.inf)
    l = torch.zeros(qf.shape[:2])
    u = torch.zeros(qf.shape[:2])
    steps = list(_stream_steps(k.shape[1], chunk))
    for a, b in steps:  # (A)
        s = qf @ kf[:, a:b].transpose(1, 2)
        dp = dof @ vf[:, a:b].transpose(1, 2)
        mn = torch.maximum(m, s.amax(-1))
        r = torch.exp(m - mn)
        e = torch.exp(s - mn[..., None])
        l, u, m = l * r + e.sum(-1), u * r + (dp * e).sum(-1), mn
    rl = 1.0 / l
    delta = u * rl
    out, dq = torch.zeros_like(qf), torch.zeros_like(qf)
    for a, b in steps:  # (B)
        p = torch.exp(qf @ kf[:, a:b].transpose(1, 2) - m[..., None]) * rl[..., None]
        out = out + p.to(torch.bfloat16).float() @ vf[:, a:b]
        ds = p * (dof @ vf[:, a:b].transpose(1, 2) - delta[..., None])
        dq = dq + ds.to(torch.bfloat16).float() @ kf[:, a:b]
    dq = (dq.to(torch.bfloat16).float() * scale).to(torch.bfloat16)
    return out.to(torch.bfloat16), dq, torch.stack([m, l, delta], -1)


def test_stream_steps_cover_every_key_once():
    for lk in (1, 16, 63, 64, 65, 129, 1214, 1217):
        keys = [j for a, b in _stream_steps(lk) for j in range(a, b)]
        assert keys == list(range(lk))
    assert list(_stream_steps(129))[-1] == (128, 129)  # a last chunk of one key


@pytest.mark.parametrize("bh,lq,lk", [(2, 150, 129), (3, 70, 200), (1, 40, 1214)])
def test_streamed_tile_models_match_jax_and_plain(bh, lq, lk):
    """The streamed forward's and dq's chunk order (64-key stages: at 129 keys
    a last stage of one key; at 1214, AST-base's key length) against JAX's
    fused_rel_attention(f32=False) in interpret mode and the plain versions,
    all in bf16: out within 2 and dq within 4 bf16 ulps of max|ref|, the row
    statistics within 1e-5."""
    d = 64
    q, k, v, _, do = _case(bh, lq, lk, d, None, seed=lk)
    scale = d**-0.5
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(np.array(bf(a).astype(jnp.float32))).to(torch.bfloat16)
    f = lambda q, k, v: jax_fused(q, k, v, None, None, scale, False, True)
    out_j, vjp = jax.vjp(f, bf(q), bf(k), bf(v))
    dq_j = vjp(bf(do))[0]
    qs = attention.scale_q(tb(q), scale)
    out, dq, stats = _stream_models(qs, tb(k), tb(v), tb(do), scale)
    plain_out = attention.attention_fwd_plain(qs, tb(k), tb(v), None, None)
    plain_dq, _, plain_stats = attention.attention_bwd_dq_plain(qs, tb(k), tb(v), None, None, scale, tb(do))
    ulp = lambda a: 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)
    for got, refs, ulps in ((out, (out_j, plain_out), 2), (dq, (dq_j, plain_dq), 4)):
        assert got.dtype == torch.bfloat16 and got.shape == (bh, lq, d)
        for ref in refs:
            ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref.astype(jnp.float32))
            assert np.abs(got.float().numpy() - ref).max() <= ulps * ulp(ref)
    torch.testing.assert_close(stats, plain_stats, rtol=1e-5, atol=1e-5)
