"""Block 1's plain versions and the port's AudioNTT training path against the
JAX package on the CPU, in f32: ``fused_block1`` and ``block1_batch_stats``
run in Pallas interpret mode as tests/test_block1.py runs them. Inputs are
numpy from a seed; weights cross with ``audiontt_from_flax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiossl_tpu.models.audiontt import AudioNTT2020Task6 as JaxAudioNTT
from audiossl_tpu.ops.block1 import block1_batch_stats, block1_streams, fused_block1 as jax_fused_block1
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6
from audiossl_tpu_torch.models.convert import audiontt_from_flax
from audiossl_tpu_torch.ops import block1

F_, T_, C = 8, 12, 64
TOL_FWD = 1e-5  # forward and batch statistics: f32 on both sides, sums in another order
TOL_GRAD = 2e-4  # gradients: tests/test_block1.py's bound for the fused path's analytic backward


def _params(rng):
    kernel = (0.3 * rng.standard_normal((3, 3, 1, C))).astype(np.float32)  # flax HWIO, (time, freq)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return kernel, bias, gamma, beta


def _jax_block(x, kernel, bias, gamma, beta):
    """JAX fused block 1 on port-layout x [B, F, T] -> (pooled [B, C, F/2, T/2], mean, var)."""
    b, f, t = x.shape
    xe, xo, nv = block1_streams(jnp.asarray(x.transpose(0, 2, 1)), 128)
    mean, var = block1_batch_stats(xe, xo, nv, kernel, bias, f, interpret=True)
    out = jax_fused_block1(xe, xo, nv, kernel, bias, gamma, beta, mean, var, f, True, None, 128, True)
    return jnp.transpose(out.reshape(b, t // 2, f // 2, C), (0, 3, 2, 1)), mean, var


def _jax_grads(x, kernel, bias, gamma, beta, cot):
    def f(k, bi, g, be):
        return jnp.sum(_jax_block(x, k, bi, g, be)[0] * cot)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2, 3))(kernel, bias, gamma, beta)]


def _port_grads(x, kernel, bias, gamma, beta, cot):
    w = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 1, 0))).requires_grad_()
    ps = [w] + [torch.from_numpy(p).requires_grad_() for p in (bias, gamma, beta)]
    pooled, mean, var = block1.fused_block1(torch.from_numpy(x)[:, None], *ps)
    (pooled * torch.from_numpy(cot)).sum().backward()
    dk = ps[0].grad.numpy().transpose(3, 2, 1, 0)  # back to flax HWIO
    return pooled, mean, var, [dk] + [p.grad.numpy() for p in ps[1:]]


@pytest.mark.parametrize("b", [2, 4])
def test_forward_stats_and_grads_match_jax(b):
    rng = np.random.default_rng(b)
    x = rng.standard_normal((b, F_, T_)).astype(np.float32)
    kernel, bias, gamma, beta = _params(rng)
    cot = rng.standard_normal((b, C, F_ // 2, T_ // 2)).astype(np.float32)
    want, want_mean, want_var = _jax_block(x, kernel, bias, gamma, beta)
    pooled, mean, var, grads = _port_grads(x, kernel, bias, gamma, beta, cot)
    assert pooled.shape == (b, C, F_ // 2, T_ // 2)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(want), atol=TOL_FWD, rtol=TOL_FWD)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=TOL_FWD, rtol=TOL_FWD)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_var), atol=TOL_FWD, rtol=TOL_FWD)
    for name, got, ref in zip(("dW", "dbias", "dgamma", "dbeta"), grads, _jax_grads(x, kernel, bias, gamma, beta, cot)):
        np.testing.assert_allclose(got, ref, atol=TOL_GRAD, rtol=1e-4, err_msg=name)


def test_batch_stats_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, F_, T_)).astype(np.float32)
    kernel, bias, _, _ = _params(rng)
    xe, xo, nv = block1_streams(jnp.asarray(x.transpose(0, 2, 1)), 128)
    want = block1_batch_stats(xe, xo, nv, kernel, bias, F_, interpret=True)
    w = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 1, 0)))
    got = block1.batch_stats(torch.from_numpy(x)[:, None], w, torch.from_numpy(bias))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL_FWD, rtol=TOL_FWD)
    # the batch statistics of the conv output itself
    y = F.conv2d(torch.from_numpy(x)[:, None], w, torch.from_numpy(bias), padding=1)
    np.testing.assert_allclose(got[0].numpy(), y.mean((0, 2, 3)).numpy(), atol=TOL_FWD, rtol=TOL_FWD)
    np.testing.assert_allclose(got[1].numpy(), y.var((0, 2, 3), unbiased=False).numpy(), atol=TOL_FWD, rtol=TOL_FWD)


def test_max_ties_go_to_the_first_time_major_element():
    """Windows whose maximum is tied between (t0, f1) and (t1, f0): the JAX
    rule routes the gradient to (t0, f1), F.max_pool2d's (f, t) scan to
    (t1, f0). The port follows JAX, and the two rules give different dW."""
    b = 2
    rng = np.random.default_rng(3)
    window = np.array([[0.0, 1.0], [1.0, 0.5]], np.float32)  # [df, dt]
    x = np.tile(window, (b, F_ // 2, T_ // 2)) + np.zeros((b, F_, T_), np.float32)
    kernel = np.zeros((3, 3, 1, C), np.float32)
    kernel[1, 1, 0, :] = 1.0 + rng.uniform(0, 1, C)  # centre tap only: conv = scaled x, ties stay exact
    bias = np.zeros(C, np.float32)
    gamma = np.ones(C, np.float32)
    beta = np.full(C, 0.5, np.float32)  # every relu input positive at the tied maximum
    cot = rng.uniform(0.5, 1.5, (b, C, F_ // 2, T_ // 2)).astype(np.float32)
    _, _, _, grads = _port_grads(x, kernel, bias, gamma, beta, cot)
    ref = _jax_grads(x, kernel, bias, gamma, beta, cot)
    for name, got, r in zip(("dW", "dbias", "dgamma", "dbeta"), grads, ref):
        np.testing.assert_allclose(got, r, atol=TOL_GRAD, rtol=1e-4, err_msg=name)

    # the same block through F.max_pool2d's autograd routes elsewhere
    xt = torch.from_numpy(x)[:, None]
    w = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 1, 0))).requires_grad_()
    y = F.conv2d(xt, w, torch.from_numpy(bias), padding=1)
    yn = F.batch_norm(y, None, None, torch.from_numpy(gamma), torch.from_numpy(beta), training=True)
    (F.max_pool2d(F.relu(yn), 2, 2) * torch.from_numpy(cot)).sum().backward()
    dk_pool = w.grad.numpy().transpose(3, 2, 1, 0)
    assert np.abs(dk_pool - ref[0]).max() > 100 * TOL_GRAD


def test_input_that_requires_grad_raises():
    x = torch.zeros((2, 1, F_, T_), requires_grad=True)
    w = torch.zeros((C, 1, 3, 3), requires_grad=True)
    vec = torch.ones(C, requires_grad=True)
    with pytest.raises(ValueError, match="input gradient"):
        block1.fused_block1(x, w, vec, vec, vec)


def test_feasible_matches_jax():
    from audiossl_tpu.ops.block1 import feasible

    for t, f in [(96, 64), (12, 8), (20, 16), (41, 64), (96, 12), (96, 4), (10, 6)]:
        assert block1.feasible(t, f, 64) == feasible(t, f, 64), (t, f)


# ---------------------------------------------------------------- AudioNTT, training mode

B, D = 4, 32


@pytest.fixture(scope="module")
def jax_encoder():
    rng = np.random.default_rng(11)
    x = (2.0 * rng.standard_normal((B, F_, T_, 1))).astype(np.float32)
    model = JaxAudioNTT(n_mels=F_, d=D, return_all_layers=True, compute_dtype=jnp.float32, dropout_rate=0.0)
    variables = jax.tree_util.tree_map(np.asarray, dict(model.init({"params": jax.random.key(0)}, x, True)))

    def perturb(path, v):  # random biases, BN affines and running stats (var > 0)
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            return v
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    return x, jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.mark.parametrize("fused", [True, False])
def test_audiontt_train_mode_matches_jax(jax_encoder, fused):
    """Taps, features, updated running statistics and parameter gradients of
    one training forward, against the JAX module with the fused block 1 (in
    interpret mode) and with its plain conv block."""
    x, variables = jax_encoder
    model_j = JaxAudioNTT(
        n_mels=F_, d=D, return_all_layers=True, compute_dtype=jnp.float32, fused_block1=fused, dropout_rate=0.0
    )

    def loss_j(params):
        outs, upd = model_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x), True,
            mutable=["batch_stats"],
        )
        return sum(jnp.sum(o**2) for o in outs), (outs, upd["batch_stats"])

    (_, (outs_j, stats_j)), grads_j = jax.value_and_grad(loss_j, has_aux=True)(variables["params"])

    model = AudioNTT2020Task6(n_mels=F_, d=D, return_all_layers=True, compute_dtype=torch.float32, dropout_rate=0.0)
    model.load_state_dict(audiontt_from_flax(variables), strict=True)
    model.train()
    outs = model(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    sum((o**2).sum() for o in outs).backward()

    for o, r in zip(outs, outs_j):
        r = np.asarray(r)
        assert np.abs(o.detach().numpy() - r).max() <= 1e-4 * max(1.0, np.abs(r).max())
    updated = audiontt_from_flax({"params": variables["params"], "batch_stats": jax.tree_util.tree_map(np.asarray, stats_j)})
    state = model.state_dict()
    for k in updated:
        if "running" in k:
            np.testing.assert_allclose(state[k].numpy(), updated[k].numpy(), atol=1e-5, rtol=1e-5, err_msg=k)
    want = audiontt_from_flax({"params": jax.tree_util.tree_map(np.asarray, grads_j), "batch_stats": variables["batch_stats"]})
    for name, p in model.named_parameters():
        r = want[name].numpy()
        assert np.abs(p.grad.numpy() - r).max() <= TOL_GRAD * max(1.0, np.abs(r).max()), name


def test_train_mode_dropout_needs_a_generator():
    model = AudioNTT2020Task6(n_mels=F_, d=D, compute_dtype=torch.float32).train()
    x = torch.zeros((2, 1, F_, T_))
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    g = torch.Generator().manual_seed(0)
    a = model(x, generator=g)
    assert a.shape == (2, T_ // 8, D) and torch.isfinite(a).all()


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 0.0), (torch.bfloat16, 0.01)])
def test_block2_pool_tie_divergence_is_rare(dtype, bound):
    """Blocks 2 and 3 pool with F.max_pool2d, whose gradient goes to the first
    maximum in (f, t) order; the JAX module's XLA pool takes (t, f) order.
    They route differently only at a positive exact tie between (t0, f1) and
    (t1, f0) without (t0, f0): never in f32 on continuous data, and in bf16
    in under 1% of block 2's windows at seeded weights (ROADMAP.md Queue 3)."""
    from audiossl_tpu_torch.models.audiontt import batch_norm_train, random_state_dict

    model = AudioNTT2020Task6(n_mels=64, d=32, compute_dtype=dtype)
    model.load_state_dict(random_state_dict(64, 32, seed=0))
    model.train()
    x = torch.from_numpy((2.0 * np.random.default_rng(6).standard_normal((8, 1, 64, 96))).astype(np.float32)).to(dtype)
    with torch.no_grad():
        conv, bn = model.features_2[0], model.features_2[1]
        h = model._fused_block1(x)
        y = F.relu(batch_norm_train(bn, F.conv2d(h, conv.weight.to(dtype), conv.bias.to(dtype), padding=1)).to(dtype))
    y = y.float()
    _, idx = F.max_pool2d(y, 2, 2, return_indices=True)
    t = y.shape[3]
    torch_first = torch.stack([(idx // t) % 2, (idx % t) % 2], -1)  # (df, dt) of F.max_pool2d's choice
    win = torch.stack(block1._windows(y), -1)
    order = torch.tensor(block1.WINDOW_ORDER)
    jax_first = order[(win == win.amax(-1, keepdim=True)).float().argmax(-1)]  # the first maximum in JAX's order
    differ = (torch_first != jax_first).any(-1) & (win.amax(-1) > 0)
    assert float(differ.float().mean()) <= bound


# ---------------------------------------------------------------- the tensor-core backward design (CPU model)


def _split3(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's exact split of f32 d_conv into three bf16 terms (split3 in
    csrc/block1.cu): hi = bf16(d), mid = bf16(d - hi), lo = d - hi - mid."""
    hi = d.bfloat16().float()
    r = d - hi
    mid = r.bfloat16().float()
    return hi, mid, r - mid


def _bwd_tile_model(x, dp, params, weight: bool, nblk: int = 2, max_rows: int = 16) -> torch.Tensor:
    """The arithmetic of block1_bwd_mma_kernel in torch: items of (clip, R pooled
    rows) dealt to ``nblk`` persistent blocks in turn; in an item, groups of 16
    pooled positions, column pairs p, position base + 4 j + p (the fragment
    order); window elements in the time-major order. y_raw is the exact sum of
    the bf16 products and the bias rounded once to f32 (the tensor core keeps
    f32), bn one FMA; dp goes to the first element with bn = max(bn) when
    max(bn) > 0. The weight pass splits
    d_conv = k2 y_raw + (k3 + k1 dy) into three bf16 terms and contracts them
    with the patches exactly; dbias sums d_conv. Each block's partial row is
    summed in f32 in block order."""
    b_, _, f, t = x.shape
    c = params.shape[0]
    fp, tp = f // 2, t // 2
    r_ = min(max_rows, fp)
    tiles = -(-fp // r_)
    xp = F.pad(x[:, 0].double(), (1, 1, 1, 1))
    w = params[:, :9].double()
    bias, a, b2, k1, k2, k3 = (params[:, i] for i in range(9, 15))
    partial = torch.zeros((nblk, c, 10 if weight else 2), dtype=torch.float32)
    for item in range(b_ * tiles):
        b, p0 = item // tiles, (item % tiles) * r_
        npos = min(r_, fp - p0) * tp
        order = [base + 4 * j + p for base in range(0, npos, 16) for p in range(4) for j in range(4)]
        order = torch.tensor([q for q in order if q < npos])
        assert sorted(order.tolist()) == list(range(npos))  # the fragments cover each position once
        pr, q = order // tp + p0, order % tp
        patches = torch.stack([  # [n, 4 window elements, 9 taps]
            torch.stack([xp[b, 2 * pr + df + di, 2 * q + dt + dj] for di in range(3) for dj in range(3)], -1)
            for df, dt in block1.WINDOW_ORDER], 1)
        yr = (patches @ w.T + bias.double()).float()  # [n, 4, C]: the bias added in the tensor core, one rounding
        bn = (yr.double() * a.double() + b2.double()).float()  # one FMA
        mx = bn.amax(1)
        first = (bn == mx[:, None]).float().argmax(1)  # [n, C]
        dpe = torch.where(mx > 0, dp[b, :, pr, q].T.float(), 0.0)
        dy = torch.where(torch.arange(4)[None, :, None] == first[:, None], dpe[:, None], 0.0)
        if not weight:
            part = torch.stack([dy.double().sum((0, 1)), (dy.double() * yr.double()).sum((0, 1))], 1)
        else:
            k3t = torch.where(torch.arange(4)[None, :, None] == first[:, None], (k3 + k1 * dpe)[:, None], k3)
            dconv = (k2.double() * yr.double() + k3t.double()).float()  # one rounding, as fmaf
            terms = _split3(dconv)
            for v in terms:  # each term is a bf16
                assert torch.equal(v.bfloat16().float(), v)
            dsum = sum(v.double() for v in terms)  # d_conv again, exactly
            part = torch.cat([torch.einsum("nkc,nkt->ct", dsum, patches), dconv.double().sum((0, 1))[:, None]], 1)
        partial[item % nblk] += part.float()
    out = torch.zeros_like(partial[0])
    for blk in range(nblk):  # the ordered sum of the partials
        out += partial[blk]
    return out


def test_split3_reconstructs_f32_exactly():
    rng = np.random.default_rng(17)
    # exact wherever the terms are normal bf16 values: 2^-100 < |d| < 2^127 here
    mags = 10.0 ** rng.uniform(-30, 30, 4096)
    d = torch.from_numpy((rng.choice([-1.0, 1.0], 4096) * mags * rng.uniform(1, 2, 4096)).astype(np.float32))
    d = torch.cat([d, torch.tensor([0.0, -0.0, 1.0, -3.0, 2.0**-100, 1.0 - 2.0**-24, 2.0**127 * (1 - 2.0**-24)])])
    hi, mid, lo = _split3(d)
    for v in (hi, mid, lo):
        assert torch.equal(v.bfloat16().float(), v)  # each term is a bf16
    assert torch.equal(hi.double() + mid.double() + lo.double(), d.double())  # and they sum to d exactly
    one_term = d.bfloat16().float()  # a single bf16 would not
    assert not torch.equal(one_term, d)


@pytest.mark.parametrize("b,f,t,ties,jax_too", [(2, 8, 12, False, True), (2, 8, 12, True, True), (3, 16, 22, False, False)])
def test_bwd_tile_model_matches_plain_and_jax(monkeypatch, b, f, t, ties, jax_too):
    """The CPU model of the tensor-core backward design against the plain
    versions (the chip's bound, 1e-5 of max|plain|) and, through FusedBlock1,
    against JAX's fused_block1 backward in interpret mode (``jax_too``: at the
    shape the tests above compile, so that it costs no new compile). Inputs and weights are bf16 values (the training
    path's), held in f32 on both sides. (2, 8, 12) has 24 pooled positions a
    clip, a group and a half of 16; (3, 16, 22) 88, 5.5 groups, and 3 items
    over 2 blocks; the ties case routes exact ties to the first time-major
    element."""
    rng = np.random.default_rng(40 + b + f + t + ties)
    bf = lambda v: torch.from_numpy(np.asarray(v, np.float32)).bfloat16().float().numpy()
    if ties:
        window = np.array([[0.0, 1.0], [1.0, 0.5]], np.float32)
        x = np.tile(window, (b, f // 2, t // 2)).astype(np.float32)
        kernel = np.zeros((3, 3, 1, C), np.float32)
        kernel[1, 1, 0, :] = bf(1.0 + rng.uniform(0, 1, C))
        bias, gamma, beta = np.zeros(C, np.float32), np.ones(C, np.float32), np.full(C, 0.5, np.float32)
    else:
        x = bf(rng.standard_normal((b, f, t)))
        kernel, bias, gamma, beta = _params(rng)
        kernel = bf(kernel)
    cot = rng.standard_normal((b, C, f // 2, t // 2)).astype(np.float32)

    # each pass against its plain version, at the bound chip_smoke.py holds the kernels to
    w = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 1, 0)))
    xt = torch.from_numpy(x)[:, None]
    mean, var = block1.batch_stats(xt, w, torch.from_numpy(bias))
    a = torch.from_numpy(gamma) * torch.rsqrt(var + block1.BN_EPS)
    k = [torch.from_numpy(v.astype(np.float32)) for v in (1.0 + 0.1 * rng.standard_normal((3, C)) * [[1], [0.1], [0.01]])]
    params = block1.pack_params(w, torch.from_numpy(bias), a, torch.from_numpy(beta) - mean * a, *k)
    dp = torch.from_numpy(bf(cot))
    for weight, plain in ((False, block1.block1_bwd_sums_plain), (True, block1.block1_bwd_weight_plain)):
        got, want = _bwd_tile_model(xt, dp, params, weight), plain(xt, dp, params)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), weight

    if not jax_too:
        return
    # the model in FusedBlock1's backward against JAX
    monkeypatch.setattr(block1, "block1_bwd_sums", lambda x_, dp_, p_: _bwd_tile_model(x_, dp_, p_, False))
    monkeypatch.setattr(block1, "block1_bwd_weight", lambda x_, dp_, p_: _bwd_tile_model(x_, dp_, p_, True))
    _, _, _, grads = _port_grads(x, kernel, bias, gamma, beta, cot)
    for name, got, ref in zip(("dW", "dbias", "dgamma", "dbeta"), grads, _jax_grads(x, kernel, bias, gamma, beta, cot)):
        np.testing.assert_allclose(got, ref, atol=TOL_GRAD, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------- the tensor-core forward design (CPU model)


def _fwd_tile_model(x, params, max_rows: int = 16) -> torch.Tensor:
    """The arithmetic of block1_fwd_mma_kernel in torch: items of (clip, R pooled
    rows); in an item, groups of 16 pooled positions, n-tiles nt, column g =
    position base + 4 (g // 2) + 2 nt + g % 2 (the fragment order). The conv is
    a product with the whole 4 x 4 input patch: row (e, c) of W' holds channel
    c's 3 x 3 weights times the sign s of a at window element e's offset (df,
    dt), zeros elsewhere, and the tensor core gives the exact sum of the 16
    bf16 products rounded once to f32, s q. Then the window's max over the four
    rows e, fmaf(max, |a|, sh) with the shift sh = b2 + bias a rounded as the
    plain version rounds it (one rounding), relu and the rounding to x's dtype.
    The model checks that this is the same as fmaf(q, a, sh) of each window
    element and then the max."""
    b_, _, f, t = x.shape
    c = params.shape[0]
    fp, tp = f // 2, t // 2
    r_ = min(max_rows, fp)
    tiles = -(-fp // r_)
    xp = F.pad(x[:, 0].double(), (1, 1, 1, 1))
    bias, a, b2 = (params[:, i] for i in (9, 10, 11))
    sh = b2 + bias * a
    sign = torch.where(a < 0, -1.0, 1.0)
    w = (params[:, :9] * sign[:, None]).double().view(c, 3, 3)
    wp = torch.zeros((4, c, 4, 4), dtype=torch.float64)  # W' [window element, channel, patch row u, column v]
    for e, (df, dt) in enumerate(block1.WINDOW_ORDER):
        wp[e, :, df : df + 3, dt : dt + 3] = w
    out = torch.full((b_, c, fp, tp), float("nan"))
    for item in range(b_ * tiles):
        b, p0 = item // tiles, (item % tiles) * r_
        npos = min(r_, fp - p0) * tp
        order = [base + 4 * (g // 2) + 2 * nt + g % 2 for base in range(0, npos, 16) for nt in range(2) for g in range(8)]
        order = torch.tensor([q for q in order if q < npos])
        assert sorted(order.tolist()) == list(range(npos))  # the fragments cover each position once
        pr, q = order // tp + p0, order % tp
        patches = torch.stack([xp[b, 2 * pr + u, 2 * q + v] for u in range(4) for v in range(4)], -1)  # [n, 16]
        sq = torch.einsum("nk,eck->nec", patches, wp.reshape(4, c, 16)).float()  # exact products, one rounding
        got = (sq.amax(1).double() * a.abs().double() + sh.double()).float()
        # the plain order: each window element's fmaf(q, a, sh), then the max
        assert torch.equal(got, ((sq * sign).double() * a.double() + sh.double()).float().amax(1))
        out[b, :, pr, q] = got.clamp_min(0.0).T
    assert not out.isnan().any()
    return out.to(x.dtype)


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(v, 1e-30))) - 7)


@pytest.mark.parametrize("b,f,t,ties,jax_too", [(2, 8, 12, False, True), (2, 8, 12, True, True), (3, 16, 22, False, False)])
def test_fwd_tile_model_matches_plain_and_jax(monkeypatch, b, f, t, ties, jax_too):
    """The CPU model of the tensor-core forward design against the plain
    version in bf16 (the chip's bound, 1 bf16 ulp of max|plain|) and, as
    FusedBlock1's forward, against JAX's fused_block1 forward in interpret mode
    (``jax_too``: at a shape the tests above compile) at TOL_FWD, on bf16-valued
    f32 inputs. A third of the channels have a negative BN scale, so that the
    sign folded into the weights is -1 there. (2, 8, 12) has 24 pooled positions
    a clip, a group and a half of 16; (3, 16, 22) 88, 5.5 groups; the ties case
    has exact ties inside windows."""
    rng = np.random.default_rng(60 + b + f + t + ties)
    bf = lambda v: torch.from_numpy(np.asarray(v, np.float32)).bfloat16().float().numpy()
    if ties:
        window = np.array([[0.0, 1.0], [1.0, 0.5]], np.float32)
        x = np.tile(window, (b, f // 2, t // 2)).astype(np.float32)
        kernel = np.zeros((3, 3, 1, C), np.float32)
        kernel[1, 1, 0, :] = bf(1.0 + rng.uniform(0, 1, C))
        bias, gamma, beta = np.zeros(C, np.float32), np.ones(C, np.float32), np.full(C, 0.5, np.float32)
    else:
        x = bf(rng.standard_normal((b, f, t)))
        kernel, bias, gamma, beta = _params(rng)
        kernel = bf(kernel)
    gamma[::3] = -gamma[::3]

    w = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 1, 0)))
    xt = torch.from_numpy(x)[:, None]
    mean, var = block1.batch_stats(xt, w, torch.from_numpy(bias))
    a = torch.from_numpy(gamma) * torch.rsqrt(var + block1.BN_EPS)
    params = block1.pack_params(w, torch.from_numpy(bias), a, torch.from_numpy(beta) - mean * a, dtype=torch.bfloat16)
    assert (params[:, 10] < 0).sum() == C // 3 + 1
    xb = xt.bfloat16()
    got, want = _fwd_tile_model(xb, params), block1.block1_fwd_plain(xb, params)
    assert got.dtype == want.dtype == torch.bfloat16
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= _bf16_ulp(scale)

    if not jax_too:
        return
    # the model as FusedBlock1's forward, in f32, against JAX
    monkeypatch.setattr(block1, "block1_fwd", _fwd_tile_model)
    ps = [w] + [torch.from_numpy(p) for p in (bias, gamma, beta)]
    pooled, _, _ = block1.fused_block1(xt, *ps)
    want_j, _, _ = _jax_block(x, kernel, bias, gamma, beta)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_j), atol=TOL_FWD, rtol=TOL_FWD)
