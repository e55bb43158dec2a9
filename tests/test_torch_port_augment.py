"""The port's augmentations against the JAX package on the CPU, in f32, with
the same draws fed to both sides (numpy from a seed): RunningNorm, bicubic
crop-resize, log-mixup-exp, the mixup ring bank, the config parser and the
whole delores_s AugmentPipeline."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from audiossl_tpu.data import augment as jaug
from audiossl_tpu.ops import resize as jresize
from audiossl_tpu.ops import stats as jstats
from audiossl_tpu_torch.data import augment
from audiossl_tpu_torch.ops import resize, stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_, T_ = 16, 24
TOL = 1e-5  # f32 on both sides, sums in another order


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0)


def test_running_norm_matches_jax_across_batches_and_past_the_cap():
    rng = np.random.default_rng(0)
    ours, ref = stats.running_norm_init(1, max_update_epochs=10), jstats.running_norm_init(1, max_update_epochs=10)
    for i in range(5):  # batches of 4 cross the cap of 10 samples in the third batch
        x = (3.0 + 2.0 * rng.standard_normal((4, 1, F_, T_))).astype(np.float32)
        ours, y = stats.running_norm_apply(ours, torch.from_numpy(x))
        ref, y_ref = jstats.running_norm_apply(ref, jnp.asarray(x))
        assert ours.n == int(ref.n) == min(4 * (i + 1), 10)
        _close(ours.mean, ref.mean)
        _close(ours.var, ref.var)
        _close(y.numpy(), y_ref)


def test_normalize_and_l2_match_jax():
    x = np.random.default_rng(1).standard_normal((3, 1, F_, T_)).astype(np.float32)
    _close(stats.normalize_batch(torch.from_numpy(x)).numpy(), jstats.normalize_batch(jnp.asarray(x)))
    _close(stats.l2_normalize(torch.from_numpy(x)).numpy(), jstats.l2_normalize(jnp.asarray(x)))


def _boxes(rng, b, ch, cw):
    h = rng.integers(1, ch + 1, b)
    w = rng.integers(1, cw + 1, b)
    i = np.array([rng.integers(0, ch - hh + 1) for hh in h])
    j = np.array([rng.integers(0, cw - ww + 1) for ww in w])
    return np.stack([i, j, h, w], 1)


def test_crop_resize_matches_jax():
    rng = np.random.default_rng(2)
    ch, cw = F_, int(T_ * 1.5)
    boxes = _boxes(rng, 6, ch, cw)
    canvas = rng.standard_normal((6, 1, ch, cw)).astype(np.float32)
    got = resize.crop_resize_2d(torch.from_numpy(canvas), torch.from_numpy(boxes), (F_, T_)).numpy()
    for k, (i, j, h, w) in enumerate(boxes):
        _close(
            resize.crop_resize_matrix(T_, torch.tensor(j), torch.tensor(w), cw).numpy(),
            jresize.crop_resize_matrix(T_, jnp.int32(j), jnp.int32(w), cw),
        )
        _close(got[k], jresize.crop_resize_2d(jnp.asarray(canvas[k]), tuple(jnp.int32(v) for v in (i, j, h, w)), (F_, T_)))


def test_sampled_boxes_lie_in_the_canvas():
    g = torch.Generator().manual_seed(0)
    boxes = resize.sample_crop_boxes(512, 64, 96, g).numpy()
    i, j, h, w = boxes.T
    assert (h >= 1).all() and (h <= 64).all() and (w >= 1).all() and (w <= 144).all()
    assert (i >= 0).all() and (i + h <= 64).all() and (j >= 0).all() and (j + w <= 144).all()
    assert h.min() >= int(0.6 * 64) and w.min() >= int(0.6 * 96)
    assert h.max() == 64 and (h == 64).mean() > 0.3  # 1.5 F is clipped to the canvas height F


def test_log_mixup_exp_matches_jax():
    rng = np.random.default_rng(3)
    xa, xb = rng.standard_normal((2, 3, 1, F_, T_)).astype(np.float32)
    alpha = rng.uniform(0, 1, (3, 1, 1, 1)).astype(np.float32)
    _close(
        augment.log_mixup_exp(*(torch.from_numpy(a) for a in (xa, xb, alpha))).numpy(),
        jaug.log_mixup_exp(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(alpha)),
    )


def test_mixup_bank_ring_wraps_like_jax():
    rng = np.random.default_rng(4)
    ours, ref = augment.mixup_bank_init(5, F_, T_), jaug.mixup_bank_init(5, F_, T_)
    for _ in range(4):
        x = rng.standard_normal((3, 1, F_, T_)).astype(np.float32)
        ours = augment.mixup_bank_push(ours, torch.from_numpy(x))
        ref = jaug.mixup_bank_push(ref, jnp.asarray(x))
        assert (ours.fill, ours.ptr) == (int(ref.fill), int(ref.ptr))
        assert ours.bank.dtype == torch.bfloat16
        np.testing.assert_array_equal(ours.bank.float().numpy(), np.asarray(ref.bank.astype(jnp.float32)))


def _delores_pretrain():
    with open(os.path.join(ROOT, "configs", "delores_s.yaml")) as f:
        return yaml.safe_load(f)["pretrain"]


def test_config_parses_like_jax():
    pre = _delores_pretrain()
    assert dataclasses.asdict(augment.AugmentConfig.from_dict(pre)) == dataclasses.asdict(jaug.AugmentConfig.from_dict(pre))
    assert [f.name for f in dataclasses.fields(augment.AugmentConfig)] == [f.name for f in dataclasses.fields(jaug.AugmentConfig)]


@pytest.mark.parametrize(
    "extra,match",
    [({"MixGaussianNoise": {"ratio": 0.3}}, "MixGaussianNoise"), ({"input": {"noise": True}}, "MAST noise"),
     ({"Kmix": {"centroid_path": "c.npy"}}, "Kmix")],
)
def test_options_of_later_slices_raise(extra, match):
    """MAST noise, Kmix and MixGaussianNoise, all ported, build; MAST noise
    is applied last in a view; Kmix raises, as in JAX, when no centroids are
    given (tests/test_torch_port_kmix.py holds Kmix and MixGaussianNoise
    against JAX, tests/test_torch_port_finetune.py MAST noise)."""
    pre = _delores_pretrain()
    if "input" in extra:
        pre["input"].update(extra["input"])
    else:
        pre["augmentations"].update(extra)
    cfg = augment.AugmentConfig.from_dict(pre)
    if match == "MAST noise":
        pipe = augment.AugmentPipeline(cfg, epoch_samples=8)
        assert pipe.cfg.mast_noise
        state = pipe.init_state(F_, T_)
        draws, _ = pipe.sample_draws(state, 2, F_, T_, torch.Generator().manual_seed(0))
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, F_, T_)).astype(np.float32))
        quiet = draws._replace(mnoise_scale=torch.zeros(2), mnoise_shift=torch.zeros(2, dtype=torch.long))
        want = augment.mast_noise(pipe._one_view(state.mixup, x, quiet), draws.mnoise_scale, draws.mnoise,
                                  draws.mnoise_shift)
        torch.testing.assert_close(pipe._one_view(state.mixup, x, draws), want, rtol=0, atol=0)
    elif match == "Kmix":
        with pytest.raises(ValueError, match="no centroids"):
            augment.AugmentPipeline(cfg, epoch_samples=8)
        assert augment.AugmentPipeline(cfg, epoch_samples=8, centroids=np.zeros((3, F_))).cfg.kmix_ratio == 0.4
    else:
        assert augment.AugmentPipeline(cfg, epoch_samples=8).cfg.gaussian_ratio == 0.3


def _jax_view(bank, fill, x, alpha, index, boxes):
    """One view from the JAX cores: mixup with the given partner and weight,
    then each clip's crop of the centred canvas."""
    if fill > 0:
        z = bank[jnp.asarray(index)].astype(x.dtype)[:, None]
        x = jaug.log_mixup_exp(x, z, 1.0 - jnp.asarray(alpha).reshape(-1, 1, 1, 1))
    ch, cw = F_, int(T_ * 1.5)
    y0, x0 = 0, (cw - T_) // 2
    out = []
    for k, (i, j, h, w) in enumerate(boxes):
        canvas = jnp.zeros((1, ch, cw), x.dtype).at[:, y0 : y0 + F_, x0 : x0 + T_].set(x[k])
        out.append(jresize.crop_resize_2d(canvas, tuple(jnp.int32(v) for v in (i, j, h, w)), (F_, T_)))
    return jnp.stack(out)


def test_pipeline_with_injected_draws_matches_jax_cores():
    """Two steps of the delores_s pipeline (the second mixes against the
    bank the first filled) against the JAX cores composed in the same order."""
    cfg = dataclasses.replace(augment.AugmentConfig.from_dict(_delores_pretrain()), n_memory=6)
    pipe = augment.AugmentPipeline(cfg, epoch_samples=3)
    state = pipe.init_state(F_, T_)
    rn, bank = jstats.running_norm_init(2 * 3), jaug.mixup_bank_init(6, F_, T_)
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(5)
    for _ in range(2):
        x = (1.0 + rng.standard_normal((4, 1, F_, T_))).astype(np.float32)
        draws = pipe.sample_draws(state, 4, F_, T_, g)
        state, v1, v2 = pipe(state, torch.from_numpy(x), draws)

        rn, xn = jstats.running_norm_apply(rn, jnp.asarray(x))
        ref = []
        for d in draws:
            ref.append(_jax_view(bank.bank, int(bank.fill), xn, d.mix_alpha.numpy(), d.mix_index.numpy(), d.crop_boxes.numpy()))
            bank = jaug.mixup_bank_push(bank, xn)
        _close(v1.numpy(), ref[0])
        _close(v2.numpy(), ref[1])
        assert (state.mixup.fill, state.mixup.ptr) == (int(bank.fill), int(bank.ptr))
        # the banks hold bf16 roundings of x that agree to 1e-7: within one bf16 ulp
        ours = state.mixup.bank.float().numpy()
        np.testing.assert_allclose(ours, np.asarray(bank.bank.astype(jnp.float32)), rtol=2.0**-7, atol=1e-30)
        # the next step mixes against the same bank on both sides
        bank = bank._replace(bank=jnp.asarray(ours).astype(jnp.bfloat16))
    assert state.running_norm.n == int(rn.n) == 8
    assert int(rn.max_update) == state.running_norm.max_update == 60


# ---------------------------------------------------------------- SS-MAST augmentations


def _jax_mask_draws(key, b, f, t, fp, tp):
    """The widths and starts jax's spec_mask_batch draws from ``key``
    (ops/masking.py: per clip, split in two, each axis split into width and start)."""
    import jax

    out = {n: [] for n in ("fs", "fw", "ts", "tw")}
    for ki in jax.random.split(key, b):
        kf, kt = jax.random.split(ki, 2)
        for (ks, ws), k, size, p in ((("fs", "fw"), kf, f, fp), (("ts", "tw"), kt, t, tp)):
            kw_, ks_ = jax.random.split(k)
            w = int(jax.random.randint(kw_, (), 0, p + 1))
            out[ws].append(w)
            out[ks].append(int(jax.random.randint(ks_, (), 0, max(size - w, 0) + 1)))
    from audiossl_tpu_torch.ops.masking import MaskDraws

    return MaskDraws(*(torch.tensor(out[n]) for n in ("fs", "fw", "ts", "tw")))


def test_spec_mask_then_precomputed_norm_matches_jax():
    """One SS-MAST view: SpecMask (freq 48, time 192 at 128 x 1024 in the
    config; 6 and 9 here) with JAX's own draws, then (x - mean) / (2 std)."""
    import jax

    from audiossl_tpu.ops.masking import spec_mask_batch as jax_spec_mask
    from audiossl_tpu_torch.ops.masking import spec_mask

    x = np.random.default_rng(3).standard_normal((5, 1, F_, T_)).astype(np.float32)
    key = jax.random.key(7)
    draws = _jax_mask_draws(key, 5, F_, T_, 6, 9)
    want = np.asarray(jax_spec_mask(jnp.asarray(x), key, freq_param=6, time_param=9))
    got = spec_mask(torch.from_numpy(x), draws)
    _close(got.numpy(), want, 1e-6)
    assert (want == 0).any()
    with open(os.path.join(ROOT, "configs", "ssmast.yaml")) as f:
        pre = yaml.safe_load(f)["pretrain"]
    cfg = augment.AugmentConfig.from_dict(pre)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jaug.AugmentConfig.from_dict(pre))
    assert (cfg.spec_mask_freq, cfg.spec_mask_time, cfg.normalization, cfg.wave_mixup_rate) == (48, 192, "precomputed", 0.5)
    pipe = augment.AugmentPipeline(cfg, epoch_samples=8)
    view = pipe._one_view(None, torch.from_numpy(x), augment.ViewDraws(None, None, None, draws))
    _close(view.numpy(), np.asarray(jstats.precomputed_norm(jnp.asarray(want), cfg.norm_mean, 2 * cfg.norm_std)), 1e-6)
    # the port's own draws: widths within the parameters, spans inside the grid
    from audiossl_tpu_torch.ops.masking import sample_mask_draws

    d = sample_mask_draws(1000, 128, 1024, 48, 192, torch.Generator().manual_seed(0))
    assert int(d.f_width.max()) == 48 and int(d.t_width.max()) == 192 and int(d.f_width.min()) == 0
    assert bool(((d.f_start + d.f_width) <= 128).all() and ((d.t_start + d.t_width) <= 1024).all())


def test_waveform_mixup_matches_jax():
    import jax

    from audiossl_tpu.frontend.fbank import batch_waveform_mixup as jax_mix
    from audiossl_tpu_torch.frontend.fbank import WaveMixDraws, batch_waveform_mixup, sample_wave_mixup

    b, n = 6, 4000
    w = (0.3 * np.random.default_rng(5).standard_normal((b, n)) + 0.05).astype(np.float32)
    key = jax.random.key(11)
    kd, kp, kl = jax.random.split(key, 3)  # jax's draws (frontend/fbank.py:156-160)
    draws = WaveMixDraws(
        torch.from_numpy(np.array(jax.random.uniform(kd, (b, 1)) < 0.5)[:, 0]),
        torch.from_numpy(np.array(jax.random.randint(kp, (b,), 0, b))).long(),
        torch.from_numpy(np.array(jax.random.beta(kl, 10.0, 10.0, (b, 1)))[:, 0]),
    )
    assert draws.gate.any() and not draws.gate.all()
    _close(batch_waveform_mixup(torch.from_numpy(w), draws).numpy(), jax_mix(jnp.asarray(w), key, 0.5), 1e-6)
    # the port's Beta(10, 10) draws: mean 1/2, variance 1/84
    lam = sample_wave_mixup(20000, 0.5, torch.Generator().manual_seed(1)).lam
    assert abs(float(lam.mean()) - 0.5) < 0.005 and abs(float(lam.var()) - 1 / 84) < 0.001
