"""The port's Kmix and MixGaussianNoise against the JAX package on the CPU,
with the same draws fed to both sides (taken from the JAX key splits): the
batched partner search against JAX's per-clip one (indices equal, at a
``top_k`` that cuts the eligible items and one that does not, on a bank
that is partly filled), the uniform fallback below ``top_k`` and the
identity on an empty bank, the Gaussian noise, and the pipeline's view order
Mixup -> Kmix -> noise -> crop."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from audiossl_tpu.data import augment as jaug
from audiossl_tpu_torch.data import augment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_, T_, N_BANK, K = 16, 12, 48, 7
TOL = 1e-5  # f32 on both sides


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0)


def bank_case(seed, fill, b=6):
    """A bf16 bank whose items fall around K centroids (time-averaged
    log-mel space), ``fill`` of its slots valid, and a batch x [b, 1, F, T]."""
    rng = np.random.default_rng(seed)
    centroids = rng.standard_normal((K, F_)).astype(np.float32)
    owner = rng.integers(0, K, N_BANK)
    bank = centroids[owner][:, :, None] + 0.3 * rng.standard_normal((N_BANK, F_, T_))
    bank = np.array(jnp.asarray(bank, jnp.bfloat16).astype(jnp.float32))  # the values a bf16 bank holds
    x = (centroids[rng.integers(0, K, b)][:, None, :, None] + 0.3 * rng.standard_normal((b, 1, F_, T_)))
    return centroids, bank, x.astype(np.float32), fill


def jax_draws(key, b, fill):
    """kmix's draws from ``key``, as jaug.kmix splits it: alpha [b], the
    uniform partner [b] and the Gumbel noise [b, N_BANK]."""
    ka, kz, kg = jax.random.split(key, 3)
    alpha = 0.4 * jax.random.uniform(ka, (b, 1, 1, 1))
    rand_idx = jax.random.randint(kz, (b,), 0, max(fill, 1))
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (N_BANK,)))(jax.random.split(kg, b))
    return np.array(alpha).reshape(b), np.array(rand_idx), np.array(gumbel)


def states(bank, fill):
    jstate = jaug.MixupBankState(jnp.asarray(bank, jnp.bfloat16), jnp.asarray(fill, jnp.int32),
                                 jnp.asarray(fill % N_BANK, jnp.int32))
    return jstate, augment.MixupBankState(torch.from_numpy(bank).to(torch.bfloat16), fill, fill % N_BANK)


@pytest.mark.parametrize("fill,top_k", [(40, 5), (40, 40), (N_BANK, 3)])
def test_kmix_partners_and_mix_match_jax(fill, top_k):
    centroids, bank, x, fill = bank_case(fill + top_k, fill)
    jstate, state = states(bank, fill)
    key = jax.random.key(fill * 7 + top_k)
    alpha, rand_idx, gumbel = jax_draws(key, len(x), fill)
    want_idx = [int(jaug.kmix_partner_index(jstate, jnp.asarray(xi), jnp.asarray(centroids), ki, top_k))
                for xi, ki in zip(x, jax.random.split(jax.random.split(key, 3)[2], len(x)))]
    got_idx = augment.kmix_partner_index(state, torch.from_numpy(x), torch.from_numpy(centroids),
                                         torch.from_numpy(gumbel), top_k)
    assert got_idx.tolist() == want_idx
    assert all(i < fill for i in want_idx)
    want = jaug.kmix(jstate, jnp.asarray(x), jnp.asarray(centroids), key, 0.4, True, top_k)
    got = augment.kmix(state, torch.from_numpy(x), torch.from_numpy(centroids), torch.from_numpy(alpha),
                       torch.from_numpy(rand_idx), torch.from_numpy(gumbel), True, top_k)
    _close(got.numpy(), want)


@pytest.mark.parametrize("fill", [0, 9])
def test_kmix_falls_back_below_top_k_and_is_identity_on_an_empty_bank(fill):
    centroids, bank, x, fill = bank_case(3, fill)
    jstate, state = states(bank, fill)
    key = jax.random.key(4)
    alpha, rand_idx, _ = jax_draws(key, len(x), fill)
    want = jaug.kmix(jstate, jnp.asarray(x), jnp.asarray(centroids), key, 0.4, True, 16)
    got = augment.kmix(state, torch.from_numpy(x), torch.from_numpy(centroids), torch.from_numpy(alpha),
                       torch.from_numpy(rand_idx), None, True, 16)  # no Gumbel draws below top_k
    _close(got.numpy(), want)
    if fill == 0:
        np.testing.assert_array_equal(got.numpy(), x)


def test_mix_gaussian_noise_matches_jax():
    x = np.random.default_rng(5).standard_normal((3, 1, F_, T_)).astype(np.float32)
    key = jax.random.key(6)
    kl, kn = jax.random.split(key)
    lambd = 0.3 * jax.random.uniform(kl, ())
    noise = jax.random.normal(kn, x.shape)
    want = jaug.mix_gaussian_noise(jnp.asarray(x), key, 0.3)
    got = augment.mix_gaussian_noise(torch.from_numpy(x), torch.tensor(float(lambd)), torch.from_numpy(np.array(noise)))
    _close(got.numpy(), want)


def test_pipeline_runs_mixup_kmix_noise_then_crop():
    """The pipeline's views equal the ops composed by hand in the JAX
    package's order, from the pipeline's own draws; the bank exists for Kmix
    alone (delores_s_kmix.yaml has no MixupBYOLA), and Kmix switches from
    the uniform fallback to the ranked search once the bank holds top_k."""
    with open(os.path.join(ROOT, "configs", "delores_s_kmix.yaml")) as f:
        pre = yaml.safe_load(f)["pretrain"]
    pre["augmentations"]["Kmix"]["top_k"] = 4
    pre["augmentations"]["MixGaussianNoise"] = {"ratio": 0.3}
    for with_mixup in (False, True):
        if with_mixup:
            pre["augmentations"]["MixupBYOLA"] = {"ratio": 0.4, "log_mixup_exp": True}
        cfg = augment.AugmentConfig.from_dict(pre)
        centroids = np.random.default_rng(7).standard_normal((K, F_)).astype(np.float32)
        with pytest.raises(ValueError, match="no centroids"):
            augment.AugmentPipeline(cfg, epoch_samples=100)
        pipe = augment.AugmentPipeline(cfg, epoch_samples=100, centroids=centroids)
        g = torch.Generator().manual_seed(8)
        state = pipe.init_state(F_, T_)
        assert state.mixup is not None
        for _ in range(2):  # the second step's first view takes the ranked search
            x = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 1, F_, T_)).astype(np.float32))
            draws = pipe.sample_draws(state, 4, F_, T_, g)
            bank_before = augment.MixupBankState(state.mixup.bank.clone(), state.mixup.fill, state.mixup.ptr)
            rn, xn = augment.running_norm_apply(state.running_norm, x)
            state, v1, _ = pipe(state, x, draws)
            d = draws[0]
            assert (d.kmix_gumbel is not None) == (bank_before.fill >= 4)
            want = xn
            if with_mixup:
                want = augment.mixup_byola(bank_before, want, d.mix_alpha, d.mix_index)
            want = augment.kmix(bank_before, want, torch.from_numpy(centroids), d.kmix_alpha, d.kmix_index,
                                d.kmix_gumbel, True, 4)
            want = augment.mix_gaussian_noise(want, d.noise_lambda, d.noise)
            want = augment.random_resize_crop(want, d.crop_boxes, cfg.virtual_crop_scale)
            torch.testing.assert_close(v1, want, rtol=0, atol=0)
        assert state.mixup.fill == 16
