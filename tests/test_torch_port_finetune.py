"""The port's supervised MAST fine-tune pieces against the JAX package on the
CPU, on the same numpy inputs (from a seed), the same weights (carried over
with ``mast_classifier_from_flax``) and the draws JAX's own key splits make:
mAP / AUC / d' (1e-12, ties and classes with no positive included), the
multi-label loader, MAST noise (1e-6), the input pipeline (1e-5), the mixup
of waves and labels (1e-6), BCE (1e-6), the layer-decay scales and decay
masks of every parameter and two layer-decay AdamW updates with a clip that
engages (1e-6 of optax), and one whole step with every augmentation and drop
path on (loss 1e-5; gradients and updated parameters 1e-4 of max(1,
max|ref|)). MAST tiny at 64 mels x 48 frames cut to 4 blocks on both sides
(its four stages kept; the layer decay still takes the variant's nominal
depth of 10), f32, B = 4."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiossl_tpu.frontend.fbank import FbankConfig as JaxFbankConfig
from audiossl_tpu.frontend.fbank import kaldi_fbank as jax_kaldi_fbank
from audiossl_tpu.models import mast as jmast
from audiossl_tpu.models import mvit as jmvit
from audiossl_tpu.train import finetune_mast as jft
from audiossl_tpu.train import layer_decay as jld
from audiossl_tpu.utils import metrics as jmetrics
from audiossl_tpu_torch.data import augment
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.mvit import MViTConfig
from audiossl_tpu_torch.models.convert import mast_classifier_from_flax
from audiossl_tpu_torch.ops.masking import MaskDraws
from audiossl_tpu_torch.train import finetune_mast as ft
from audiossl_tpu_torch.train import layer_decay as ld
from audiossl_tpu_torch.utils import metrics

B, F_, T_, C = 4, 64, 48, 5
BLOCKS = 4
CLIP = 8000  # 0.5 s: 48 Kaldi frames
TOL_LOSS = 1e-5
TOL_STEP = 1e-4  # gradients and updated parameters, of max(1, max|ref|)
TOL_OPT = 1e-6
FT = {
    "model_size": "tiny", "freqm": 8, "timem": 16, "compute_dtype": "f32",
    "norm_stats": {"mean": -13.9, "std": 5.3},
    "input": {"type": "fbank", "sampling_rate": 16000, "length_wave": 0.5, "n_mels": F_, "target_length": T_,
              "mixup": 0.5, "noise": True},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread for these tiny models (the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def short_tiny():
    """MAST tiny with 4 blocks (a stage at each), on both sides."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmast.VARIANTS, "tiny", lambda **kw: jmvit.MViTConfig._variant(BLOCKS, 0.1, (1, 2, 3), kw))
        mp.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(BLOCKS, 0.1, (1, 2, 3), kw))
        yield


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _waves(seed, b=B):
    r = np.random.default_rng(seed)
    t = np.arange(CLIP) / 16000.0
    f0 = r.uniform(150, 900, (b, 1))
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * r.standard_normal((b, CLIP)) + 0.02).astype(np.float32)


def _targets(seed, b=B):
    t = (np.random.default_rng(seed).uniform(size=(b, C)) < 0.4).astype(np.float32)
    t[np.arange(b), np.arange(b) % C] = 1.0
    return t


def _jax_mask_draws(key, b, f, t, fp, tp):
    """The widths and starts jax's spec_mask_batch draws from ``key``."""
    out = {n: [] for n in ("fs", "fw", "ts", "tw")}
    for ki in jax.random.split(key, b):
        kf, kt = jax.random.split(ki, 2)
        for (ks, ws), k, size, p in ((("fs", "fw"), kf, f, fp), (("ts", "tw"), kt, t, tp)):
            kw_, ks_ = jax.random.split(k)
            w = int(jax.random.randint(kw_, (), 0, p + 1))
            out[ws].append(w)
            out[ks].append(int(jax.random.randint(ks_, (), 0, max(size - w, 0) + 1)))
    return MaskDraws(*(torch.tensor(out[n]) for n in ("fs", "fw", "ts", "tw")))


def _jax_noise_draws(key, shape):
    """MAST noise's draws from ``key`` (data/augment.py:mast_noise): scale,
    field and per-clip shifts in [-10, 10)."""
    kn, ks, kr = jax.random.split(key, 3)
    b = shape[0]
    scale = np.array(jax.random.uniform(ks, (b, 1, 1, 1))) / 10.0
    field = np.array(jax.random.uniform(kn, shape))
    shift = np.array(jax.random.randint(kr, (b,), -10, 10))
    return torch.from_numpy(scale.reshape(b)), torch.from_numpy(field), torch.from_numpy(shift).long()


def _jax_mix_draws(key, b, rate):
    """The waveform mixup's draws from ``key`` (finetune_mast.py:87-91)."""
    from audiossl_tpu_torch.frontend.fbank import WaveMixDraws

    kd, kp, kl = jax.random.split(key, 3)
    return WaveMixDraws(
        torch.from_numpy(np.array(jax.random.uniform(kd, (b, 1)) < rate)[:, 0]),
        torch.from_numpy(np.array(jax.random.randint(kp, (b,), 0, b))).long(),
        torch.from_numpy(np.array(jax.random.beta(kl, 10.0, 10.0, (b, 1)))[:, 0]),
    )


def _jax_input_draws(key, b):
    """The draws jax's _prepare_input takes from ``key`` in train mode: the
    mask key first, then the noise key."""
    key, k_mask = jax.random.split(key)
    _, k_noise = jax.random.split(key)
    return ft.InputDraws(_jax_mask_draws(k_mask, b, F_, T_, FT["freqm"], FT["timem"]),
                         _jax_noise_draws(k_noise, (b, 1, F_, T_)))


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("case", ["random", "ties", "empty_classes"])
def test_metrics_match_jax(case):
    r = np.random.default_rng(1)
    scores = r.uniform(size=(40, 7))
    targets = (r.uniform(size=(40, 7)) < 0.3).astype(np.float32)
    if case == "ties":  # ordinal ranks: tied scores rank in index order, on both sides
        scores = np.round(scores * 4) / 4
    if case == "empty_classes":  # no positive (class 2), no negative (class 5): skipped
        targets[:, 2], targets[:, 5] = 0.0, 1.0
    for name in ("mean_average_precision", "auc_roc"):
        got, want = getattr(metrics, name)(scores, targets), getattr(jmetrics, name)(scores, targets)
        assert abs(got - want) <= 1e-12, (name, got, want)
    auc = metrics.auc_roc(scores, targets)
    assert abs(metrics.d_prime(auc) - jmetrics.d_prime(auc)) <= 1e-12
    none = np.zeros((5, 3), np.float32)  # no class left: 0.0
    assert metrics.mean_average_precision(scores[:5, :3], none) == jmetrics.mean_average_precision(scores[:5, :3], none) == 0.0
    assert metrics.auc_roc(scores[:5, :3], none) == jmetrics.auc_roc(scores[:5, :3], none) == 0.0


# ---------------------------------------------------------------- the loader


def test_multilabel_loader_matches_jax(tmp_path):
    """The same batches and [B, C] float32 targets as the JAX loader for a
    seed; clips as long as the window, so no window is drawn. Train: shuffled,
    short batch dropped; eval: in order, short batch kept."""
    from audiossl_tpu.data.multilabel import multilabel_loader as jax_loader
    from audiossl_tpu_torch.data.multilabel import multilabel_loader
    from audiossl_tpu_torch.data.wav import write_wav

    mids = [f"/m/{i:02d}" for i in range(C)]
    with open(tmp_path / "labels.csv", "w") as f:
        f.write("index,mid,display_name\n" + "".join(f"{i},{m},class {i}\n" for i, m in enumerate(mids)))
    rows = []
    for i, w in enumerate(_waves(2, 10)):
        write_wav(str(tmp_path / f"c{i}.wav"), w)
        rows.append({"wav": str(tmp_path / f"c{i}.wav"), "labels": ",".join(mids[j] for j in {i % C, (3 * i) % C})})
    with open(tmp_path / "d.json", "w") as f:
        json.dump({"data": rows}, f)
    args = (str(tmp_path / "d.json"), str(tmp_path / "labels.csv"), 4, CLIP)
    for kw, n_batches in (({"seed": 5}, 2), ({"shuffle": False, "drop_last": False}, 3)):
        ours, n = multilabel_loader(*args, num_workers=2, **kw)
        ref, n_ref = jax_loader(*args, num_workers=1, **kw)
        assert n == n_ref == C and len(ours) == len(ref) == n_batches
        for epoch in (0, 1):
            got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) == n_batches
            for (w, t), (w_ref, t_ref) in zip(got, want):
                assert w.dtype == np.int16 and t.dtype == np.float32 and t.shape == (len(w), C)
                np.testing.assert_array_equal(w, np.asarray(w_ref))
                np.testing.assert_array_equal(t, np.asarray(t_ref))


# ---------------------------------------------------------------- augmentations and input


def test_mast_noise_matches_jax():
    from audiossl_tpu.data.augment import mast_noise as jax_mast_noise

    x = np.random.default_rng(3).standard_normal((B, 1, F_, T_)).astype(np.float32)
    key = jax.random.key(9)
    scale, field, shift = _jax_noise_draws(key, x.shape)
    assert int(shift.min()) >= -10 and int(shift.max()) < 10
    _close(augment.mast_noise(torch.from_numpy(x), scale, field, shift).numpy(),
           jax_mast_noise(jnp.asarray(x), key), 1e-6)
    # the port's own draws: shifts in [-10, 10), never +10; scale in [0, 0.1)
    s, f, sh = augment.sample_mast_noise(4000, (1, 2, 3), torch.Generator().manual_seed(0))
    assert int(sh.min()) == -10 and int(sh.max()) == 9 and float(s.max()) < 0.1 and f.shape == (4000, 1, 2, 3)


def test_pipeline_applies_mast_noise_last():
    """``input.noise`` builds (it raised before) and the noise comes after
    the precomputed norm: the view equals the noise applied to the normed,
    masked view."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "ssmast.yaml")) as f:
        pre = yaml.safe_load(f)["pretrain"]
    pre["input"]["noise"] = True
    cfg = augment.AugmentConfig.from_dict(pre)
    pipe = augment.AugmentPipeline(cfg, epoch_samples=8)
    state = pipe.init_state(F_, T_)
    d1, _ = pipe.sample_draws(state, B, F_, T_, torch.Generator().manual_seed(1))
    assert d1.mnoise.shape == (B, 1, F_, T_) and d1.mnoise_scale.shape == (B,) and d1.mnoise_shift.shape == (B,)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((B, 1, F_, T_)).astype(np.float32))
    got = pipe._one_view(None, x, d1)
    plain = pipe._one_view(None, x, d1._replace(mnoise_scale=torch.zeros(B), mnoise_shift=torch.zeros(B, dtype=torch.long)))
    torch.testing.assert_close(got, augment.mast_noise(plain, d1.mnoise_scale, d1.mnoise, d1.mnoise_shift), rtol=0, atol=0)


def test_prepare_input_matches_jax():
    """Train mode on JAX's mask and noise draws; eval mode (no mask, no
    noise). The fbank alone (port's plain version vs JAX's kaldi_fbank) is
    held at 1e-3, the features at 1e-5."""
    waves = _waves(6)
    fb = ft.frontend_spec(FT)(torch.from_numpy(waves)).numpy()
    ref_fb = np.swapaxes(np.asarray(jax_kaldi_fbank(jnp.asarray(waves), JaxFbankConfig(16000, F_))), -1, -2)
    _close(fb, ref_fb, 1e-3, "fbank")
    key = jax.random.key(12)
    want = np.asarray(jft._prepare_input(FT, jnp.asarray(waves), key, True)).transpose(0, 3, 1, 2)
    got = ft.prepare_input(FT, torch.from_numpy(waves), True, _jax_input_draws(key, B)).numpy()
    assert got.shape == (B, 1, F_, T_)
    _close(got, want, 1e-5, "train")
    want = np.asarray(jft._prepare_input(FT, jnp.asarray(waves), None, False)).transpose(0, 3, 1, 2)
    _close(ft.prepare_input(FT, torch.from_numpy(waves), False).numpy(), want, 1e-5, "eval")


def test_mixup_waves_and_labels_matches_jax():
    waves, targets = _waves(7), _targets(7)
    key = jax.random.key(1)
    draws = _jax_mix_draws(key, B, 0.5)
    assert draws.gate.any() and not draws.gate.all()
    w_ref, t_ref = jft.mixup_waves_and_labels(jnp.asarray(waves), jnp.asarray(targets), key, 0.5)
    w, t = ft.mixup_waves_and_labels(torch.from_numpy(waves), torch.from_numpy(targets), draws)
    _close(w.numpy(), w_ref, 1e-6)
    _close(t.numpy(), t_ref, 1e-6)


def test_bce_logits_matches_jax_and_torch():
    r = np.random.default_rng(8)
    logits = (6.0 * r.standard_normal((B, C))).astype(np.float32)
    targets = r.uniform(size=(B, C)).astype(np.float32)  # soft targets, as mixup makes them
    got = ft.bce_logits(torch.from_numpy(logits), torch.from_numpy(targets))
    assert abs(float(got) - float(jft.bce_logits(jnp.asarray(logits), jnp.asarray(targets)))) <= 1e-6
    want = torch.nn.BCEWithLogitsLoss()(torch.from_numpy(logits), torch.from_numpy(targets))
    assert abs(float(got) - float(want)) <= 1e-6


# ---------------------------------------------------------------- layer decay


def _jax_model(droppath=None):
    return jft.MASTClassifier(num_classes=C, input_fdim=F_, input_tdim=T_, model_size="tiny",
                              droppath_rate=droppath, compute_dtype=None)


_PARAMS = {}


def _jax_params():
    if "p" not in _PARAMS:
        dummy = jnp.zeros((2, F_, T_, 1), jnp.float32)
        _PARAMS["p"] = jax.jit(lambda k: _jax_model().init({"params": k}, dummy, False))(jax.random.key(0))["params"]
    return _PARAMS["p"]


def _port_model(params):
    model = ft.build_classifier(FT, C)
    model.load_state_dict(mast_classifier_from_flax(jax.tree.map(np.asarray, params)))
    return model


def test_layer_scales_and_decay_masks_match_jax_for_every_parameter():
    """Each flax leaf is filled with its own index, converted, and found again
    in the port's tensor it maps onto: that tensor's layer scale and decay
    flag must be JAX's for the leaf (the port's names, ``blocks.3.``, do not
    match JAX's regex ``block(\\d+)``)."""
    params = _jax_params()
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = jax.tree_util.tree_unflatten(treedef, [np.full(np.shape(v), i, np.float32) for i, (_, v) in enumerate(leaves)])
    sd = mast_classifier_from_flax(marked)
    model = ft.build_classifier(FT, C)
    model.load_state_dict(sd)  # strict: every key filled
    depth = ft.MVIT_DEPTH["tiny"]
    scales = jax.tree_util.tree_leaves(jld.layer_decay_mask(params, depth, 0.75))
    decays = jax.tree_util.tree_leaves(jld.weight_decay_mask(params))
    port_scales = ld.layer_decay_mask(model.named_parameters(), depth, 0.75)
    port_decays = ld.weight_decay_mask(model.named_parameters())
    seen = set()
    for name, t in sd.items():
        idx = int(t.flatten()[0])
        assert torch.all(t == idx), name
        seen.add(idx)
        assert port_scales[name] == scales[idx], (name, port_scales[name], scales[idx])
        assert port_decays[name] == decays[idx], (name, port_decays[name], decays[idx])
    assert seen == set(range(len(leaves)))
    # the patch embedding, each block, the head: scales of the nominal depth 10, not of the 4 blocks
    assert sorted({round(v, 12) for v in port_scales.values()}) == sorted(
        {round(0.75 ** (depth + 1 - i), 12) for i in [0, *range(1, BLOCKS + 1), depth + 1]})


def test_adamw_layer_decay_matches_optax_with_the_clip_engaged():
    """Two updates from gradients of global norm ~4e-4 clipped at 1e-4: the
    clipped gradients' elements sit near Adam's eps, where the clip's exact
    rule shows (clip_grad_norm_'s |g| + 1e-6 moves some updates by 5e-5 of
    the largest). The rate is 10, so that each update is large against the
    f32 spacing of the parameter it lands on, and each update is held to
    1e-6 of the largest."""
    params = _jax_params()
    depth = ft.MVIT_DEPTH["tiny"]
    tx = jld.adamw_layer_decay(10.0, params, depth=depth, layer_decay=0.75, weight_decay=0.05, clip_grad_norm=1e-4)
    opt_state = jax.jit(tx.init)(params)
    update = jax.jit(tx.update)
    model = _port_model(params)
    opt = ld.adamw_layer_decay(model.named_parameters(), 10.0, depth=depth, layer_decay=0.75, weight_decay=0.05,
                               clip_grad_norm=1e-4)
    r = np.random.default_rng(2)
    for _ in range(2):
        g = jax.tree.map(lambda v: (r.standard_normal(np.shape(v)) * 2e-6).astype(np.float32), params)
        assert float(optax.global_norm(g)) > 2e-4
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        updates, opt_state = update(g, opt_state, params)
        params = jax.jit(optax.apply_updates)(params, updates)
        gt = mast_classifier_from_flax(g)
        for n, p in model.named_parameters():
            p.grad = gt[n].clone()
        opt.step()
        want = mast_classifier_from_flax(jax.tree.map(np.asarray, params))
        ups = mast_classifier_from_flax(jax.tree.map(np.asarray, updates))
        largest = max(float(u.abs().max()) for u in ups.values())
        for n, p in model.named_parameters():
            err = float((p.detach() - before[n] - ups[n]).abs().max())
            assert err <= TOL_OPT * largest, (n, err, largest)
            _close(p.detach().numpy(), want[n].numpy(), TOL_OPT, n)


# ---------------------------------------------------------------- one step


def test_one_step_with_every_augmentation_matches_jax(monkeypatch):
    """One step of the fine-tune (mixup 0.5, SpecMask 8 / 16, the norm, MAST
    noise, drop path 0.1) from the same weights on JAX's draws: JAX's
    micro_loss as train_finetune_mast builds it, its drop path draws recorded
    where MViT makes them; then one layer-decay AdamW update on both sides."""
    params = _jax_params()
    waves, targets = _waves(21), _targets(21)
    key = jax.random.key(77)
    jmodel = _jax_model(droppath=None)
    recorded = []

    def recording_drop_path(x, rate, deterministic, rng):  # jmvit.drop_path, its uniform draws kept
        if deterministic or rate == 0.0:
            return x
        keep = 1.0 - rate
        u = jax.random.uniform(rng, (x.shape[0],) + (1,) * (x.ndim - 1))
        recorded.append(u.reshape(-1))
        return x / keep * jnp.floor(keep + u)

    def micro_loss(p, w, t, key):  # finetune_mast.py:192-200
        key, k_mix = jax.random.split(key)
        w, t = jft.mixup_waves_and_labels(w, t, k_mix, 0.5)
        key, k_drop = jax.random.split(key)
        x = jft._prepare_input(FT, w, key, True)
        logits = jmodel.apply({"params": p}, x, True, rngs={"dropout": k_drop})
        return jft.bce_logits(logits, t), tuple(recorded)

    monkeypatch.setattr(jmvit, "drop_path", recording_drop_path)
    (loss_j, drops), g_j = jax.jit(jax.value_and_grad(micro_loss, has_aux=True))(
        params, jnp.asarray(waves), jnp.asarray(targets), key)
    monkeypatch.undo()
    assert len(drops) == 2 * (BLOCKS - 1)  # block 0's rate is 0
    tx = jld.adamw_layer_decay(5e-4, params, depth=10, layer_decay=0.75, weight_decay=0.05, clip_grad_norm=1.0)
    new_j = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(g_j, params)

    key, k_mix = jax.random.split(key)
    k_inp, _ = jax.random.split(key)  # (the input's key, k_drop)
    draws = ft.StepDraws(_jax_mix_draws(k_mix, B, 0.5), _jax_input_draws(k_inp, B),
                         [torch.from_numpy(np.array(d)) for d in drops])
    model = _port_model(params).train()
    opt = ld.adamw_layer_decay(model.named_parameters(), 5e-4, depth=10, layer_decay=0.75, weight_decay=0.05,
                               clip_grad_norm=1.0)
    step = ft.FinetuneStep(model, opt, FT, torch.Generator().manual_seed(0))
    loss = step.loss_and_grads(torch.from_numpy(waves), torch.from_numpy(targets), [draws])
    assert abs(float(loss) - float(loss_j)) <= TOL_LOSS * abs(float(loss_j))
    ref_g = mast_classifier_from_flax(jax.tree.map(np.asarray, g_j))
    for n, p in model.named_parameters():
        _close(p.grad.numpy(), ref_g[n].numpy(), TOL_STEP, n)
    opt.step()
    ref_p = mast_classifier_from_flax(jax.tree.map(np.asarray, new_j))
    for n, p in model.named_parameters():
        _close(p.detach().numpy(), ref_p[n].numpy(), TOL_STEP, n)
