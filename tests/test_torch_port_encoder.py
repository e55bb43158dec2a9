"""The port's AudioNTT encoder, DownstreamModel and weight conversion against
the JAX package, in f32 eval mode on the CPU. Weights come from the JAX
module's init with randomised biases, BN affines and running statistics
(var > 0), so the BN conversion is exercised; inputs are numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiossl_tpu.downstream.model import DownstreamModel as JaxDownstreamModel
from audiossl_tpu.models.audiontt import AudioNTT2020Task6 as JaxAudioNTT
from audiossl_tpu.models.audiontt import max_mean_pool as jax_max_mean_pool
from audiossl_tpu.models.torch_export import audiontt_to_torch
from audiossl_tpu_torch.downstream.model import DownstreamModel
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6, max_mean_pool, random_state_dict
from audiossl_tpu_torch.models.convert import audiontt_from_flax

N_MELS, D, CLIP = 64, 64, 6400
N_FRAMES = 1 + CLIP // 160  # 41 frames: odd sizes exercise the floor of each 2x2 pool
RNG = np.random.default_rng(5)


def _tol(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


def _randomise(tree):
    """Perturb every leaf of a flax variables tree (numpy), keeping BN var > 0."""
    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return RNG.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if "'kernel'" in name:
            return x
        return (x + 0.1 * RNG.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def jax_downstream():
    """(JAX DownstreamModel with a 5-class head on the final features, its
    randomised f32 variables)."""
    model = JaxDownstreamModel(
        n_mels=N_MELS, d=D, num_classes=5, axis_name=None, encoder_type="AudioNTT2020Task6",
        input_tdim=N_FRAMES, compute_dtype=jnp.float32,
    )
    dummy = jnp.zeros((2, N_MELS, N_FRAMES, 1), jnp.float32)
    variables = model.init({"params": jax.random.key(0)}, dummy, False)
    return model, _randomise(jax.tree_util.tree_map(np.asarray, dict(variables)))


def _encoder_vars(variables):
    return {"params": variables["params"]["encoder"], "batch_stats": variables["batch_stats"]["encoder"]}


def _features(b):
    return (2.0 * RNG.standard_normal((b, N_MELS, N_FRAMES, 1))).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))  # [B, F, T, 1] -> [B, 1, F, T]


def test_convert_equals_torch_export(jax_downstream):
    _, variables = jax_downstream
    enc = _encoder_vars(variables)
    ours, ref = audiontt_from_flax(enc), audiontt_to_torch(enc)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_state_dict_layout_loads_strict(jax_downstream):
    _, variables = jax_downstream
    model = AudioNTT2020Task6(n_mels=N_MELS, d=D)
    model.load_state_dict(audiontt_from_flax(_encoder_vars(variables)), strict=True)
    assert sorted(random_state_dict(N_MELS, D, seed=1)) == sorted(model.state_dict())


def test_audiontt_taps_and_features_match_jax(jax_downstream):
    _, variables = jax_downstream
    enc = _encoder_vars(variables)
    x = _features(3)
    ref = JaxAudioNTT(n_mels=N_MELS, d=D, return_all_layers=True, compute_dtype=jnp.float32).apply(
        enc, jnp.asarray(x), False
    )
    model = AudioNTT2020Task6(n_mels=N_MELS, d=D, return_all_layers=True, compute_dtype=torch.float32)
    model.load_state_dict(audiontt_from_flax(enc), strict=True)
    with torch.no_grad():
        ours = model.eval()(_nchw(x))
    assert [o.shape for o in ours] == [(3, 2048), (3, 1024), (3, 512), (3, N_FRAMES // 8, D)]
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert o.dtype == torch.float32
        assert np.max(np.abs(o.numpy() - r)) <= _tol(r)


@pytest.mark.parametrize("num_classes", [0, 5])
def test_downstream_matches_jax(jax_downstream, num_classes):
    jmodel, variables = jax_downstream
    x = _features(4)
    if num_classes == 0:
        jmodel = jmodel.clone(num_classes=0)
        variables = {"params": {"encoder": variables["params"]["encoder"]}, "batch_stats": variables["batch_stats"]}
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), False))
    model = DownstreamModel(N_MELS, D, num_classes, compute_dtype=torch.float32)
    model.encoder.load_state_dict(audiontt_from_flax(_encoder_vars(variables)), strict=True)
    if num_classes:
        final = variables["params"]["final"]
        model.final.load_state_dict(
            {"weight": torch.from_numpy(final["kernel"].T.copy()), "bias": torch.from_numpy(final["bias"])}
        )
    with torch.no_grad():
        ours = model.eval()(_nchw(x)).numpy()
    assert ours.shape == ref.shape == (4, num_classes or D)
    assert np.max(np.abs(ours - ref)) <= _tol(ref)


def test_max_mean_pool_matches_jax():
    x = RNG.standard_normal((3, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        max_mean_pool(torch.from_numpy(x)).numpy(), np.asarray(jax_max_mean_pool(jnp.asarray(x))), rtol=1e-6, atol=1e-6
    )


def test_training_mode_and_other_encoders_raise():
    """Training with dropout refuses to draw from the global generator (the
    training path itself is tests/test_torch_port_block1.py's); an encoder
    type that the JAX package's DownstreamModel does not have raises (all
    four of its encoders are ported)."""
    model = AudioNTT2020Task6(n_mels=N_MELS, d=D)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model.train()(torch.zeros((2, 1, N_MELS, N_FRAMES)))
    with pytest.raises(NotImplementedError, match="unknown downstream encoder"):
        DownstreamModel(N_MELS, D, 0, encoder_type="ResNet")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_path_runs_without_tf32(monkeypatch, dtype):
    """An f32 model runs its convs and linears with TF32 off (cuDNN enables it
    by default) and restores the caller's settings; bf16 leaves them alone."""
    seen = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy(torch.nn.functional.conv2d))
    monkeypatch.setattr(torch.nn.functional, "linear", spy(torch.nn.functional.linear))
    model = AudioNTT2020Task6(n_mels=N_MELS, d=D, compute_dtype=dtype).eval()
    with torch.no_grad():
        model(torch.zeros((1, 1, N_MELS, N_FRAMES)))
    assert len(seen) == 5
    assert set(seen) == {(False, False) if dtype == torch.float32 else (True, True)}
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
