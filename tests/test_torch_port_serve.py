"""The port's serving slice as a whole (waveform -> log-mel -> AudioNTT ->
embedding) against the JAX package's ServingEncoder over an exported
StableHLO artifact of the same weights, in f32 on the CPU; plus the port's
artifact round trip and its CLI on a state_dict written in the format of
audiossl_tpu.models.torch_export."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiossl_tpu.downstream.model import DownstreamModel as JaxDownstreamModel
from audiossl_tpu.frontend.stft import LogMelConfig as JaxLogMelConfig
from audiossl_tpu.models.torch_export import audiontt_to_torch
from audiossl_tpu.serve.export import ServingEncoder as JaxServingEncoder
from audiossl_tpu.serve.export import export_embedder
from audiossl_tpu_torch.frontend import FrontendSpec
from audiossl_tpu_torch.models.convert import audiontt_from_flax
from audiossl_tpu_torch.serve import export as port

CLIP = 6400  # 0.4 s at 16 kHz keeps the CPU test cheap
D = 64
RNG = np.random.default_rng(13)


def _tol(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def served():
    """(JAX ServingEncoder, encoder variables as numpy, request waves)."""
    cfg = JaxLogMelConfig()
    n_frames = cfg.num_frames(CLIP)
    model = JaxDownstreamModel(
        n_mels=64, d=D, num_classes=0, axis_name=None, encoder_type="AudioNTT2020Task6",
        input_tdim=n_frames, compute_dtype=jnp.float32,
    )
    variables = model.init({"params": jax.random.key(3)}, jnp.zeros((2, 64, n_frames, 1)), False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    stats = variables["batch_stats"]["encoder"]
    for blk in stats.values():  # random running statistics, var > 0
        bn = blk["BatchNorm_0"]
        bn["mean"] = (0.3 * RNG.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = RNG.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    enc_vars = {"params": variables["params"]["encoder"], "batch_stats": stats}
    jenc = JaxServingEncoder(export_embedder(variables, model, cfg, CLIP, platforms=("cpu",)))
    waves = (0.3 * RNG.standard_normal((5, CLIP))).astype(np.float32)
    return jenc, enc_vars, waves


def _artifact(enc_vars, frontend=FrontendSpec("logmel", 64, 16000)):
    emb = port.build_embedder(audiontt_from_flax(enc_vars), frontend, CLIP, torch.float32, "cpu")
    return emb.artifact()


@pytest.mark.parametrize("mode", ["bucket", "fixed_batch"])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_serving_matches_jax(served, mode, n):
    jenc, enc_vars, waves = served
    enc = port.ServingEncoder(_artifact(enc_vars), **{mode: 4}, device="cpu")
    ref = jenc(waves[:n])
    got = enc(waves[:n])
    assert got.shape == ref.shape == (n, D) and got.dtype == np.float32
    assert np.max(np.abs(got - ref)) <= _tol(ref)


def test_artifact_round_trip(served, tmp_path):
    _, enc_vars, waves = served
    path = str(tmp_path / "enc.pt")
    spec = FrontendSpec("logmel", 64, 16000)
    emb = port.build_embedder(audiontt_from_flax(enc_vars), spec, CLIP, torch.float32, "cpu")
    port.save_artifact(emb, path)
    art = port.load_artifact(path)
    assert art["clip_samples"] == CLIP and art["compute_dtype"] == "f32"
    enc = port.ServingEncoder(path, device="cpu")
    assert enc.embedder.frontend == spec
    with torch.no_grad():
        want = emb(torch.from_numpy(waves)).numpy()
    np.testing.assert_array_equal(enc(waves), want)
    with pytest.raises(ValueError, match="expected waves"):
        enc(waves[:, :-1])


def test_cli_on_torch_export_state_dict(served, tmp_path, capsys):
    jenc, enc_vars, waves = served
    pth, out = str(tmp_path / "encoder.pth"), str(tmp_path / "enc.pt")
    # the file `python -m audiossl_tpu.models.torch_export --arch audiontt` writes
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in audiontt_to_torch(enc_vars).items()}, pth)
    port.main(["--state_dict", pth, "--out", out, "--dtype", "f32", "--clip_samples", str(CLIP),
               "--device", "cpu", "--selftest"])
    assert f"-> (3, {D}) embeddings" in capsys.readouterr().out
    port.main(["--artifact", out, "--selftest", "--device", "cpu"])
    assert "selftest OK" in capsys.readouterr().out
    ref = jenc(waves[:2])
    got = port.ServingEncoder(out, device="cpu")(waves[:2])
    assert np.max(np.abs(got - ref)) <= _tol(ref)
