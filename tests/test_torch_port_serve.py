"""The port's serving slice as a whole (waveform -> log-mel -> AudioNTT ->
embedding) against the JAX package's ServingEncoder over an exported
StableHLO artifact of the same weights, in f32 on the CPU; plus the port's
artifact round trip and its CLI on a state_dict written in the format of
audiossl_tpu.models.torch_export. Then the transformer encoders behind the
Kaldi fbank (MAST-tiny with 4 blocks, AST-tiny with 2, 64 bins x 96 frames): the
port's artifacts against JAX's portable ``export_embedder`` on the same
variables (TOL_F32 = 1e-3 of max(1, max|ref|), the card-vs-CPU serving
bound), the CLI's ``--checkpoint`` on an SS-MAST run's checkpoint, and
``--config`` with seeded weights for every encoder type."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiossl_tpu.downstream.model import DownstreamModel as JaxDownstreamModel
from audiossl_tpu.frontend import FrontendSpec as JaxFrontendSpec
from audiossl_tpu.models import ast as jast
from audiossl_tpu.models import mast as jmast
from audiossl_tpu.models.mvit import MViTConfig as JaxMViTConfig
from audiossl_tpu.frontend.stft import LogMelConfig as JaxLogMelConfig
from audiossl_tpu.models.torch_export import ast_to_torch, audiontt_to_torch, mast_to_torch
from audiossl_tpu.serve.export import ServingEncoder as JaxServingEncoder
from audiossl_tpu.serve.export import export_embedder
from audiossl_tpu_torch.frontend import FrontendSpec
from audiossl_tpu_torch.models import ast as past
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.mvit import MViTConfig
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


# ---------------------------------------------------------------- MAST and AST behind the fbank

TOL_F32 = 1e-3  # relative to max(1, max|ref|)
FBANK = dict(n_mels=64, sample_rate=16000, target_length=96)
FB_CLIP = 16000  # 1 s: 98 Kaldi frames, cut to 96


@pytest.fixture
def short_tiny(monkeypatch):
    """AST-tiny with 2 blocks and MAST-tiny with 4 (one at each stage's
    start), on both sides, to keep the file quick."""
    tiny = jast.ASTConfig.tiny
    monkeypatch.setattr(jast.ASTConfig, "tiny", staticmethod(lambda: dataclasses.replace(tiny(), depth=2)))
    monkeypatch.setitem(past.VARIANTS, "tiny", lambda: past.ASTConfig.tiny(depth=2))
    monkeypatch.setitem(jmast.VARIANTS, "tiny", lambda **kw: JaxMViTConfig._variant(4, 0.1, (1, 2, 3), kw))
    monkeypatch.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw))


def _jax_fbank_served(encoder):
    """(JAX embeddings of the waves, reference-layout state_dict, waves) for a
    tiny ``encoder`` behind the fbank, exported at f32."""
    n_frames = FBANK["target_length"]
    model = JaxDownstreamModel(n_mels=64, d=0, num_classes=0, axis_name=None, encoder_type=encoder,
                               input_tdim=n_frames, model_size="tiny", compute_dtype=jnp.float32)
    variables = jax.jit(lambda k: model.init({"params": k}, jnp.zeros((1, 64, n_frames, 1)), False))(jax.random.key(5))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    enc = {"params": variables["params"]["encoder"]}
    grid_ft = (5, 9)  # (freq, time) patches of 64 x 96
    sd = mast_to_torch(enc) if encoder == "MAST" else ast_to_torch(enc, grid_ft)
    jenc = JaxServingEncoder(export_embedder(jax.tree_util.tree_map(jnp.asarray, variables), model,
                                             JaxFrontendSpec("fbank", **FBANK), FB_CLIP, platforms=("cpu",)))
    waves = (0.3 * np.random.default_rng(29).standard_normal((3, FB_CLIP))).astype(np.float32)
    return jenc(waves), {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, waves


@pytest.mark.parametrize("encoder", ["MAST", "AST"])
def test_fbank_serving_matches_jax(encoder, short_tiny, tmp_path):
    """The artifact records the encoder, its size, frames and dtype; served
    from the file it gives JAX's embeddings."""
    ref, sd, waves = _jax_fbank_served(encoder)
    emb = port.build_embedder(sd, FrontendSpec("fbank", **FBANK), FB_CLIP, torch.float32, "cpu", encoder, "tiny")
    path = str(tmp_path / "enc.pt")
    port.save_artifact(emb, path)
    art = port.load_artifact(path)
    assert (art["encoder_type"], art["model_size"], art["input_tdim"], art["compute_dtype"]) == (encoder, "tiny", 96, "f32")
    assert all(torch.equal(art["state_dict"][k], v) for k, v in sd.items())  # the reference layout
    got = port.ServingEncoder(path, bucket=2, device="cpu")(waves)
    assert got.shape == ref.shape and np.max(np.abs(got - ref)) <= TOL_F32 * max(1.0, float(np.abs(ref).max()))


def test_cli_serves_an_ssmast_checkpoint(short_tiny, tmp_path, capsys):
    """``--checkpoint`` on an SS-MAST run's checkpoint (MAST-tiny at 64 x 96,
    ``model_size`` at the pretrain level as configs/ssmast.yaml keeps it):
    the artifact serves the exported trunk behind the run's fbank."""
    import yaml

    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.train.checkpoint import save_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "ssmast.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"].update(model_size="tiny", num_negatives=64)
    cfg["pretrain"]["input"].update(n_mels=64, target_length=96)
    obj = init_objective("ssmast", cfg, seed=4)
    ckpt = str(tmp_path / "ssmast_chkp")
    save_checkpoint(ckpt, 2, {}, obj.export_state_dict(), cfg)
    out = str(tmp_path / "enc.pt")
    port.main(["--checkpoint", ckpt, "--out", out, "--dtype", "f32", "--clip_samples", str(FB_CLIP), "--device", "cpu",
               "--selftest"])
    assert "-> (3, 768) embeddings" in capsys.readouterr().out
    art = port.load_artifact(out)
    assert (art["encoder_type"], art["model_size"], art["frontend"]["kind"]) == ("MAST", "tiny", "fbank")
    waves = (0.3 * np.random.default_rng(31).standard_normal((2, FB_CLIP))).astype(np.float32)
    trunk = obj.encoder.mast.eval()
    trunk.cfg = dataclasses.replace(trunk.cfg, compute_dtype=None)  # f32, as served
    with torch.no_grad():
        want = trunk(build_frontend(cfg["pretrain"]["input"])(torch.from_numpy(waves))[:, None]).numpy()
    got = port.ServingEncoder(out, device="cpu")(waves)
    assert np.max(np.abs(got - want)) <= 1e-6 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("encoder", ["MAST", "AST", "Efficient_Net"])
def test_cli_seeded_weights_for_every_encoder(encoder, short_tiny, tmp_path, capsys):
    import yaml

    cfg = {"pretrain": {"base_encoder": {"type": encoder, "model_size": "tiny"},
                        "input": {"type": "fbank", "sampling_rate": 16000, "length_wave": 1.0, **FBANK}}}
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    outs = []
    for seed in (0, 0, 1):
        out = str(tmp_path / f"enc{len(outs)}.pt")
        port.main(["--config", path, "--seed", str(seed), "--out", out, "--device", "cpu"])
        outs.append(port.load_artifact(out)["state_dict"])
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    assert not all(torch.equal(outs[0][k], outs[2][k]) for k in outs[0])
    port.main(["--artifact", out, "--selftest", "--device", "cpu"])
    want = {"MAST": 768, "AST": 192, "Efficient_Net": 1280}[encoder]
    assert f"-> (3, {want}) embeddings" in capsys.readouterr().out
