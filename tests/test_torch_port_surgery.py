"""The port's checkpoint surgery (audiossl_tpu_torch.models.surgery) and its
cross-shape encoder handoff against the JAX package on the CPU, f32.

Each surgery function against JAX's at shrinking and growing grids and
tables (1e-6). Then MAST-tiny and AST-tiny checkpoints written in the
reference layout (JAX's ``mast_to_torch`` / ``ast_to_torch`` output as
``encoder/1.pt``, beside a ``config.yaml`` naming the upstream input) are
probed at another input shape: the port's ``probe.load_encoder`` against
JAX's ``load_pretrained_encoder`` on an orbax copy of the same variables,
then both ``DownstreamModel`` embeddings (1e-4 of max(1, max|ref|)). A
same-shape MAST handoff of an SS-MAST trunk reproduces the trunk's
embedding (1e-6), and the same handoff with the layout conversion skipped
misses it by far. The cross-shape MAST runs 4 blocks and AST 2, on both
sides, to keep the file quick; inputs are numpy from a seed."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from audiossl_tpu.downstream.model import DownstreamModel as JaxDownstreamModel
from audiossl_tpu.models import ast as jast
from audiossl_tpu.models import surgery as jsurgery
from audiossl_tpu.models import mast as jmast
from audiossl_tpu.models.mast import MASTEncoder as JaxMAST
from audiossl_tpu.models.mvit import MViTConfig as JaxMViTConfig
from audiossl_tpu.models.torch_export import ast_to_torch, mast_to_torch
from audiossl_tpu.train import checkpoint as jckpt
from audiossl_tpu_torch.downstream import probe
from audiossl_tpu_torch.downstream.model import DownstreamModel
from audiossl_tpu_torch.models import ast as past
from audiossl_tpu_torch.models import convert, surgery
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.mvit import MViTConfig

RNG = np.random.default_rng(17)
TOL_SURGERY = 1e-6  # relative to max(1, max|ref|): tables of N(0, 1) values, the two sides interpolate in other orders
TOL_EMB = 1e-4  # relative to max(1, max|ref|)


def _close(got, want, tol=TOL_EMB):
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("src,dst,prefix", [((9, 12), (5, 7), 2), ((4, 5), (9, 11), 2), ((12, 5), (6, 9), 0),
                                            ((7, 3), (7, 3), 2)])
def test_resize_grid_pos_embed_matches_jax(src, dst, prefix):
    """Cut both axes, grow both, cut one and grow the other, identity."""
    pos = RNG.standard_normal((1, prefix + src[0] * src[1], 8)).astype(np.float32)
    want = np.asarray(jsurgery.resize_grid_pos_embed(jnp.asarray(pos), src, dst, prefix))
    got = surgery.resize_grid_pos_embed(torch.from_numpy(pos), src, dst, prefix).numpy()
    assert got.shape == want.shape == (1, prefix + dst[0] * dst[1], 8)
    assert _close(got, want, TOL_SURGERY)
    with pytest.raises(ValueError, match="tokens"):
        surgery.resize_grid_pos_embed(torch.from_numpy(pos[:, 1:]), src, dst, prefix)


@pytest.mark.parametrize("old,new", [(23, 9), (9, 23), (17, 3), (3, 17), (5, 5), (1, 3)])
def test_resize_rel_pos_matches_jax(old, new):
    table = RNG.standard_normal((old, 16)).astype(np.float32)
    want = np.asarray(jsurgery.resize_rel_pos(jnp.asarray(table), new))
    got = surgery.resize_rel_pos(torch.from_numpy(table), new).numpy()
    assert got.shape == want.shape == (new, 16)
    assert _close(got, want, TOL_SURGERY)


def test_fold_and_token_grid_match_jax():
    hwio = RNG.standard_normal((16, 16, 3, 8)).astype(np.float32)
    want = np.asarray(jsurgery.fold_patch_proj_channels(jnp.asarray(hwio)))  # [16, 16, 1, 8]
    got = surgery.fold_patch_proj_channels(torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy())).numpy()
    assert _close(got.transpose(2, 3, 1, 0), want, TOL_SURGERY)
    for hw in ((1024, 128), (101, 64), (96, 48)):
        assert surgery.token_grid(hw) == jsurgery.token_grid(hw)


def test_transplant_counts_and_rules():
    """Copy, resize, fold and keep-fresh as JAX's transplant_variables does,
    with its counts, and a target key the source lacks counted missing."""
    target = {"pos_embed": torch.zeros(1, 2 + 6, 4), "a.rel_pos_h": torch.zeros(5, 4), "w": torch.zeros(3, 1, 2, 2),
              "same": torch.zeros(2), "fresh": torch.ones(3), "untouched": torch.ones(1)}
    source = {"pos_embed": torch.randn(1, 2 + 12, 4), "a.rel_pos_h": torch.randn(9, 4), "w": torch.randn(3, 3, 2, 2),
              "same": torch.randn(2), "fresh": torch.randn(4), "extra": torch.randn(7)}
    stats = {}
    out = surgery.transplant_state_dict(target, source, (3, 4), (2, 3), 2, stats)
    assert stats == {"copied": 1, "adapted": 3, "kept_fresh": 1, "missing": 1}
    assert set(out) == set(target) and torch.equal(out["same"], source["same"])
    assert torch.equal(out["fresh"], target["fresh"]) and torch.equal(out["untouched"], target["untouched"])
    assert torch.equal(out["w"], source["w"].sum(1, keepdim=True))
    assert out["pos_embed"].shape == (1, 8, 4) and out["a.rel_pos_h"].shape == (5, 4)


# ---------------------------------------------------------------- cross-shape handoff against JAX


def _jax_init(module, shape, seed):
    return jax.tree.map(np.asarray, jax.jit(lambda k: module.init({"params": k}, jnp.zeros(shape), False))(
        jax.random.key(seed)))


def _checkpoints(tmp_path, src_vars, ref_sd, n_mels, frames):
    """The same encoder as a port checkpoint (reference-layout encoder/1.pt
    and a config.yaml naming its input) and as a JAX orbax checkpoint."""
    port_dir, jax_dir = str(tmp_path / "port_chkp"), str(tmp_path / "jax_chkp")
    os.makedirs(os.path.join(port_dir, "encoder"))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in ref_sd.items()}, os.path.join(port_dir, "encoder", "1.pt"))
    with open(os.path.join(port_dir, "config.yaml"), "w") as f:
        yaml.safe_dump({"pretrain": {"input": {"type": "fbank", "sampling_rate": 16000, "n_mels": n_mels,
                                               "target_length": frames}}}, f)
    jckpt.save_encoder_only(jax_dir, 1, {"params": src_vars["params"]})
    return port_dir, jax_dir


def _handoff(tmp_path, encoder, src_fm, dst_fm, ref_sd_of, prefix):
    """(port embedding, JAX embedding, the port's model) after probing the
    src-shaped checkpoint at the dst shape."""
    (f0, t0), (f1, t1) = src_fm, dst_fm
    kw = dict(encoder_type=encoder, model_size="tiny")
    if encoder == "MAST":
        src_vars = _jax_init(JaxMAST(input_fdim=f0, input_tdim=t0, model_size="tiny", compute_dtype=None), (1, f0, t0, 1), 3)
    else:
        src_vars = _jax_init(jast.ASTEncoder(input_fdim=f0, input_tdim=t0, cfg=jast.ASTConfig.tiny()), (1, f0, t0, 1), 3)
    port_dir, jax_dir = _checkpoints(tmp_path, src_vars, ref_sd_of(src_vars, src_fm), f0, t0)

    jmodel = JaxDownstreamModel(n_mels=f1, d=0, num_classes=0, input_tdim=t1, compute_dtype=jnp.float32, **kw)
    # the target's shapes suffice: every tensor is copied or adapted (a kept-fresh one would stay a ShapeDtypeStruct)
    target = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(5)}, jnp.zeros((1, f1, t1, 1)), False))
    enc = jsurgery.load_pretrained_encoder(jax_dir, {"params": target["params"]["encoder"]}, src_input_hw=(t0, f0),
                                           dst_input_hw=(t1, f1), prefix_tokens=prefix)
    assert all(isinstance(leaf, np.ndarray | jax.Array) for leaf in jax.tree.leaves(enc))
    x = RNG.standard_normal((2, f1, t1, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), False))({"params": {"encoder": enc["params"]}}))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DownstreamModel(f1, 0, 0, input_tdim=t1, compute_dtype=torch.float32, **kw).eval()
    assert probe.load_encoder(model, port_dir, (t1, f1)).endswith("1.pt")
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    return got, want, model


@pytest.mark.parametrize("src_fm,dst_fm", [((64, 96), (48, 136))])
def test_mast_checkpoint_probed_at_another_shape_matches_jax(tmp_path, monkeypatch, caplog, src_fm, dst_fm):
    """A MAST-tiny checkpoint (4 blocks, one of each stage's start) of a
    9 x 5 grid probed at a 13 x 4 grid (the time axis grows, the frequency
    axis shrinks): every rel-pos table is resized, the rest copies, and the
    embedding is JAX's."""
    monkeypatch.setitem(jmast.VARIANTS, "tiny", lambda **kw: JaxMViTConfig._variant(4, 0.1, (1, 2, 3), kw))
    monkeypatch.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
    caplog.set_level("INFO", logger="audiossl_tpu_torch.downstream")
    got, want, _ = _handoff(tmp_path, "MAST", src_fm, dst_fm, lambda v, _: mast_to_torch(v), 0)
    assert "cross-shape encoder transplant" in caplog.text
    assert _close(got, want), float(np.abs(got - want).max())


def test_ast_checkpoint_probed_at_another_shape_matches_jax(tmp_path, monkeypatch, caplog):
    """An AST-tiny checkpoint (2 blocks) of a 9 x 4 (time x freq) grid probed
    at 5 x 5: the positional embedding is cut along time and interpolated
    along frequency, behind the cls and dist tokens."""
    tiny = jast.ASTConfig.tiny
    monkeypatch.setattr(jast.ASTConfig, "tiny", staticmethod(lambda: dataclasses.replace(tiny(), depth=2)))
    monkeypatch.setitem(past.VARIANTS, "tiny", lambda: past.ASTConfig.tiny(depth=2))
    caplog.set_level("INFO", logger="audiossl_tpu_torch.downstream")
    grid_ft = lambda fm: surgery.token_grid(fm[::-1])[::-1]
    got, want, _ = _handoff(tmp_path, "AST", (48, 96), (64, 64), lambda v, fm: ast_to_torch(v, grid_ft(fm)), 2)
    assert "cross-shape encoder transplant" in caplog.text
    assert _close(got, want), float(np.abs(got - want).max())


# ---------------------------------------------------------------- the SS-MAST trunk at its own shape


def _ssmast_checkpoint(tmp_path):
    """An SS-MAST (MAST-tiny, 64 x 96) objective's export as a port run
    writes it, with its config; returns (dir, trunk, a batch)."""
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.train.checkpoint import save_checkpoint

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "ssmast.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"].update(model_size="tiny", num_negatives=64, compute_dtype="f32")
    cfg["pretrain"]["input"].update(n_mels=64, target_length=96)
    obj = init_objective("ssmast", cfg, seed=2)
    ckpt_dir = str(tmp_path / "ssmast_chkp")
    save_checkpoint(ckpt_dir, 1, {}, obj.export_state_dict(), cfg)
    x = torch.from_numpy(RNG.standard_normal((2, 1, 64, 96)).astype(np.float32))
    return ckpt_dir, obj.encoder.mast.eval(), x


def _same_shape_embedding(ckpt_dir, x):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DownstreamModel(64, 0, 0, encoder_type="MAST", input_tdim=96, model_size="tiny",
                                compute_dtype=torch.float32).eval()
    probe.load_encoder(model, ckpt_dir, (96, 64))
    with torch.no_grad():
        return model(x)


def test_same_shape_mast_handoff_reproduces_the_ssmast_trunk(tmp_path, caplog):
    """The probe's MAST at the pretraining shape loads the SS-MAST export
    strictly (no transplant) and gives the trunk's own embedding."""
    ckpt_dir, trunk, x = _ssmast_checkpoint(tmp_path)
    caplog.set_level("INFO", logger="audiossl_tpu_torch.downstream")
    with torch.no_grad():
        want = trunk(x)
    got = _same_shape_embedding(ckpt_dir, x)
    assert "cross-shape" not in caplog.text
    assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))


def test_skipping_the_layout_conversion_is_caught(tmp_path, monkeypatch):
    """The same handoff with the reference -> port conversion skipped: the
    square 16 x 16 patch kernel and the 3 x 3 pooling kernels load
    untransposed, the swapped rel-pos tables go through the surgery, and the
    embedding misses the trunk's by far."""
    ckpt_dir, trunk, x = _ssmast_checkpoint(tmp_path)
    with torch.no_grad():
        want = trunk(x)
    monkeypatch.setattr(surgery, "port_layout", lambda sd, encoder_type, grid_ft=None: dict(sd))
    got = _same_shape_embedding(ckpt_dir, x)
    assert float((got - want).abs().max()) > 1e-2 * float(want.abs().max())


def test_conv_encoder_of_another_width_is_refused(tmp_path):
    """The surgery serves the transformer encoders only: an AudioNTT
    checkpoint of another width raises instead of keeping a random MLP."""
    from audiossl_tpu_torch.models.audiontt import random_state_dict

    os.makedirs(tmp_path / "encoder")
    torch.save(random_state_dict(64, 32), tmp_path / "encoder" / "3.pt")
    model = DownstreamModel(64, 48, 0)
    with pytest.raises(ValueError, match="surgery"):
        probe.load_encoder(model, str(tmp_path), (101, 64))


@pytest.mark.parametrize("encoder", ["AudioNTT2020Task6", "MAST"])
def test_checkpoint_missing_tensors_is_refused(tmp_path, encoder):
    """A checkpoint of the probe's own width that lacks tensors of its
    encoder (AudioNTT without its BatchNorm variances; MAST-tiny without
    its last block) raises instead of keeping them random; the full
    checkpoint loads."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        model = DownstreamModel(64, 48, 0, encoder_type=encoder, input_tdim=96, model_size="tiny")
    grid_ft = surgery.token_grid((96, 64))[::-1]
    full = convert.reference_layout(model.encoder.state_dict(), encoder, grid_ft)
    last = max(int(k.split(".")[1]) for k in full if k.startswith("blocks.")) if encoder == "MAST" else None
    cut = {k: v for k, v in full.items()
           if not (k.startswith(f"blocks.{last}.") if encoder == "MAST" else k.endswith("running_var"))}
    assert 0 < len(cut) < len(full)
    os.makedirs(tmp_path / "encoder")
    torch.save(cut, tmp_path / "encoder" / "1.pt")
    with pytest.raises(ValueError, match="at random"):
        probe.load_encoder(model, str(tmp_path), (96, 64))
    torch.save(full, tmp_path / "encoder" / "2.pt")
    assert probe.load_encoder(model, str(tmp_path), (96, 64)).endswith("2.pt")


def test_port_layout_round_trips():
    """port_layout inverts reference_layout for every encoder type."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        models = {t: DownstreamModel(48, 16, 0, encoder_type=t, input_tdim=64, model_size="tiny").encoder
                  for t in ("MAST", "AST", "AudioNTT2020Task6")}
    grid_ft = surgery.token_grid((64, 48))[::-1]
    for t, m in models.items():
        sd = m.state_dict()
        back = convert.port_layout(convert.reference_layout(sd, t, grid_ft), t, grid_ft)
        assert all(torch.equal(back[k], v) for k, v in sd.items()), t
