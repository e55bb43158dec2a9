"""The encoder options and the ``torch.export`` serving artifact of the port
against the JAX package, on the CPU; f32, inputs numpy from a seed.

* MViT with ``use_abs_pos`` and ``dropout_rate > 0`` (MAST tiny's widths, 2
  blocks, 64 x 96 input), in training mode on the same dropout mask (JAX's
  ``jax.random.bernoulli`` handed the mask the port takes as ``pos_keep``):
  the tokens within 1e-4 of max(1, max|ref|), each gradient (the position
  embedding's included) within 1e-3 of its own max|ref| + 1e-5 of the
  largest; ``cls_embed_on`` raises on both sides;
* DeLoRes-S on ``Efficient_Net`` (EfficientNet-Barlow, projection 32, 4
  clips): the loss 1e-5 relative and each gradient by the same bound, on
  the same stochastic-depth draws, and the running statistics 1e-5;
* serve/export.py's ``torch.export`` artifacts: the portable program (a
  symbolic batch) and the native one (a fixed batch, the log-mel custom op)
  against JAX's portable artifact of the same weights within 1e-4 of
  max(1, max|ref|) (test_torch_port_serve.py's bound), and against the
  port's module path bit for bit; the CLI writes and serves both.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from audiossl_tpu.downstream.model import DownstreamModel as JaxDownstreamModel
from audiossl_tpu.frontend.stft import LogMelConfig as JaxLogMelConfig
from audiossl_tpu.models import mvit as jmvit
from audiossl_tpu.objectives.delores_s import DeloresS as JaxDeloresS
from audiossl_tpu.serve.export import ServingEncoder as JaxServingEncoder
from audiossl_tpu.serve.export import export_embedder
from audiossl_tpu_torch.frontend import FrontendSpec
from audiossl_tpu_torch.models import convert
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.efficientnet import EfficientNetB0
from audiossl_tpu_torch.models.mvit import MViT, MViTConfig
from audiossl_tpu_torch.objectives import init_objective
from audiossl_tpu_torch.serve import export as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(2025)
F, T = 64, 96


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads_close(got, want, rel=1e-3, of_largest=1e-5):
    largest = max(float(np.abs(w).max()) for w in want.values())
    return [n for n, w in want.items()
            if not np.abs(np.asarray(got[n]) - w).max() <= rel * np.abs(w).max() + of_largest * largest]


# ---------------------------------------------------------------- MViT: use_abs_pos, dropout


def _mvit_cfgs(**kw):
    jcfg = jmvit.MViTConfig._variant(2, 0.0, (1,), dict(fused_attention="off", **kw))
    pcfg = MViTConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(MViTConfig)})
    return jcfg, pcfg


def test_mvit_abs_pos_and_dropout_step_matches_jax(monkeypatch):
    rate = 0.25
    jcfg, pcfg = _mvit_cfgs(use_abs_pos=True, dropout_rate=rate)
    jm = jmvit.MViT(jcfg, input_hw=(T, F), in_chans=1, final_norm=False)
    x = RNG.standard_normal((2, T, F, 1)).astype(np.float32)
    params = jax.jit(lambda k: jm.init({"params": k, "dropout": k}, jnp.asarray(x), False))(jax.random.key(1))["params"]
    params = jax.tree.map(np.asarray, params)
    n_tokens, width = params["pos_embed"].shape[1:]
    keep = RNG.random((2, n_tokens, width)) < 1.0 - rate
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(keep).reshape(shape))
    shape = jax.eval_shape(lambda p: jm.apply({"params": p}, jnp.asarray(x), False), params).shape
    out_g = RNG.standard_normal(shape).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), True, rngs={"dropout": jax.random.key(2)})
        return jnp.sum(out * out_g), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    to_port = lambda tree: convert.mvit_reference_layout(convert.mast_from_flax({"params": {"mvit": tree}}))  # noqa: E731
    model = MViT(pcfg, input_hw=(T, F), final_norm=False).train()
    model.load_state_dict(to_port(params), strict=True)
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2), pos_keep=torch.from_numpy(keep))
    (out * torch.from_numpy(out_g)).sum().backward()
    want = np.asarray(out_j)
    assert np.abs(out.detach().numpy() - want).max() <= 1e-4 * max(1.0, float(np.abs(want).max()))
    want_g = {k: v.numpy() for k, v in to_port(jax.tree.map(np.asarray, g_j)).items()}
    got_g = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g) and "pos_embed" in got_g
    assert not _grads_close(got_g, want_g)
    # the mask matters: another one moves the output
    other = model(torch.from_numpy(x).permute(0, 3, 1, 2), pos_keep=torch.from_numpy(~keep))
    assert np.abs(other.detach().numpy() - want).max() > 1e-2


def test_mvit_draws_its_dropout_mask_and_refuses_cls_embed():
    _, pcfg = _mvit_cfgs(use_abs_pos=True, dropout_rate=0.5)
    model = MViT(pcfg, input_hw=(T, F), final_norm=False).train()
    x = torch.from_numpy(RNG.standard_normal((2, 1, T, F)).astype(np.float32))
    with pytest.raises(ValueError, match="needs a generator"):
        model(x)
    a = model(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, model(x, torch.Generator().manual_seed(0)))
    assert not torch.equal(a, model(x, torch.Generator().manual_seed(1)))
    assert torch.equal(model.eval()(x), model(x))  # eval: no dropout
    jcfg, pcfg = _mvit_cfgs(cls_embed_on=True)
    with pytest.raises(NotImplementedError, match="cls_embed_on"):
        MViT(pcfg, input_hw=(T, F))
    with pytest.raises(NotImplementedError, match="cls_embed_on"):
        jmvit.MViT(jcfg, input_hw=(T, F)).init(jax.random.key(0), jnp.zeros((1, T, F, 1)), False)


# ---------------------------------------------------------------- DeLoRes-S on EfficientNet


def test_delores_s_on_efficientnet_matches_jax(monkeypatch):
    with open(os.path.join(ROOT, "configs", "delores_s.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"]["base_encoder"].update(type="Efficient_Net", compute_dtype="float32")
    cfg["pretrain"]["projection_dim"] = 32
    jobj = JaxDeloresS(cfg, axis_name=None)
    v1, v2 = ((1.5 * RNG.standard_normal((4, F, T, 1))).astype(np.float32) for _ in range(2))
    params, bs, _ = jax.jit(jobj.init)(jax.random.key(0), (jnp.asarray(v1), jnp.asarray(v2)))
    params, bs = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bs)
    n_draws = sum(blk.draws for blk in EfficientNetB0()._blocks)
    draws = RNG.uniform(size=(2 * n_draws, 4)).astype(np.float32)
    draws[0, 1] = draws[n_draws + 2, 3] = 0.999  # above every keep probability: these samples drop the block
    it = iter(draws)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(next(it)).reshape(shape) < p)
    (loss_j, aux), g_j = jax.jit(jax.value_and_grad(
        lambda p: jobj.loss(p, bs, (), (jnp.asarray(v1), jnp.asarray(v2)), jax.random.key(1), True, None),
        has_aux=True))(params)

    def port_sd(p, stats):
        sd = {f"encoder.{k}": v for k, v in convert.efficientnet_from_flax(
            {"params": p["encoder"], "batch_stats": stats["encoder"]}).items()}
        sd.update({f"projector.{k}": v for k, v in convert.projection_from_flax(p["projector"], stats["projector"]).items()})
        return sd

    obj = init_objective("delores_s", cfg, seed=0).train()
    obj.load_state_dict(port_sd(params, bs), strict=True)
    port_draws = iter(torch.from_numpy(draws))
    forward = EfficientNetB0.forward
    monkeypatch.setattr(obj.encoder, "forward", lambda x, generator=None: forward(obj.encoder, x, draws=port_draws))
    loss = obj.loss(torch.from_numpy(v1).permute(0, 3, 1, 2), torch.from_numpy(v2).permute(0, 3, 1, 2))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = {k: v.numpy() for k, v in port_sd(jax.tree.map(np.asarray, g_j), bs).items()
            if "running" not in k and "num_batches" not in k}
    got = {n: p.grad.numpy() for n, p in obj.named_parameters()}
    assert set(got) == set(want) and not _grads_close(got, want)
    stats = port_sd(params, jax.tree.map(np.asarray, aux.batch_stats))
    for k, v in stats.items():
        if "running" in k:
            np.testing.assert_allclose(obj.state_dict()[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)
    assert obj.export_state_dict().keys() == EfficientNetB0().state_dict().keys()


# ---------------------------------------------------------------- torch.export serving

CLIP = 6400
D = 64


@functools.lru_cache(maxsize=1)
def _served():
    """JAX's portable artifact of a seeded AudioNTT (d = 64, random running
    statistics) behind the log-mel, its weights in the reference layout, and
    request waves."""
    cfg = JaxLogMelConfig()
    n_frames = cfg.num_frames(CLIP)
    model = JaxDownstreamModel(n_mels=64, d=D, num_classes=0, axis_name=None, encoder_type="AudioNTT2020Task6",
                               input_tdim=n_frames, compute_dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, dict(model.init({"params": jax.random.key(5)}, jnp.zeros((2, 64, n_frames, 1)),
                                                         False)))
    for blk in variables["batch_stats"]["encoder"].values():
        bn = blk["BatchNorm_0"]
        bn["mean"] = (0.3 * RNG.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = RNG.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    jenc = JaxServingEncoder(export_embedder(variables, model, cfg, CLIP, platforms=("cpu",)))
    sd = convert.audiontt_from_flax({"params": variables["params"]["encoder"],
                                     "batch_stats": variables["batch_stats"]["encoder"]})
    return jenc, sd, (0.3 * RNG.standard_normal((7, CLIP))).astype(np.float32)


@pytest.mark.parametrize("impl", ["portable", "native"])
def test_exported_program_matches_jax_and_the_module_path(impl, tmp_path):
    """Requests of 1, 3 and 7 clips: the portable program at each batch (a
    symbolic batch), the native one padded and chunked to its batch of 4;
    the native program holds the log-mel as one custom-op node, the portable
    one none; the artifact's weights are the ones exported."""
    jenc, sd, waves = _served()
    emb = port.build_embedder(sd, FrontendSpec("logmel", 64, 16000), CLIP, torch.float32, "cpu")
    path = str(tmp_path / f"{impl}.pt2")
    port.save_exported(emb.artifact(), path, impl, batch=4)
    art = port.load_artifact(path)
    assert (art["frontend_impl"], art["batch"], art["encoder_type"]) == (impl, 4 if impl == "native" else None,
                                                                         "AudioNTT2020Task6")
    assert set(art["state_dict"]) == set(sd) and all(torch.equal(art["state_dict"][k], v) for k, v in sd.items())
    nodes = [n for n in art["program"].graph.nodes if "audiossl_torch" in str(n.target)]
    assert len(nodes) == (1 if impl == "native" else 0)
    enc = port.ServingEncoder(path, device="cpu")
    assert enc.embedder is None and enc.fixed_batch == (4 if impl == "native" else None)
    module = port.ServingEncoder(emb.artifact(), fixed_batch=enc.fixed_batch, device="cpu")  # the same batches
    for n in (1, 3, 7):
        got, ref = enc(waves[:n]), jenc(waves[:n])
        assert got.shape == ref.shape == (n, D)
        assert np.abs(got - ref).max() <= 1e-4 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_array_equal(got, module(waves[:n]))


def test_export_cli_writes_and_serves_both_programs(tmp_path, capsys):
    from audiossl_tpu_torch.models.audiontt import random_state_dict

    sd_path = str(tmp_path / "encoder.pth")
    torch.save(random_state_dict(64, 32, 0), sd_path)
    cfg = str(tmp_path / "cfg.yaml")
    with open(os.path.join(ROOT, "configs", "delores_s.yaml")) as f:
        c = yaml.safe_load(f)
    c["pretrain"]["base_encoder"]["output_dim"] = 32
    with open(cfg, "w") as f:
        yaml.safe_dump(c, f)
    outs = {}
    for impl in ("portable", "native"):
        outs[impl] = str(tmp_path / f"{impl}.pt2")
        port.main(["--state_dict", sd_path, "--config", cfg, "--out", outs[impl], "--frontend_impl", impl,
                   "--batch", "2", "--clip_samples", str(CLIP), "--dtype", "f32", "--device", "cpu"])
        port.main(["--artifact", outs[impl], "--selftest", "--device", "cpu"])
        assert "selftest OK: [3, 6400] waves -> (3, 32) embeddings" in capsys.readouterr().out
    waves = (0.2 * RNG.standard_normal((3, CLIP))).astype(np.float32)
    a, b = (port.ServingEncoder(outs[i], device="cpu")(waves) for i in ("portable", "native"))
    np.testing.assert_array_equal(a, b)


def test_fbank_encoders_export_as_portable_programs(tmp_path):
    """MAST tiny (2 blocks) behind the Kaldi fbank: native is the portable
    computation (no log-mel kernel to embed, as in JAX) at its fixed batch;
    both equal the module path."""
    from audiossl_tpu_torch.models.mvit import MViTConfig as PConfig

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(pmast.VARIANTS, "tiny", lambda **kw: PConfig._variant(2, 0.1, (1,), kw))
        spec = FrontendSpec("fbank", 64, 16000, 96)
        sd = port.seeded_state_dict("MAST", "tiny", 64, 96, 0, 3)
        emb = port.build_embedder(sd, spec, 16000, torch.float32, "cpu", "MAST", "tiny")
        waves = (0.2 * RNG.standard_normal((3, 16000))).astype(np.float32)
        for impl, batch in (("portable", None), ("native", 2)):
            path = str(tmp_path / f"{impl}.pt2")
            port.save_exported(emb.artifact(), path, impl, batch=2)
            art = port.load_artifact(path)
            assert not [n for n in art["program"].graph.nodes if "audiossl_torch" in str(n.target)]
            want = port.ServingEncoder(emb.artifact(), fixed_batch=batch, device="cpu")(waves)  # the same batches
            np.testing.assert_array_equal(port.ServingEncoder(path, device="cpu")(waves), want)
