"""The port's reference-checkpoint import, utilities and data fixtures against
the JAX package, on the CPU; inputs numpy from a seed.

* models/torch_import.py: reference-named torch modules built here
  (tests/test_torch_import.py's AudioNTT, timm-DeiT AST and MViTv2) go
  through the port's importer into the port's modules and through JAX's into
  JAX's; the outputs agree with each other and with the torch reference
  within 2e-4 (the JAX import tests' bound); the Lightning and MoCo
  nestings, the RGB fold with a square grid and timm's stage nesting
  normalise as JAX's do; the CLI writes an encoder-only checkpoint that
  ``train_downstream --checkpoint`` probes;
* utils/cka.py, the rest of utils/metrics.py, utils/logging_utils.py,
  utils/profiling.py: against JAX's on the same inputs (f32 CKA 1e-5
  relative, the metrics exactly);
* data/make_test_wavs.py and data/make_hf_fixture.py: the same files and
  rows as JAX's for a seed.
"""
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from audiossl_tpu.models import torch_import as jti
from audiossl_tpu_torch.models import torch_import as pti
from tests import test_torch_import as ref

RNG = np.random.default_rng(4242)
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- reference checkpoints


def test_audiontt_import_matches_jax_and_the_reference():
    from audiossl_tpu.models.audiontt import AudioNTT2020Task6 as JaxAudioNTT
    from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6

    tm = ref._torch_audiontt(64, 128)
    x = RNG.standard_normal((2, 1, 64, 96)).astype(np.float32)
    with torch.no_grad():
        taps_t, out_t = tm(torch.from_numpy(x))
    nested = {f"encoder_q.encoder.{k}": v for k, v in tm.state_dict().items()}
    nested.update({f"encoder_k.encoder.{k}": torch.zeros_like(v) for k, v in tm.state_dict().items()})
    sd = pti.audiontt_from_torch(nested)
    ours = AudioNTT2020Task6(n_mels=64, d=128, return_all_layers=True, compute_dtype=torch.float32).eval()
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        *taps, out = ours(torch.from_numpy(x))
    jm = JaxAudioNTT(n_mels=64, d=128, return_all_layers=True, compute_dtype=jnp.float32)
    *jtaps, jout = jm.apply(jax.tree.map(jnp.asarray, jti.audiontt_from_torch(nested)),
                            jnp.asarray(x.transpose(0, 2, 3, 1)), False)
    for got, want in ((out.numpy(), out_t.numpy()), (out.numpy(), np.asarray(jout))):
        np.testing.assert_allclose(got, want, atol=TOL)
    for a, b, c in zip(taps, taps_t, jtaps):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=TOL)


@pytest.mark.parametrize("rgb", [False, True])
def test_ast_import_matches_jax_and_the_reference(rgb):
    """A 4 x 6 grid given (1 channel), or raw DeiT: 3 channels folded and a
    square 5 x 5 grid inferred (the input 56 x 56)."""
    from audiossl_tpu.models.ast import ASTConfig as JaxASTConfig
    from audiossl_tpu.models.ast import ASTEncoder as JaxASTEncoder
    from audiossl_tpu_torch.models.ast import ASTConfig, ASTEncoder
    from audiossl_tpu_torch.models.convert import ast_port_layout

    fdim, tdim = (56, 56) if rgb else (48, 68)
    f, t = (fdim - 16) // 10 + 1, (tdim - 16) // 10 + 1
    tm = ref._torch_ast(in_chans=3 if rgb else 1)(n_tokens=f * t).eval()
    x = RNG.standard_normal((2, 1, fdim, tdim)).astype(np.float32)
    with torch.no_grad():  # the folded kernel on one channel is the RGB one on three equal channels
        out_t = tm(torch.from_numpy(x).expand(-1, 3 if rgb else 1, -1, -1).contiguous())
    sd, grid = pti.ast_from_torch({f"v.{k}": v for k, v in tm.state_dict().items()}, None if rgb else (f, t))
    assert grid == (f, t) and sd["patch_embed.proj.weight"].shape[1] == 1
    ours = ASTEncoder(fdim, tdim, ASTConfig(embed_dim=32, num_heads=4, depth=2)).eval()
    ours.load_state_dict(ast_port_layout(sd, grid), strict=True)
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    jvars = jti.ast_from_torch(tm.state_dict(), num_heads=4, src_grid_ft=None if rgb else (f, t))
    import dataclasses

    jm = JaxASTEncoder(input_fdim=fdim, input_tdim=tdim,
                       cfg=dataclasses.replace(JaxASTConfig.tiny(), embed_dim=32, num_heads=4, depth=2,
                                               fused_attention="off"))
    jout = np.asarray(jm.apply(jax.tree.map(jnp.asarray, jvars), jnp.asarray(x.transpose(0, 2, 3, 1)), False))
    np.testing.assert_allclose(out, jout, atol=TOL)
    np.testing.assert_allclose(out, out_t.numpy(), atol=TOL)


@pytest.mark.parametrize("staged", [False, True])
def test_mast_import_matches_jax_and_the_reference(staged):
    """The vendored flat blocks, or timm's stages.{s}.blocks.{b}: both give
    the same trunk, whose token mean agrees with the torch reference's and
    JAX's import."""
    import dataclasses

    from audiossl_tpu.models.mvit import MViT as JaxMViT
    from audiossl_tpu_torch.models.convert import mvit_reference_layout
    from audiossl_tpu_torch.models.mvit import MViT, MViTConfig

    fdim, tdim = 48, 68
    jcfg = ref._tiny_mast_cfg()
    tm = ref._torch_mvit(jcfg, grid_ft=(4, 6)).eval()
    x = RNG.standard_normal((2, 1, fdim, tdim)).astype(np.float32)
    with torch.no_grad():
        out_t = tm(torch.from_numpy(x)).numpy()
    sd = dict(tm.state_dict())
    if staged:
        split = {0: (0, 0), 1: (1, 0), 2: (1, 1)}
        sd = {(f"stages.{split[int(k.split('.')[1])][0]}.blocks.{split[int(k.split('.')[1])][1]}." + k.split(".", 2)[2]
               if k.startswith("blocks.") else k): v for k, v in sd.items()}
    sd["norm.weight"], sd["head.weight"] = torch.ones(32), torch.zeros(3, 32)  # a final norm and a head: left out
    got_sd = pti.mast_from_torch({f"encoder_q.ast_model.v.{k}": v for k, v in sd.items()})
    assert "norm.weight" not in got_sd and "head.weight" not in got_sd
    pcfg = MViTConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(MViTConfig)})
    ours = MViT(pcfg, input_hw=(tdim, fdim), final_norm=False).eval()
    ours.load_state_dict(mvit_reference_layout(got_sd), strict=True)
    with torch.no_grad():
        out = ours(torch.from_numpy(x).transpose(-1, -2)).mean(1).numpy()
    jvars = jti.mast_from_torch(tm.state_dict())
    jtok = JaxMViT(jcfg, input_hw=(tdim, fdim), in_chans=1, final_norm=False).apply(
        {"params": jax.tree.map(jnp.asarray, jvars["params"]["mvit"])}, jnp.asarray(x[:, 0].transpose(0, 2, 1)[..., None]),
        False)
    np.testing.assert_allclose(out, out_t, atol=TOL)
    np.testing.assert_allclose(out, np.asarray(jnp.mean(jtok, axis=1)), atol=TOL)


def test_import_cli_writes_an_encoder_checkpoint_the_probe_reads(tmp_path):
    """Lightning-style .ckpt -> the CLI -> encoder/0.pt (save_encoder_only)
    and config.yaml -> train_downstream --checkpoint --freeze: one epoch,
    the probe's encoder holding the imported weights."""
    import yaml

    from audiossl_tpu_torch.data.make_test_wavs import make
    from audiossl_tpu_torch.train_downstream import main as downstream_main

    tm = ref._torch_audiontt(64, 32)
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {f"encoder_q.encoder.{k}": v for k, v in tm.state_dict().items()}}, path)
    out = pti.main(["--checkpoint", path, "--arch", "audiontt", "--out", str(tmp_path / "imported")])
    imported = torch.load(os.path.join(out, "encoder", "0.pt"), weights_only=True)
    assert all(torch.equal(imported[k], v) for k, v in tm.state_dict().items())
    wavs = make(str(tmp_path / "wavs"), 12)
    with open(os.path.join(ref.__file__.rsplit(os.sep, 2)[0], "configs", "downstream.yaml")) as f:
        down = yaml.safe_load(f)
    down["downstream"]["base_encoder"]["output_dim"] = 32
    down["run"]["num_dataloader_workers"] = 1
    cfg = str(tmp_path / "down.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(down, f)
    result = downstream_main(["--task", "toy", "--train_csv", os.path.join(wavs, "downstream_train.csv"), "--test_csv",
                              os.path.join(wavs, "downstream_test.csv"), "--checkpoint", out, "-c", cfg, "--epochs",
                              "1", "--batch_size", "4", "--exp_dir", str(tmp_path / "exp"), "--device", "cpu",
                              "--freeze"])
    assert np.isfinite(result["losses"]).all() and result["num_classes"] == 4
    for k, v in result["model"].encoder.state_dict().items():
        if "running" not in k and "num_batches" not in k:
            assert torch.equal(v, imported[k]), k
    with pytest.raises(KeyError, match="features_1.0.weight"):
        pti.audiontt_from_torch({"a.b": torch.zeros(1)})


# ---------------------------------------------------------------- utils


def test_cka_matches_jax():
    from audiossl_tpu.utils import cka as jcka
    from audiossl_tpu_torch.utils import cka

    x = RNG.standard_normal((12, 8)).astype(np.float32)
    y = (x @ RNG.standard_normal((8, 5)) + 0.3 * RNG.standard_normal((12, 5))).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for fn, args in (("linear_cka", ()), ("kernel_cka", ()), ("kernel_cka", (0.7,)), ("linear_hsic", ()),
                     ("kernel_hsic", ())):
        got = float(getattr(cka, fn)(tx, ty, *args))
        want = float(getattr(jcka, fn)(jnp.asarray(x), jnp.asarray(y), *args))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (fn, got, want)
    assert abs(float(cka.linear_cka(tx, tx)) - 1.0) < 1e-5


def test_metrics_match_jax():
    from audiossl_tpu.utils import metrics as jm
    from audiossl_tpu_torch.utils import metrics as pm

    logits, labels = RNG.standard_normal((20, 6)), RNG.integers(0, 6, 20)
    assert pm.accuracy_topk(logits, labels, (1, 3, 6)) == jm.accuracy_topk(logits, labels, (1, 3, 6))
    s = RNG.standard_normal((16, 16)) + 3 * np.eye(16) * (RNG.random(16) < 0.5)
    assert pm.calc_recalls(s) == jm.calc_recalls(s)
    a, b = pm.TrainMeter(10), jm.TrainMeter(10)
    for t in (0.5, 0.7, 0.4):
        a.update(t), b.update(t)
    assert (a.eta_seconds, a.step, a.time.avg) == (b.eta_seconds, b.step, b.time.avg)
    with pytest.raises(ValueError, match="square"):
        pm.calc_recalls(s[:3])


def test_pretraining_log_line_carries_the_eta(tmp_path, caplog):
    """train_upstream logs the TrainMeter's ETA in minutes, as JAX's loop does."""
    import yaml

    from audiossl_tpu_torch.data.make_test_wavs import make
    from audiossl_tpu_torch.train.loop import train_upstream

    wavs = make(str(tmp_path / "wavs"), 8, labeled=False)
    with open(os.path.join(ref.__file__.rsplit(os.sep, 2)[0], "configs", "delores_s.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"]["base_encoder"].update(output_dim=32)
    cfg["pretrain"]["projection_dim"] = 32
    cfg["run"].update(batch_size=4, epochs=1, num_dataloader_workers=1, log_every=1, save_path=str(tmp_path / "up"))
    caplog.set_level(logging.INFO, logger="audiossl_tpu_torch.train")
    train_upstream(cfg, os.path.join(wavs, "pretrain.csv"), "delores_s", max_steps=2, device="cpu")
    lines = [r.getMessage() for r in caplog.records if "step" in r.getMessage() and "eta" in r.getMessage()]
    assert len(lines) == 2 and lines[-1].endswith("eta 0m)"), lines


def test_logging_utils_match_jax(tmp_path):
    from audiossl_tpu.utils import logging_utils as jlu
    from audiossl_tpu_torch.utils import logging_utils as plu

    for mod, name in ((plu, "port"), (jlu, "jax")):
        p = mod.PickleLogger(str(tmp_path / f"{name}.pkl"))
        p.log({"a": 1})
        p.log([2, 3])
        st = mod.JsonStats(str(tmp_path / f"{name}.jsonl"), ["epoch", "loss"])
        st.update((0, 1.5))
        st.update({"epoch": 1, "loss": 0.5})
    assert plu.PickleLogger.load(str(tmp_path / "port.pkl")) == jlu.PickleLogger.load(str(tmp_path / "jax.pkl"))
    assert plu.JsonStats(str(tmp_path / "port.jsonl"), []).rows == jlu.JsonStats(str(tmp_path / "jax.jsonl"), []).rows
    with open(tmp_path / "port.jsonl") as a, open(tmp_path / "jax.jsonl") as b:
        assert a.read() == b.read()
    logger = plu.get_logger(str(tmp_path / "logs"), name="audiossl_tpu_torch.test_logging_utils")
    logger.info("hello")
    for h in logger.handlers:
        h.flush()
    with open(tmp_path / "logs" / "train.log") as f:
        assert "hello" in f.read()


def test_profiling_matches_jax(tmp_path):
    from audiossl_tpu.utils import profiling as jprof
    from audiossl_tpu_torch.utils import profiling as pprof

    shapes = [(3, 4), (5,), (2, 2, 2)]
    assert pprof.params_count([torch.zeros(s) for s in shapes]) == jprof.params_count([jnp.zeros(s) for s in shapes])
    assert pprof.params_count(torch.nn.Linear(4, 3)) == 15
    for mod in (pprof, jprof):
        mod.check_nan_loss(1.0, 1)
        with pytest.raises(FloatingPointError, match="loss became nan at step 3"):
            mod.check_nan_loss(float("nan"), 3)
    a, b = RNG.standard_normal((8, 16)).astype(np.float32), RNG.standard_normal((16, 4)).astype(np.float32)
    got = pprof.flops_estimate(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert got == 2 * 8 * 16 * 4 == jprof.flops_estimate(jnp.matmul, jnp.asarray(a), jnp.asarray(b))
    with pprof.device_timer("block", torch.zeros(1)) as t:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert t["seconds"] > 0
    with pprof.trace(str(tmp_path / "trace")) as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0 and len(prof.key_averages()) > 0


# ---------------------------------------------------------------- data fixtures


def test_make_test_wavs_matches_jax(tmp_path):
    from audiossl_tpu.data.make_test_wavs import make as jmake
    from audiossl_tpu_torch.data.make_test_wavs import main

    assert main([str(tmp_path / "port"), "6"]) == str(tmp_path / "port")
    jmake(str(tmp_path / "jax"), 6)
    for name in sorted(os.listdir(tmp_path / "jax")):
        a, b = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        if name.endswith(".csv"):
            a, b = a.replace(b"/port/", b"/x/"), b.replace(b"/jax/", b"/x/")
        assert a == b, name
    main([str(tmp_path / "unlabeled"), "4", "--unlabeled"])
    assert list(pd.read_csv(tmp_path / "unlabeled" / "pretrain.csv").columns) == ["files"]


def test_hf_fixture_rows_match_jax_and_missing_datasets_raise(tmp_path, monkeypatch):
    from audiossl_tpu.data import make_hf_fixture as jfix
    from audiossl_tpu_torch.data import make_hf_fixture as pfix

    assert pfix.LABEL_NAMES == jfix.LABEL_NAMES and pfix.CLIP_SAMPLES == jfix.CLIP_SAMPLES
    pytest.importorskip("datasets")
    pfix.build_fixture(str(tmp_path / "port"), 6, 3, 3)
    jfix.build_fixture(str(tmp_path / "jax"), 6, 3, 3)
    import datasets

    a, b = datasets.load_from_disk(str(tmp_path / "port")), datasets.load_from_disk(str(tmp_path / "jax"))
    for split in ("train", "validation", "test"):
        assert a[split]["label"] == b[split]["label"]
        for ra, rb in zip(a[split]["audio"], b[split]["audio"]):
            np.testing.assert_array_equal(np.asarray(ra["array"]), np.asarray(rb["array"]))
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="needs the `datasets` package"):
        pfix.build_fixture(str(tmp_path / "none"))
