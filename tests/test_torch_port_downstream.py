"""The port's new downstream pieces against the JAX package on the CPU:
EfficientNet-B0 (eval, and training with its stochastic-depth draws and
BatchNorm statistics), the MAST downstream encoder in training mode with
JAX's drop-path draws fed to both sides, the HF loader on the checked-in
speech_commands fixture (bit for bit), the ``extract_features`` CLI
(log-mel and AudioNTT-embedding files), and the probe CLI on an SS-MAST
checkpoint of another input shape (the cross-shape transplant, frozen and
fine-tuned) and on an HF task. f32 unless stated; inputs are numpy from a
seed, weights carried across by ``models.convert``."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from audiossl_tpu.downstream.model import DownstreamModel as JaxDownstreamModel
from audiossl_tpu.models import mast as jmast
from audiossl_tpu.models import mvit as jmvit
from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.downstream import probe
from audiossl_tpu_torch.downstream.model import DownstreamModel
from audiossl_tpu_torch.models import convert
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.mvit import MViTConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "speech_commands_tiny")
TOL = 1e-4  # relative to max(1, max|ref|)
RNG = np.random.default_rng(23)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


def _final(variables):
    final = variables["params"]["final"]
    return {"weight": torch.from_numpy(np.asarray(final["kernel"]).T.copy()), "bias": torch.from_numpy(np.array(final["bias"]))}


# ---------------------------------------------------------------- EfficientNet-B0


@pytest.fixture(scope="module")
def effnet():
    """(JAX model, its variables with random running statistics as numpy, input)."""
    jm = JaxDownstreamModel(n_mels=64, d=0, num_classes=3, encoder_type="Efficient_Net")
    x = RNG.standard_normal((3, 64, 101, 1)).astype(np.float32)
    v = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init({"params": k}, jnp.asarray(x), False))(jax.random.key(4)))
    v = jax.tree.map(np.array, v)

    def randomise(tree):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                randomise(leaf)
            elif k == "mean":
                tree[k] = (0.1 * RNG.standard_normal(leaf.shape)).astype(np.float32)
            elif k == "var":
                tree[k] = RNG.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    randomise(v["batch_stats"])
    return jm, v, x


def _port_effnet(v):
    model = DownstreamModel(64, 0, 3, encoder_type="Efficient_Net")
    enc = {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]}
    model.encoder.load_state_dict(convert.efficientnet_from_flax(enc), strict=True)
    model.final.load_state_dict(_final(v))
    return model


def test_efficientnet_eval_matches_jax(effnet):
    jm, v, x = effnet
    want = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(x), False))(v))
    with torch.no_grad():
        got = _port_effnet(v).eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert _close(got, want), float(np.abs(got - want).max())


def test_efficientnet_train_matches_jax(effnet, monkeypatch):
    """Training mode: batch statistics, the running statistics they leave,
    and stochastic depth from the same U(0, 1) draws on both sides (JAX's
    bernoulli keeps a sample where its draw is below the keep probability;
    a sample dropped in the first residual blocks)."""
    jm, v, x = effnet
    model = _port_effnet(v).train()
    n_draws = sum(blk.draws for blk in model.encoder._blocks)
    draws = RNG.uniform(size=(n_draws, 3)).astype(np.float32)
    draws[0] = draws[1] = (0.5, 0.999, 0.5)  # above every block's keep probability: the middle sample drops
    it = iter(draws)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(next(it)).reshape(shape) < p)

    out, mut = jax.jit(lambda v: jm.apply(v, jnp.asarray(x), True, rngs={"dropout": jax.random.key(0)},
                                          mutable=["batch_stats"]))(v)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2), draws=iter(torch.from_numpy(draws)))
    assert _close(got.detach().numpy(), np.asarray(out)), float(np.abs(got.detach().numpy() - np.asarray(out)).max())
    want_sd = convert.efficientnet_from_flax({"params": v["params"]["encoder"],
                                              "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"]["encoder"])})
    sd = model.encoder.state_dict()
    for k in (k for k in want_sd if "running" in k):
        assert _close(sd[k].numpy(), want_sd[k].numpy()), k


# ---------------------------------------------------------------- MAST in training mode


def test_mast_training_forward_with_jax_draws(monkeypatch):
    """The MAST downstream encoder (4 blocks of MAST-tiny, 64 mels x 101
    frames, f32) with its head in training mode: JAX's drop_path takes
    uniform draws from a list, the port the same draws through ``draws``;
    the logits agree, and a frozen encoder in training mode still draws."""
    monkeypatch.setitem(jmast.VARIANTS, "tiny", lambda **kw: jmvit.MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
    monkeypatch.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
    draws = RNG.uniform(size=(6, 2)).astype(np.float32)
    draws[0, 1] = draws[3, 0] = 1e-3  # floor(keep + u) = 0: these samples drop the branch
    it = iter(draws)

    def drop_path(x, rate, deterministic, rng):
        if deterministic or rate == 0.0:
            return x
        keep = 1.0 - rate
        return x / keep * jnp.floor(keep + jnp.asarray(next(it)).reshape((-1,) + (1,) * (x.ndim - 1)))

    monkeypatch.setattr(jmvit, "drop_path", drop_path)
    kw = dict(encoder_type="MAST", input_tdim=101, model_size="tiny")
    jm = JaxDownstreamModel(n_mels=64, d=0, num_classes=3, compute_dtype=jnp.float32, **kw)
    x = RNG.standard_normal((2, 64, 101, 1)).astype(np.float32)
    v = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init({"params": k}, jnp.asarray(x), False))(jax.random.key(6)))
    want = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(x), True, rngs={"dropout": jax.random.key(0)}))(v))
    assert next(it, None) is None  # JAX took all six

    model = DownstreamModel(64, 0, 3, compute_dtype=torch.float32, **kw)
    model.encoder.load_state_dict(convert.mvit_reference_layout(convert.mast_from_flax(
        {"params": v["params"]["encoder"]})), strict=True)
    model.final.load_state_dict(_final(v))
    model.train().encoder.requires_grad_(False)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2), draws=iter(torch.from_numpy(draws))).detach().numpy()
    assert _close(got, want), float(np.abs(got - want).max())
    with pytest.raises(ValueError, match="generator"):
        model(torch.from_numpy(x).permute(0, 3, 1, 2))


# ---------------------------------------------------------------- HF loader


@pytest.mark.parametrize("kw", [dict(shuffle=True, drop_last=True, seed=1), dict(balanced=True, seed=3),
                                dict(shuffle=True, host_shard=(1, 3), seed=2)])
def test_hf_loader_matches_jax(kw):
    """The same batches as JAX's HFLoader, bit for bit, over two epochs:
    shuffled, class-balanced, and one host's shard."""
    pytest.importorskip("datasets")
    from audiossl_tpu.data.hf import HFLoader as JaxHFLoader
    from audiossl_tpu_torch.data.hf import HFLoader

    got = HFLoader("speech_commands_v2", "train", 16, 12000, data_dir=FIXTURE, **kw)
    ref = JaxHFLoader("speech_commands_v2", "train", 16, 12000, data_dir=FIXTURE, **kw)
    assert got.label_to_id == ref.label_to_id and len(got) == len(ref) and got.num_samples == ref.num_samples
    for epoch in (0, 1):
        batches = list(got.epoch(epoch))
        assert len(batches) == len(ref)
        for (wg, lg), (wr, lr) in zip(batches, ref.epoch(epoch)):
            assert wg.dtype == wr.dtype and lg.dtype == lr.dtype
            np.testing.assert_array_equal(wg, wr)
            np.testing.assert_array_equal(lg, lr)


def test_hf_loader_names_the_missing_package(monkeypatch):
    from audiossl_tpu_torch.data.hf import HFLoader

    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        HFLoader("speech_commands_v2", "train", 4, 16000, data_dir=FIXTURE)


# ---------------------------------------------------------------- extract_features


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """6 WAVs of 0.5-1.4 s in two class directories with equal basenames."""
    d = tmp_path_factory.mktemp("feats_wavs")
    rows = []
    for c, f0 in (("a", 300.0), ("b", 700.0)):
        os.makedirs(d / c)
        for i in range(3):
            n = int(16000 * RNG.uniform(0.5, 1.4))
            wave = 0.4 * np.sin(2 * np.pi * f0 * np.arange(n) / 16000) + 0.05 * RNG.standard_normal(n)
            rows.append(str(d / c / f"clip{i}.wav"))
            write_wav(rows[-1], wave.astype(np.float32))
    csv = str(d / "manifest.csv")
    pd.DataFrame({"AudioPath": rows}).to_csv(csv, index=False)
    return csv, rows


def _files(out_dir):
    return sorted(os.path.relpath(os.path.join(r, f), out_dir) for r, _, fs in os.walk(out_dir) for f in fs)


def _jax_extract(monkeypatch, argv):
    """JAX's CLI on one decoding thread without the native loader: its worker
    threads share one window rng (ROADMAP.md Queue 3), so only then are its
    crops of the clips longer than the window those of a fixed order."""
    from audiossl_tpu.data import native
    from audiossl_tpu.downstream import extract_features as jext

    monkeypatch.setattr(native, "available", lambda: False)
    loader = jext.ManifestLoader
    monkeypatch.setattr(jext, "ManifestLoader", lambda *a, **kw: loader(*a, num_workers=1, **kw))
    monkeypatch.setattr(sys, "argv", ["extract_features"] + argv)
    jext.main()


@pytest.mark.parametrize("l2_norm", [False, True])
def test_extract_logmel_files_match_jax(manifest, tmp_path, monkeypatch, l2_norm):
    from audiossl_tpu_torch.data import native
    from audiossl_tpu_torch.downstream.extract_features import main

    csv, _ = manifest
    flags = ["--csv", csv, "--batch_size", "6"] + (["--l2_norm"] if l2_norm else [])
    _jax_extract(monkeypatch, flags + ["--out", str(tmp_path / "jax")])
    monkeypatch.setattr(native, "available", lambda: False)  # the port's loader on the NumPy path too
    assert main(flags + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 6
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port") and files == [f"{c}/clip{i}.wav.npy" for c in "ab" for i in range(3)]
    for f in files:
        got, want = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert got.shape == want.shape == (64, 101) and _close(got, want), f


def test_extract_embeddings_match_jax(manifest, tmp_path, monkeypatch):
    """``--checkpoint``: the time mean of an AudioNTT-2048's features, bf16
    on both sides as JAX computes them; the same weights as a JAX orbax
    checkpoint and a port encoder/<step>.pt. Bound: 5e-2 of max|ref|, the
    serving bound for bf16 (two bf16 convolutions in other orders)."""
    from audiossl_tpu.models.audiontt import AudioNTT2020Task6 as JaxAudioNTT
    from audiossl_tpu.train import checkpoint as jckpt
    from audiossl_tpu_torch.downstream.extract_features import main

    jm = JaxAudioNTT(n_mels=64, d=2048)
    v = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, 64, 101, 1)), False))(
        jax.random.key(8)))
    jckpt.save_encoder_only(str(tmp_path / "jax_chkp"), 1, v)
    os.makedirs(tmp_path / "port_chkp" / "encoder")
    torch.save(convert.audiontt_from_flax(v), tmp_path / "port_chkp" / "encoder" / "1.pt")
    csv, _ = manifest
    flags = ["--csv", csv, "--batch_size", "6"]
    _jax_extract(monkeypatch, flags + ["--out", str(tmp_path / "jax"), "--checkpoint", str(tmp_path / "jax_chkp")])
    main(flags + ["--out", str(tmp_path / "port"), "--checkpoint", str(tmp_path / "port_chkp"), "--device", "cpu"])
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port") and len(files) == 6
    for f in files:
        got, want = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert got.shape == want.shape == (2048,)
        assert float(np.abs(got - want).max()) <= 5e-2 * float(np.abs(want).max()), f


# ---------------------------------------------------------------- the probe CLI


def _down_config(tmp_path, **enc):
    with open(os.path.join(ROOT, "configs", "downstream.yaml")) as f:
        down = yaml.safe_load(f)
    down["downstream"]["base_encoder"].update(enc)
    down["run"]["num_dataloader_workers"] = 2
    path = str(tmp_path / "down.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(down, f)
    return down, path


def test_cli_probes_an_ssmast_checkpoint_of_another_shape(tmp_path, monkeypatch, caplog):
    """An SS-MAST export (MAST-tiny at 64 mels x 128 frames, a 12 x 5 grid)
    probed at configs/downstream.yaml's 64 mels x 1 s (9 x 5) through
    train_downstream: the transplant is logged; frozen, the encoder keeps the
    transplanted weights and the losses are finite; fine-tuned, they move."""
    from audiossl_tpu_torch.models import surgery
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.train.checkpoint import save_checkpoint
    from audiossl_tpu_torch.train_downstream import main as downstream_main

    monkeypatch.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
    with open(os.path.join(ROOT, "configs", "ssmast.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"].update(model_size="tiny", num_negatives=64)
    cfg["pretrain"]["input"].update(n_mels=64, target_length=128)
    ckpt = str(tmp_path / "ssmast_chkp")
    save_checkpoint(ckpt, 5, {}, init_objective("ssmast", cfg, seed=1).export_state_dict(), cfg)

    rows = []
    for i in range(8):
        rows.append({"wav": str(tmp_path / f"w{i}.wav"), "label": f"c{i % 2}"})
        t = np.arange(int(16000 * RNG.uniform(0.8, 1.2))) / 16000
        write_wav(rows[-1]["wav"], (0.4 * np.sin(2 * np.pi * (300 + 400 * (i % 2)) * t)).astype(np.float32))
    csv = str(tmp_path / "l.csv")
    pd.DataFrame(rows).to_csv(csv, index=False)
    _, cfg_path = _down_config(tmp_path, type="MAST", model_size="tiny")
    caplog.set_level("INFO", logger="audiossl_tpu_torch.downstream")
    argv = ["--task", "toy", "--train_csv", csv, "--test_csv", csv, "--checkpoint", ckpt, "-c", cfg_path, "--encoder",
            "MAST", "--epochs", "1", "--batch_size", "4", "--exp_dir", str(tmp_path / "exp"), "--device", "cpu"]
    frozen = downstream_main(argv + ["--freeze"])
    assert "cross-shape encoder transplant" in caplog.text
    assert len(frozen["losses"]) == 2 and all(np.isfinite(frozen["losses"]))
    with torch.random.fork_rng(devices=[]):
        target = DownstreamModel(64, 768, 0, encoder_type="MAST", input_tdim=101, model_size="tiny").encoder.state_dict()
    want = surgery.load_pretrained_encoder(ckpt, target, "MAST", (128, 64), (101, 64))
    got = frozen["model"].encoder.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    tuned = downstream_main(argv)
    assert all(np.isfinite(tuned["losses"]))
    assert not torch.equal(tuned["model"].encoder.state_dict()["blocks.0.attn.qkv.weight"], want["blocks.0.attn.qkv.weight"])


def test_hf_task_loaders(monkeypatch):
    """An HF task with no CSVs loads through data/hf.py: train, validation
    and test splits of the fixture."""
    pytest.importorskip("datasets")
    monkeypatch.setenv("AUDIOSSL_HF_DATA_DIR", FIXTURE)
    config = {"run": {"batch_size": 4, "duration": 1}, "downstream": {"input": {"sampling_rate": 16000}}}
    train, valid, test, clip = probe.build_loaders(config, {"task": "speech_commands_v2"})
    assert clip == 16000 and train.num_samples == 72 and valid.num_samples == test.num_samples == 24
    waves, labels = next(iter(valid.epoch(0)))
    assert waves.shape == (4, clip) and labels.dtype == np.int32
