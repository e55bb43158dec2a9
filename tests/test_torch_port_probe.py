"""The port's downstream probe against the JAX package on the CPU: labelled
and balanced manifest loaders, the LAPE task registry on synthetic CSVs, a
few probe steps (AudioNTT with dropout 0, AST-tiny) whose losses match the
JAX step on the same weights and batches, and the CLI end to end (WAVs ->
train_upstream -> checkpoint -> train_downstream --freeze). f32; inputs are
numpy from a seed."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import yaml

from audiossl_tpu.data import native
from audiossl_tpu.data.pipeline import ManifestLoader as JaxManifestLoader
from audiossl_tpu.downstream import tasks as jtasks
from audiossl_tpu.downstream.model import DownstreamModel as JaxDownstreamModel
from audiossl_tpu.frontend.stft import LogMelConfig as JaxLogMelConfig
from audiossl_tpu.frontend.stft import log_mel as jax_log_mel
from audiossl_tpu.models import ast as jast
from audiossl_tpu.objectives.unfused import cross_entropy as jax_cross_entropy
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.downstream import probe, tasks
from audiossl_tpu_torch.downstream.model import DownstreamModel
from audiossl_tpu_torch.frontend.stft import LogMelConfig
from audiossl_tpu_torch.models import ast as past
from audiossl_tpu_torch.models.convert import ast_from_flax, audiontt_from_flax
from audiossl_tpu_torch.train_downstream import main as downstream_main
from audiossl_tpu_torch.train_upstream import main as upstream_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, CLIP = 16000, 16000  # configs/downstream.yaml: run.duration 1
CLASSES = {"bird": 330.0, "cat": 520.0, "dog": 880.0}
COUNTS = {"bird": 3, "cat": 9, "dog": 6}  # imbalanced, for the balanced sampler


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    """18 WAVs of 0.6-1.5 s, a class-dependent tone in noise each, and a
    ``wav,label`` manifest of them."""
    d = tmp_path_factory.mktemp("labelled")
    rng = np.random.default_rng(0)
    rows = []
    for name, f0 in CLASSES.items():
        for i in range(COUNTS[name]):
            n = int(SR * rng.uniform(0.6, 1.5))
            t = np.arange(n) / SR
            wave = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(n)
            path = str(d / f"{name}{i}.wav")
            write_wav(path, wave.astype(np.float32))
            rows.append({"wav": path, "label": name})
    csv = str(d / "labelled.csv")
    pd.DataFrame(rows).sample(frac=1.0, random_state=0).to_csv(csv, index=False)
    return csv


def _batches(loader, epoch):
    return list(loader.epoch(epoch))


@pytest.mark.parametrize("shuffle,drop_last,balanced", [(True, True, False), (False, False, False), (True, True, True)])
def test_labelled_loaders_match_jax(labelled, monkeypatch, shuffle, drop_last, balanced):
    """Label ids (sorted, as JAX sorts them), the epoch order (shuffled, in
    manifest order, or drawn by inverse class frequency with replacement)
    and the windows of every batch equal the JAX loader's."""
    monkeypatch.setattr(native, "available", lambda: False)  # the JAX loader's NumPy path
    kw = dict(labeled=True, file_col="wav", shuffle=shuffle, drop_last=drop_last, seed=1, balanced=balanced)
    ref = JaxManifestLoader(labelled, 4, CLIP, SR, num_workers=1, **kw)
    assert ref.label_to_id == {"bird": 0, "cat": 1, "dog": 2}
    for workers in (1, 3):
        got = ManifestLoader(labelled, 4, CLIP, SR, num_workers=workers, native=False, **kw)
        assert got.label_to_id == ref.label_to_id
        np.testing.assert_array_equal(got.labels, ref.labels)
        if balanced:
            np.testing.assert_allclose(got.balanced_p, ref._balanced_p, rtol=0, atol=0)
        for epoch in (0, 1):
            a, b = _batches(got, epoch), _batches(ref, epoch)
            assert len(a) == len(b) == (18 // 4 if drop_last else 5)
            for (wg, lg), (wr, lr) in zip(a, b):
                np.testing.assert_array_equal(wg, wr)
                np.testing.assert_array_equal(lg, lr)
    # the eval loaders reuse the train split's ids
    test = ManifestLoader(labelled, 4, CLIP, SR, labeled=True, file_col="wav", shuffle=False, drop_last=False,
                          labels_map={"dog": 0, "cat": 1, "bird": 2})
    assert test.labels[0] == {"dog": 0, "cat": 1, "bird": 2}[pd.read_csv(labelled)["label"][0]]


def test_balanced_sampling_reaches_every_class_evenly(labelled):
    """The weighted draw puts each class at a third of the draws, though
    the manifest holds 3 / 9 / 6 clips of them."""
    loader = ManifestLoader(labelled, 4, CLIP, SR, labeled=True, file_col="wav", balanced=True, num_workers=1)
    drawn = np.concatenate([loader.labels[loader.epoch_order(e)] for e in range(300)])
    np.testing.assert_allclose(np.bincount(drawn) / drawn.size, [1 / 3] * 3, atol=0.01)
    for p_class in np.bincount(loader.labels, weights=loader.balanced_p):
        assert abs(p_class - 1 / 3) < 1e-12


# ---------------------------------------------------------------- the LAPE registry

LABEL_VALUES = {  # tests/test_tasks.py's synthetic labels per task
    "speech_commands_v1": ["yes", "no", "up", "down"],
    "speech_commands_v2": ["yes", "no", "up", "down"],
    "speech_commands_v2_35": ["sheila", "house", "zero", "marvin"],
    "birdsong_combined": ["song", "call"],
    "iemocap": [0, 1, 2, 3],
    "libri_100": [0, 1, 2, 3],
    "musical_instruments": ["guitar", "flute", "drum"],
    "tut_urban": ["airport", "bus", "tram", "park"],
    "voxceleb_v1": ["id1", "id2", "id3"],
    "language_identification": ["french", "english", "german"],
}


def _task_root(root, task, n=16):
    base = os.path.join(root, task.subdir)
    wav_dir = os.path.join(base, task.path_extra) if task.path_extra else base
    os.makedirs(wav_dir, exist_ok=True)
    values = LABEL_VALUES[task.name]
    rows = []
    for i in range(n):
        rel = f"clip_{i:02d}.wav"
        write_wav(os.path.join(wav_dir, rel), (0.2 * np.sin(2 * np.pi * (200 + 30 * i) * np.arange(3200) / SR)).astype(np.float32))
        rows.append({task.file_col: rel, task.label_col: values[i % len(values)]})
    df = pd.DataFrame(rows)
    if task.split_csv:
        df.to_csv(os.path.join(base, task.split_csv), index=False)
    else:
        df.iloc[: n // 2].to_csv(os.path.join(base, task.train_csv), index=False)
        df.iloc[n // 2:].to_csv(os.path.join(base, task.test_csv), index=False)


def test_task_registry_is_the_jax_registry():
    assert sorted(tasks.TASKS) == sorted(jtasks.TASKS)
    for name, t in tasks.TASKS.items():
        assert dataclasses.asdict(t) == dataclasses.asdict(jtasks.TASKS[name]), name


@pytest.mark.parametrize("name", sorted(jtasks.TASKS))
def test_task_loaders_match_jax(name, tmp_path, monkeypatch):
    """Each task's loaders on synthetic CSVs: the clip, the label vocabulary,
    the files (path joins, the 80/20 stratified split) and the first batch
    equal the JAX package's."""
    monkeypatch.setattr(native, "available", lambda: False)
    _task_root(str(tmp_path), jtasks.TASKS[name])
    got = tasks.build_task_loaders(tasks.TASKS[name], 4, SR, workers=1, data_root=str(tmp_path))
    ref = jtasks.build_task_loaders(jtasks.TASKS[name], 4, SR, workers=1, data_root=str(tmp_path))
    assert got[3] == ref[3]  # the clip
    assert (got[1] is None) == (ref[1] is None)
    for g, r in ((got[0], ref[0]), (got[2], ref[2])):
        assert g.label_to_id == r.label_to_id and g.files == r.files
        np.testing.assert_array_equal(g.labels, r.labels)
        (wg, lg), (wr, lr) = next(iter(g.epoch(0))), next(iter(r.epoch(0)))
        np.testing.assert_array_equal(wg, wr)
        np.testing.assert_array_equal(lg, lr)


# ---------------------------------------------------------------- probe steps


def _jax_steps(model, variables, waves, labels, n_mels, lr, freeze):
    """The JAX probe's train step (probe.py:_loss_grads, optax Adam; with
    ``freeze`` the encoder's updates are zeroed) over the batches; the losses."""
    params, batch_stats = variables["params"], variables.get("batch_stats", {})
    if freeze:
        label = lambda p: jax.tree.map_with_path(lambda path, _: "head" if path[0].key == "final" else "frozen", p)
        tx = optax.multi_transform({"head": optax.adam(lr), "frozen": optax.set_to_zero()}, label)
    else:
        tx = optax.adam(lr)
    opt = tx.init(params)
    cfg = JaxLogMelConfig(sample_rate=SR, n_mels=n_mels)

    @jax.jit
    def step(params, batch_stats, opt, w, y):
        def loss_fn(p):
            logits, mut = model.apply({"params": p, "batch_stats": batch_stats}, jax_log_mel(w, cfg)[:, :, :, None], True,
                                      rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
            return jax_cross_entropy(logits, y), mut.get("batch_stats", {})

        (loss, bs), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        up, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, up), bs, opt, loss

    losses = []
    for w, y in zip(waves, labels):
        params, batch_stats, opt, loss = step(params, batch_stats, opt, jnp.asarray(w), jnp.asarray(y))
        losses.append(float(loss))
    return losses


def _final(variables):
    final = variables["params"]["final"]
    return {"weight": torch.from_numpy(np.asarray(final["kernel"]).T.copy()), "bias": torch.from_numpy(np.array(final["bias"]))}


def _batches_of_waves(n=3, b=4, seed=8):
    rng = np.random.default_rng(seed)
    t = np.arange(CLIP) / SR
    labels = [rng.integers(0, 3, b) for _ in range(n)]
    waves = [(0.3 * np.sin(2 * np.pi * (300.0 + 250.0 * y[:, None]) * t) + 0.05 * rng.standard_normal((b, CLIP))).astype(np.float32)
             for y in labels]
    return waves, labels


@pytest.mark.parametrize("encoder,freeze", [("AudioNTT2020Task6", True), ("AST", False)])
def test_probe_steps_match_jax(monkeypatch, encoder, freeze):
    """Three probe steps on the same weights and batches: the AudioNTT probe
    (64 mels, d = 64, dropout 0, f32; frozen encoder, BN statistics
    updating) and an AST-tiny fine-tune (depth 2, every parameter trained);
    each step's loss within 1e-5 of JAX's."""
    n_mels, d, lr = 64, 64, 1e-3
    n_frames = LogMelConfig(n_mels=n_mels).num_frames(CLIP)
    tiny = jast.ASTConfig.tiny
    monkeypatch.setattr(jast.ASTConfig, "tiny", staticmethod(lambda: dataclasses.replace(tiny(), depth=2)))
    monkeypatch.setitem(past.VARIANTS, "tiny", lambda: past.ASTConfig.tiny(depth=2))
    kw = dict(encoder_type=encoder, input_tdim=n_frames, model_size="tiny")
    if encoder == "AudioNTT2020Task6":
        jmodel = JaxDownstreamModel(n_mels=n_mels, d=d, num_classes=3, compute_dtype=jnp.float32, dropout_rate=0.0, **kw)
        model = DownstreamModel(n_mels, d, 3, compute_dtype=torch.float32, dropout_rate=0.0, **kw)
    else:
        jmodel = JaxDownstreamModel(n_mels=n_mels, d=d, num_classes=3, **kw)
        model = DownstreamModel(n_mels, d, 3, **kw)
    variables = jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                            jnp.zeros((2, n_mels, n_frames, 1)), False)
    variables = jax.tree.map(np.asarray, variables)
    enc = {"params": variables["params"]["encoder"], "batch_stats": variables.get("batch_stats", {}).get("encoder", {})}
    model.encoder.load_state_dict(audiontt_from_flax(enc) if encoder != "AST" else ast_from_flax(enc), strict=True)
    model.final.load_state_dict(_final(variables))
    waves, labels = _batches_of_waves()
    want = _jax_steps(jmodel, variables, waves, labels, n_mels, lr, freeze)

    model.train()
    if freeze:
        model.encoder.requires_grad_(False)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr)
    frozen = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    got = [float(probe.probe_step(model, opt, LogMelConfig(n_mels=n_mels), torch.from_numpy(w), torch.from_numpy(y)))
           for w, y in zip(waves, labels)]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)
    if freeze:  # the encoder's weights hold; its BN statistics moved
        sd = model.encoder.state_dict()
        assert torch.equal(sd["fc.0.weight"], frozen["fc.0.weight"])
        assert not torch.equal(sd["features_1.1.running_mean"], frozen["features_1.1.running_mean"])


# ---------------------------------------------------------------- CLI end to end


def test_cli_pretrains_then_probes_on_the_checkpoint(labelled, tmp_path, monkeypatch):
    """WAVs -> train_upstream (DeLoRes-S, d = 32, 2 steps) -> checkpoint ->
    train_downstream --freeze on its encoder: one epoch, a stats line, the
    encoder's weights those of the checkpoint; a probe of another width
    refuses the checkpoint instead of training from random weights (the
    cross-shape surgery serves the transformer encoders only); an HF task
    with no CSVs loads the checked-in fixture through data/hf.py (or, where
    the `datasets` package is missing, raises an error that names it)."""
    df = pd.read_csv(labelled)
    pre_csv = str(tmp_path / "pre.csv")
    pd.DataFrame({"files": df["wav"]}).to_csv(pre_csv, index=False)
    with open(os.path.join(ROOT, "configs", "delores_s.yaml")) as f:
        pre = yaml.safe_load(f)
    pre["pretrain"]["base_encoder"].update(output_dim=32)
    pre["pretrain"]["projection_dim"] = 32
    pre["run"].update(batch_size=4, epochs=1, num_dataloader_workers=2)
    pre_cfg = str(tmp_path / "pre.yaml")
    with open(pre_cfg, "w") as f:
        yaml.safe_dump(pre, f)
    upstream_main(["--upstream", "delores_s", "--input", pre_csv, "-c", pre_cfg, "--device", "cpu",
                   "--max_steps", "2", "--save_path", str(tmp_path / "up")])
    ckpt = str(tmp_path / "up_chkp")

    with open(os.path.join(ROOT, "configs", "downstream.yaml")) as f:
        down = yaml.safe_load(f)
    down["downstream"]["base_encoder"]["output_dim"] = 32
    down["run"]["num_dataloader_workers"] = 2
    down_cfg = str(tmp_path / "down.yaml")
    with open(down_cfg, "w") as f:
        yaml.safe_dump(down, f)
    argv = ["--task", "toy", "--train_csv", labelled, "--test_csv", labelled, "--checkpoint", ckpt, "-c", down_cfg,
            "--epochs", "1", "--batch_size", "4", "--exp_dir", str(tmp_path / "exp"), "--device", "cpu"]
    result = downstream_main(argv + ["--freeze"])
    with open(tmp_path / "exp" / "toy" / "downstream_stats.txt") as f:
        stats = [json.loads(line) for line in f]
    assert len(stats) == 1 and 0.0 <= stats[0]["Test_Accuracy"] <= 1.0 and np.isfinite(stats[0]["Train_loss"])
    assert len(result["losses"]) == 4 and result["num_classes"] == 3
    enc = torch.load(probe.newest_encoder(ckpt), weights_only=True)
    for k, v in result["model"].encoder.state_dict().items():
        if "running" not in k and "num_batches" not in k:
            assert torch.equal(v.cpu(), enc[k]), k

    down["downstream"]["base_encoder"]["output_dim"] = 64
    with open(down_cfg, "w") as f:
        yaml.safe_dump(down, f)
    with pytest.raises(ValueError, match="surgery"):
        downstream_main(argv)
    monkeypatch.setenv("AUDIOSSL_HF_DATA_DIR", os.path.join(ROOT, "tests", "fixtures", "speech_commands_tiny"))
    try:
        import datasets  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="datasets"):
            probe.build_loaders(down, {"task": "speech_commands_v2"})
    else:
        train, valid, test, clip = probe.build_loaders(down, {"task": "speech_commands_v2"})
        assert (train.num_samples, valid.num_samples, test.num_samples, clip) == (72, 24, 24, CLIP)
