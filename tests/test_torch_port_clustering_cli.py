"""The clustering family through the pretraining CLI on the CPU: DECAR-v2
and DeepCluster-v1 (``--upstream decar_v2|decar_v1 --device cpu``) straight
through against a stopped run resumed (the losses, the weights and, for
DECAR, the memory bank and the assignments come back bit for bit); then
``make_pseudo_labels`` on the DeepCluster run's checkpoint, whose CSV
trains UnFuSeD and whose centroids drive Kmix in DeLoRes-S; and the
parallelism knobs each trainer refuses. d = 32 at batch 4 on 16 distinct
clips: 4 steps an epoch, a 16-slot bank."""
import copy
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6
from audiossl_tpu_torch.objectives.make_pseudo_labels import main as pseudo_main
from audiossl_tpu_torch.train.decar_loop import train_decar
from audiossl_tpu_torch.train.deepcluster_loop import train_deepcluster_v1
from audiossl_tpu_torch.train.loop import train_upstream
from audiossl_tpu_torch.train_upstream import main as train_main
from tests.test_torch_port_decar import one_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """16 distinct 1 s clips (a seeded f0, two partials, light noise)."""
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    files = []
    for i in range(16):
        f0 = rng.uniform(80.0, 800.0)
        x = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2.3 * f0 * t) + 0.02 * rng.standard_normal(t.size)
        files.append(str(d / f"c{i}.wav"))
        write_wav(files[-1], x.astype(np.float32))
    csv = str(d / "manifest.csv")
    pd.DataFrame({"files": files}).to_csv(csv, index=False)
    return csv


def _config(name, tmp_path, **pretrain):
    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"]["base_encoder"]["output_dim"] = D
    cfg["pretrain"].update(pretrain)
    cfg["run"].update(batch_size=4, epochs=2, num_dataloader_workers=2, log_every=1)
    path = str(tmp_path / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _run(upstream, cfg_path, tmp_path, run_name, steps, resume=None):
    argv = ["--upstream", upstream, "--input", cfg_path[1], "-c", cfg_path[0], "--device", "cpu",
            "--save_path", str(tmp_path / run_name)]
    argv += ["--max_steps", str(steps)] if steps else []
    train_main(argv + (["--load_checkpoint", resume] if resume else []))
    ckpt = str(tmp_path / f"{run_name}_chkp")
    with open(os.path.join(ckpt, "stats.jsonl")) as f:
        return ckpt, [json.loads(line) for line in f]


def test_decar_cli_trains_and_resumes_exactly(manifest, tmp_path):
    """6 steps straight (the second epoch re-clusters a bank the first
    refreshed) against 3 steps, a resume mid-epoch 0, and 3 more."""
    cfg = (_config("decar_v2", tmp_path, feat_dim=8, nmb_prototypes=[4, 3], freeze_prototypes_niters=2), manifest)
    straight, lines = _run("decar_v2", cfg, tmp_path, "a", 6)
    half, _ = _run("decar_v2", cfg, tmp_path, "b", 3)
    resumed, resumed_lines = _run("decar_v2", cfg, tmp_path, "b", 6, resume=half)
    losses = [line["train_loss"] for line in lines]
    assert len(losses) == 6 and all(np.isfinite(losses)) and [line["train_loss"] for line in resumed_lines] == losses
    a = torch.load(os.path.join(straight, "state", "6.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "state", "6.pt"), weights_only=True)
    for k, v in a["objective"].items():
        assert torch.equal(v, b["objective"][k]), k
    for k in ("emb", "index"):
        assert torch.equal(a["memory"][k], b["memory"][k]), k
    assert torch.equal(a["assignments"], b["assignments"]) and a["epoch_step"] == b["epoch_step"] == 2
    assert a["assignments"].shape == (2, 16) and bool((a["assignments"] >= 0).all())  # every clip assigned
    index = a["memory"]["index"]
    assert bool(((index >= 0) & (index < 16)).all())  # every slot filled: the bank pass, then the steps
    enc = torch.load(os.path.join(straight, "encoder", "6.pt"), weights_only=True)
    AudioNTT2020Task6(n_mels=64, d=D).load_state_dict(enc, strict=True)


def test_deepcluster_cli_trains_resumes_and_feeds_pseudo_labels(manifest, tmp_path):
    """2 epochs straight against 1 epoch resumed into the second; then
    make_pseudo_labels on the checkpoint: its CSV is a labelled manifest
    UnFuSeD trains on, its centroids drive Kmix in DeLoRes-S."""
    cfg = (_config("decar_v1", tmp_path, num_clusters=3), manifest)
    straight, lines = _run("decar_v1", cfg, tmp_path, "a", None)
    with open(cfg[0]) as f:
        one = yaml.safe_load(f)
    one["run"]["epochs"] = 1
    one_path = str(tmp_path / "one_epoch.yaml")
    with open(one_path, "w") as f:
        yaml.safe_dump(one, f)
    half, _ = _run("decar_v1", (one_path, manifest), tmp_path, "b", None)
    resumed, resumed_lines = _run("decar_v1", cfg, tmp_path, "b", None, resume=half)
    assert len(lines) == 8 and all(np.isfinite(line["train_loss"]) and line["kmeans_loss"] > 0 for line in lines)
    assert [line["train_loss"] for line in resumed_lines] == [line["train_loss"] for line in lines]
    a = torch.load(os.path.join(straight, "state", "8.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "state", "8.pt"), weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    for k, v in a["encoder"].items():
        assert torch.equal(v, b["encoder"][k]), k

    labelled, cents = str(tmp_path / "labelled.csv"), str(tmp_path / "centroids.npy")
    out = pseudo_main(["--csv", manifest, "--checkpoint", straight, "--out", labelled, "--clusters", "3",
                       "--output_dim", str(D), "--batch_size", "4", "--save_centroids", cents, "--device", "cpu"])
    loader = ManifestLoader(labelled, batch_size=4, clip_samples=15200, labeled=True)
    assert loader.num_samples == 16 and sorted(set(loader.labels.tolist())) == sorted(set(out["labels"].tolist()))
    assert np.load(cents).shape == (len(set(out["labels"].tolist())), 64)
    unfused = (_config("unfused", tmp_path, task_label=3, num_negatives=16), labelled)
    _, unfused_lines = _run("unfused", unfused, tmp_path, "u", 2)
    kmix = _config("delores_s_kmix", tmp_path, projection_dim=32)
    with open(kmix) as f:
        k_cfg = yaml.safe_load(f)
    k_cfg["pretrain"]["augmentations"]["Kmix"].update(centroid_path=cents, top_k=4)
    with open(kmix, "w") as f:
        yaml.safe_dump(k_cfg, f)
    _, kmix_lines = _run("delores_s", (kmix, manifest), tmp_path, "k", 2)
    assert all(np.isfinite(line["train_loss"]) for line in unfused_lines + kmix_lines)
    assert len(unfused_lines) == len(kmix_lines) == 2


KNOBS = {"tp": ({"pretrain": {"tp": 2, "base_encoder": {"type": "MAST"}}}, "pretrain.tp.*no tensor-parallel path"),
         "fsdp": ({"run": {"fsdp": True}}, "run.fsdp is run by train_upstream .*no fully sharded path"),
         "zero": ({"run": {"zero_optimizer": True}}, "run.zero_optimizer is run by train_upstream only.*no ZeRO path")}
# what the generic trainer, which runs every knob, still refuses of each: fsdp on
# DeLoRes-S's stateful augmentation and ZeRO with LARS (JAX's ValueErrors)
GENERIC = {"fsdp": ({}, "run.fsdp requires stateless augmentation"),
           "zero": ({"optimizer": "lars"}, "zero_optimizer supports elementwise optimizers")}


def _with(cfg, extra):
    out = copy.deepcopy(cfg)
    for section, kv in extra.items():
        for k, v in kv.items():
            if isinstance(v, dict):
                out[section].setdefault(k, {}).update(v)
            else:
                out[section][k] = v
    return out


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_parallel_knob_is_refused_by_every_trainer(knob, manifest):
    """A knob a trainer does not run raises NotImplementedError before any
    data is read: ``pretrain.tp``, ``run.fsdp`` and ``run.zero_optimizer``
    in DECAR and DeepCluster, which have no such path in JAX either. The
    generic trainer runs all three (tests/test_torch_port_tp.py,
    tests/test_torch_port_fsdp_zero.py) and keeps JAX's ValueErrors, before
    any data is read too: tp on a world it does not divide, fsdp on
    DeLoRes-S's stateful augmentation, ZeRO with LARS."""
    extra, match = KNOBS[knob]
    for upstream, trainer in (("delores_s", lambda c: train_upstream(c, manifest, "delores_s", device="cpu")),
                              ("decar_v2", lambda c: train_decar(c, manifest, device="cpu")),
                              ("decar_v1", lambda c: train_deepcluster_v1(c, manifest, device="cpu"))):
        if knob == "tp" and upstream == "delores_s":
            upstream, trainer = "ssmast", lambda c: train_upstream(c, manifest, "ssmast", device="cpu")
        with open(os.path.join(ROOT, "configs", f"{upstream}.yaml")) as f:
            cfg = _with(yaml.safe_load(f), extra)
        if upstream == "ssmast":
            with pytest.raises(ValueError, match="1 devices not divisible by pretrain.tp=2"):
                trainer(cfg)
            continue
        if upstream == "delores_s":
            pre_or_run, generic_match = GENERIC[knob]
            cfg["run"].update(pre_or_run)
            with pytest.raises(ValueError, match=generic_match):
                trainer(cfg)
            continue
        with pytest.raises(NotImplementedError, match=match):
            trainer(cfg)


@pytest.mark.parametrize("extra,match", [
    ({"pretrain": {"tp": 2}}, "requires base_encoder.type: MAST"),
    ({"pretrain": {"tp": 2, "base_encoder": {"type": "MAST"}}, "run": {"zero_optimizer": True}}, "incompatible"),
    ({"pretrain": {"tp": 2, "base_encoder": {"type": "MAST"}}, "run": {"fsdp": True}}, "mutually exclusive"),
    ({"run": {"fsdp": True, "zero_optimizer": True}}, "incompatible"),
])
def test_parallel_knob_exclusions_raise_first(extra, match, manifest):
    """JAX's ValueErrors for the knobs' combinations come before the refusal."""
    with open(os.path.join(ROOT, "configs", "delores_s.yaml")) as f:
        cfg = _with(yaml.safe_load(f), extra)
    with pytest.raises(ValueError, match=match):
        train_upstream(cfg, manifest, "delores_s", device="cpu")
