"""The port's supervised MAST fine-tune end to end on the CPU
(``python -m audiossl_tpu_torch.train.finetune_mast --device cpu``), on
AudioSet-style data written from synthetic WAVs (a label CSV, train and
eval JSONs, as tests/test_finetune_mast.py:41-62): train, eval (mAP / AUC /
d'), checkpoint; a resume that ends on the straight run's state bit for bit,
the loader position included; a resume that continues the step counter; the
exported trunk served by ``serve.export --checkpoint`` and probed by
``train_downstream --checkpoint``; the ``norm_stats`` CLI against JAX's; the
refused parallelism knobs (test_torch_port_finetune_trajectory.py holds two
steps against JAX's own trainer). MAST tiny cut to 4 blocks on both sides, 64 mels x 48
frames (0.5 s clips), f32."""
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from audiossl_tpu.models import mast as jmast
from audiossl_tpu.models import mvit as jmvit
from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.mvit import MViTConfig
from audiossl_tpu_torch.train import finetune_mast as ft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASSES, N_TRAIN, N_EVAL, CLIP = 4, 16, 5, 8000


@pytest.fixture(scope="module", autouse=True)
def one_thread_short_tiny():
    """One torch intra-op thread; MAST tiny with 4 blocks on both sides."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmast.VARIANTS, "tiny", lambda **kw: jmvit.MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
        mp.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """labels.csv (index,mid,display_name), train.json (16 clips) and
    eval.json (5 clips: a short last batch at B = 4), 1-2 labels a clip."""
    root = tmp_path_factory.mktemp("asdata")
    mids = [f"/m/{i:02d}" for i in range(N_CLASSES)]
    with open(root / "labels.csv", "w") as f:
        f.write("index,mid,display_name\n" + "".join(f"{i},{m},class{i}\n" for i, m in enumerate(mids)))
    r = np.random.default_rng(29)
    rows = []
    for i in range(N_TRAIN + N_EVAL):
        wav = str(root / f"c{i:02d}.wav")
        t = np.arange(CLIP) / 16000
        w = 0.3 * np.sin(2 * np.pi * (200 + 150 * (i % N_CLASSES)) * t) + 0.02 * r.standard_normal(CLIP)
        write_wav(wav, w.astype(np.float32))
        labels = mids[i % 4] if i % 3 else f"{mids[i % 4]},{mids[(i + 1) % 4]}"
        rows.append({"wav": wav, "labels": labels})
    for name, sl in (("train.json", slice(0, N_TRAIN)), ("eval.json", slice(N_TRAIN, None))):
        with open(root / name, "w") as f:
            json.dump({"data": rows[sl]}, f)
    return root


def _config(tmp_path, **run):
    with open(os.path.join(ROOT, "configs", "mast_ft.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["run"].update({"batch_size": 4, "epochs": 2, "num_dataloader_workers": 2, "log_every": 1, **run})
    cfg["finetune"].update(model_size="tiny", compute_dtype="f32", freqm=8, timem=16)
    cfg["finetune"]["input"].update(n_mels=64, target_length=48, length_wave=0.5)
    path = str(tmp_path / "ft.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg, path


def _run(data, path, tmp_path, name, steps=None, resume=None, extra=()):
    argv = ["--train_json", str(data / "train.json"), "--label_csv", str(data / "labels.csv"),
            "--eval_json", str(data / "eval.json"), "-c", path, "--device", "cpu",
            "--save_path", str(tmp_path / name), *extra]
    if steps:
        argv += ["--max_steps", str(steps)]
    if resume:
        argv += ["--load_checkpoint", resume]
    stats, ckpt_dir = ft.main(argv)
    return stats, ckpt_dir


def _state(ckpt_dir, step):
    return torch.load(os.path.join(ckpt_dir, "state", f"{step}.pt"), weights_only=True)


def _equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_cli_trains_evaluates_checkpoints_and_resumes_bit_for_bit(data, tmp_path):
    """Every augmentation on (mixup, SpecMask, norm, noise, drop path), B = 4,
    4 steps an epoch: 6 steps straight against 2 then a resume to 6 (across
    the epoch's end); the two runs end on the same state bit for bit."""
    _, path = _config(tmp_path)
    stats, straight = _run(data, path, tmp_path, "a", 6)
    assert stats["epoch"] == 1 and np.isfinite(stats["train_loss"])
    assert 0.0 <= stats["mAP"] <= 1.0 and 0.0 <= stats["AUC"] <= 1.0 and np.isfinite(stats["d_prime"])
    _, half = _run(data, path, tmp_path, "b", 2)
    _, resumed = _run(data, path, tmp_path, "b", 6, resume=half)
    a, b = _state(straight, 6), _state(resumed, 6)
    assert a["step"] == b["step"] == 6 and a["loader"]["epoch"] == 1 and a["loader"]["batch"] == 2
    for key in ("model", "optimizer", "generator", "loader"):
        _equal(a[key], b[key], key)
    with open(os.path.join(straight, "stats.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    steps = [rec["step"] for rec in lines if "step" in rec]
    epochs = [rec for rec in lines if "mAP" in rec]
    assert steps == list(range(1, 7)) and [e["epoch"] for e in epochs] == [0, 1]
    enc = torch.load(os.path.join(straight, "encoder", "6.pt"), weights_only=True)
    assert "blocks.0.attn.rel_pos_h" in enc and not any(k.startswith("head") for k in enc)
    with open(os.path.join(straight, "config.yaml")) as f:
        assert yaml.safe_load(f)["finetune"]["model_size"] == "tiny"
    shutil.rmtree(tmp_path, ignore_errors=True)  # its checkpoints, hundreds of MB: a whole run's disk stays bounded


def test_resume_continues_the_step_counter(data, tmp_path):
    """A run of 1 epoch (4 steps), resumed with 2 epochs configured, runs the
    second epoch only: the last checkpoint is at step 8, not 12."""
    _, path = _config(tmp_path, epochs=1)
    _, first = _run(data, path, tmp_path, "c")
    assert sorted(os.listdir(os.path.join(first, "state"))) == ["4.pt"]
    _, again = _run(data, path, tmp_path, "c", resume=first, extra=["--epochs", "2"])
    assert sorted(os.listdir(os.path.join(again, "state"))) == ["4.pt", "8.pt"]
    shutil.rmtree(tmp_path, ignore_errors=True)  # its checkpoints, hundreds of MB: a whole run's disk stays bounded


def test_export_serves_and_probes(data, tmp_path, caplog):
    """The fine-tune's encoder/<step>.pt (the MAST trunk, reference layout)
    serves through ``serve.export --checkpoint`` and is probed through
    ``train_downstream --checkpoint`` at 64 mels x 1 s (a cross-shape
    transplant from 48 frames)."""
    from audiossl_tpu_torch.serve import export as serve
    from audiossl_tpu_torch.train_downstream import main as downstream_main

    _, path = _config(tmp_path, epochs=1)
    _, ckpt = _run(data, path, tmp_path, "d", 1)
    art = str(tmp_path / "enc.pt")
    serve.main(["--checkpoint", ckpt, "--out", art, "--device", "cpu", "--clip_samples", str(CLIP), "--dtype", "f32"])
    artifact = serve.load_artifact(art)
    assert (artifact["encoder_type"], artifact["model_size"], artifact["input_tdim"]) == ("MAST", "tiny", 48)
    waves = np.stack([np.sin(np.arange(CLIP) / (7 + i)).astype(np.float32) for i in range(3)])
    z = serve.ServingEncoder(art, device="cpu")(waves)
    assert z.shape == (3, 768) and np.isfinite(z).all()

    rows = []
    for i in range(8):
        rows.append({"wav": str(tmp_path / f"p{i}.wav"), "label": f"c{i % 2}"})
        t = np.arange(16000) / 16000
        write_wav(rows[-1]["wav"], (0.4 * np.sin(2 * np.pi * (300 + 400 * (i % 2)) * t)).astype(np.float32))
    csv = str(tmp_path / "l.csv")
    pd.DataFrame(rows).to_csv(csv, index=False)
    with open(os.path.join(ROOT, "configs", "downstream.yaml")) as f:
        down = yaml.safe_load(f)
    down["downstream"]["base_encoder"].update(type="MAST", model_size="tiny")
    down["run"]["num_dataloader_workers"] = 2
    down_path = str(tmp_path / "down.yaml")
    with open(down_path, "w") as f:
        yaml.safe_dump(down, f)
    caplog.set_level("INFO", logger="audiossl_tpu_torch.downstream")
    out = downstream_main(["--task", "toy", "--train_csv", csv, "--test_csv", csv, "--checkpoint", ckpt, "-c", down_path,
                           "--encoder", "MAST", "--epochs", "1", "--batch_size", "4", "--exp_dir", str(tmp_path / "exp"),
                           "--device", "cpu", "--freeze"])
    assert "cross-shape encoder transplant" in caplog.text and "(48, 64) -> (101, 64)" in caplog.text
    assert all(np.isfinite(out["losses"]))


def test_norm_stats_cli_matches_jax(data, tmp_path, monkeypatch, capsys):
    """The fbank's mean and std over a manifest, port (f64 sums on the host)
    against JAX's CLI (f32 sums a batch), both at 1e-5 relative."""
    from audiossl_tpu.data import norm_stats as jax_norm_stats
    from audiossl_tpu_torch.data import norm_stats

    csv = str(tmp_path / "m.csv")
    with open(data / "train.json") as f:
        pd.DataFrame({"files": [d["wav"] for d in json.load(f)["data"]]}).to_csv(csv, index=False)
    argv = ["--csv", csv, "--fbank", "--n_mels", "64", "--duration", "0.5", "--target_length", "48",
            "--batch_size", "5"]
    got = norm_stats.main(argv + ["--device", "cpu"])
    monkeypatch.setattr("sys.argv", ["norm_stats"] + argv)
    capsys.readouterr()
    jax_norm_stats.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["n_elements"] == want["n_elements"] == N_TRAIN * 64 * 48
    for k in ("mean", "std"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)


def test_parallel_knobs_are_refused(data, tmp_path):
    """``run.zero_optimizer`` raises NotImplementedError (JAX's fine-tune has
    no ZeRO path; ``--fsdp`` runs, tests/test_torch_port_fsdp_zero.py);
    ``run.world_size: 2`` without a process group of two raises ValueError
    (data parallelism needs the processes started); so does nothing else
    before a step."""
    _, path = _config(tmp_path, zero_optimizer=True)
    with pytest.raises(NotImplementedError, match="run.zero_optimizer is run by train_upstream only.*JAX's fine-tune"):
        _run(data, path, tmp_path, "e", 1)
    cfg, path = _config(tmp_path, world_size=2)
    with pytest.raises(ValueError, match="world_size is 2 but the process group has 1"):
        _run(data, path, tmp_path, "e", 1)
    cfg, path = _config(tmp_path, grad_accum_steps=3)
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps 3"):
        _run(data, path, tmp_path, "e", 1)
