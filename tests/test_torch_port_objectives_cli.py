"""The pretraining CLI on DeLoRes-M (its default upstream), SLICER and
UnFuSeD (a labelled manifest) on the CPU: 2 steps straight through against
1 step and a resume to 2, which must log the same losses and end on the
same state bit for bit; the exported encoder loads into AudioNTT strictly.
d = 32 at batch 4 with a 16-key queue, so the queue wraps within a run."""
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6
from audiossl_tpu_torch.train_upstream import main as train_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
TASK_LABEL = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread for these tiny models: with the suite's
    workers sharing the cores, torch's default of a thread a core makes each
    small op wait for threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """16 sine WAVs of 0.5-2 s and a manifest with a ``label`` column (ids
    0-4; an unlabelled objective reads only ``files``)."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    files = []
    for i in range(16):
        t = np.arange(int(16000 * rng.uniform(0.5, 2.0))) / 16000.0
        files.append(str(d / f"s{i}.wav"))
        write_wav(files[-1], (0.5 * np.sin(2 * np.pi * (110 + 40 * i) * t)).astype(np.float32))
    csv = str(d / "manifest.csv")
    pd.DataFrame({"files": files, "label": [i % TASK_LABEL for i in range(16)]}).to_csv(csv, index=False)
    return csv


def _config(name, tmp_path):
    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"]["base_encoder"]["output_dim"] = D
    cfg["pretrain"].update(num_negatives=16, contrastive_dim=8, instance_contrastive_dim=8, cluster_contrastive_dim=6,
                           task_label=TASK_LABEL)
    cfg["run"].update(batch_size=4, epochs=1, num_dataloader_workers=2, log_every=1)
    path = str(tmp_path / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.mark.parametrize("name", ["delores_m", "slicer", "unfused"])
def test_cli_trains_resumes_and_exports(name, manifest, tmp_path):
    path = _config(name, tmp_path)

    def run(run_name, steps, resume=None):
        argv = ["--input", manifest, "-c", path, "--device", "cpu", "--max_steps", str(steps),
                "--save_path", str(tmp_path / run_name)]
        if name != "delores_m":  # delores_m is the CLI's default upstream
            argv += ["--upstream", name]
        train_main(argv + (["--load_checkpoint", resume] if resume else []))
        ckpt = str(tmp_path / f"{run_name}_chkp")
        with open(os.path.join(ckpt, "stats.jsonl")) as f:
            return ckpt, [json.loads(line)["train_loss"] for line in f]

    straight, losses = run("a", 2)
    half, _ = run("b", 1)
    resumed, resumed_losses = run("b", 2, resume=half)
    assert len(losses) == 2 and all(np.isfinite(losses)) and resumed_losses == losses
    a = torch.load(os.path.join(straight, "state", "2.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "state", "2.pt"), weights_only=True)
    for k, v in a["objective"].items():
        assert torch.equal(v, b["objective"][k]), k
    if name != "unfused":  # 2 steps of 4 (SLICER: 8) keys around the 16-key queue
        assert int(a["objective"]["queue_ptr"]) == (8 if name == "delores_m" else 0)
        assert not torch.equal(a["objective"]["encoder_k.encoder.fc.0.weight"], a["objective"]["encoder.encoder.fc.0.weight"])
    enc = torch.load(os.path.join(straight, "encoder", "2.pt"), weights_only=True)
    AudioNTT2020Task6(n_mels=64, d=D).load_state_dict(enc, strict=True)
