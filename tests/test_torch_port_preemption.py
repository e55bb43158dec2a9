"""The port's preemption guard (train/preemption.py) and the trainers that
install it: SIGTERM only sets a flag, the previous handler comes back on
exit, and off the main thread the guard is a no-op that logs a warning. A
SIGTERM sent to this process inside the DeLoRes-S loop (train/loop.py) and
inside the MAST fine-tune's loop (train/finetune_mast.py) leads to one
checkpoint at the step of the next log-cadence check, a normal return, and a
resume that ends on the state of a run never stopped, bit for bit
(tests/test_preemption.py is the JAX package's). The signal is sent from the
step itself, after a chosen step, so the stop step is known; a SIG_IGN
fallback stays installed under the guard, so a guard that failed to install
would fail the test rather than end the process."""
import json
import logging
import os
import shutil
import signal
import threading

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.mvit import MViTConfig
from audiossl_tpu_torch.train.preemption import PreemptionGuard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def sigterm_ignored():
    """SIG_IGN under the guard: a signal that reaches no guard is dropped."""
    prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    yield
    signal.signal(signal.SIGTERM, prev)


def test_sigterm_sets_the_flag_and_the_handler_comes_back(sigterm_ignored):
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert guard.installed and not guard.requested_locally() and guard.should_stop() is False
        os.kill(os.getpid(), signal.SIGTERM)  # the real handler, run at the next bytecode boundary
        assert guard.requested_locally() and guard.should_stop()
    assert signal.getsignal(signal.SIGTERM) is before


def test_guard_off_the_main_thread_is_a_no_op(caplog):
    caplog.set_level(logging.WARNING, logger="audiossl_tpu_torch.preemption")
    before = signal.getsignal(signal.SIGTERM)
    seen = {}

    def body():
        with PreemptionGuard() as guard:
            seen["installed"], seen["stop"] = guard.installed, guard.should_stop()
            seen["handler"] = signal.getsignal(signal.SIGTERM)

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert seen == {"installed": False, "stop": False, "handler": before}
    assert "off main thread" in caplog.text


def _kill_after(monkeypatch, cls, n_calls):
    """Send SIGTERM to this process right after the ``n_calls``-th step."""
    orig = cls.__call__
    count = {"n": 0}

    def step(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        count["n"] += 1
        if count["n"] == n_calls:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(cls, "__call__", step)


def _states(ckpt_dir):
    return sorted(int(n[:-3]) for n in os.listdir(os.path.join(ckpt_dir, "state")))


def _load(ckpt_dir, step):
    return torch.load(os.path.join(ckpt_dir, "state", f"{step}.pt"), weights_only=True)


def _equal_tensors(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_tensors(x, y) for x, y in zip(a, b))
    return a == b


def test_delores_s_loop_checkpoints_and_returns_on_sigterm(tmp_path, monkeypatch, sigterm_ignored):
    """DeLoRes-S at d=32, B=4, 4 steps an epoch of 50, log_every 2: SIGTERM
    after step 3 stops the run at step 4 with one checkpoint (step 4; no
    epoch-end save after it); the resume to step 7 equals a straight run to
    7 bit for bit."""
    from audiossl_tpu_torch.train.loop import train_upstream
    from audiossl_tpu_torch.train.step import TrainStep

    rng = np.random.default_rng(0)
    files = []
    for i in range(16):
        t = np.arange(int(16000 * rng.uniform(0.8, 1.5))) / 16000.0
        files.append(str(tmp_path / f"s{i}.wav"))
        write_wav(files[-1], (0.5 * np.sin(2 * np.pi * (110 + 40 * i) * t)).astype(np.float32))
    csv = str(tmp_path / "m.csv")
    pd.DataFrame({"files": files}).to_csv(csv, index=False)
    with open(os.path.join(ROOT, "configs", "delores_s.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"]["base_encoder"].update(output_dim=32, compute_dtype="float32")
    cfg["pretrain"]["projection_dim"] = 32
    cfg["run"].update(batch_size=4, epochs=50, num_dataloader_workers=2, log_every=2,
                      save_path=str(tmp_path / "pre"))

    with monkeypatch.context() as m:
        _kill_after(m, TrainStep, 3)
        _, step, stopped = train_upstream(cfg, csv, "delores_s", save_every=0, device="cpu")
    assert step == 4 and _states(stopped) == [4]
    _, step, resumed = train_upstream(cfg, csv, "delores_s", load_checkpoint=stopped, max_steps=7, save_every=0,
                                      device="cpu")
    cfg["run"]["save_path"] = str(tmp_path / "straight")
    _, step2, straight = train_upstream(cfg, csv, "delores_s", max_steps=7, save_every=0, device="cpu")
    assert step == step2 == 7
    a, b = _load(straight, 7), _load(resumed, 7)
    for key in ("objective", "optimizer", "augment", "generator", "loader"):
        assert _equal_tensors(a[key], b[key]), key


def test_finetune_loop_checkpoints_and_returns_on_sigterm(tmp_path, monkeypatch, sigterm_ignored):
    """The MAST fine-tune (tiny cut to 4 blocks, every augmentation on, B=4,
    4 steps an epoch, log_every 2, an eval set): SIGTERM after step 1 stops
    the epoch at step 2, whose save is the only checkpoint and has no eval in
    its stats; the resume to step 6 equals a straight run to 6 bit for bit."""
    from tests.test_torch_port_finetune_cli import _config, _run
    from audiossl_tpu_torch.train import finetune_mast as ft

    monkeypatch.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
    root = tmp_path / "data"
    root.mkdir()
    mids = [f"/m/{i}" for i in range(3)]
    (root / "labels.csv").write_text("index,mid,display_name\n" + "".join(f"{i},{m},c{i}\n" for i, m in enumerate(mids)))
    rows = []
    for i in range(20):
        wav = str(root / f"c{i}.wav")
        write_wav(wav, (0.3 * np.sin(2 * np.pi * (200 + 150 * (i % 3)) * np.arange(8000) / 16000)).astype(np.float32))
        rows.append({"wav": wav, "labels": mids[i % 3]})
    for name, sl in (("train.json", slice(0, 16)), ("eval.json", slice(16, 20))):
        (root / name).write_text(json.dumps({"data": rows[sl]}))
    cfg, path = _config(tmp_path, epochs=50, log_every=2)

    with monkeypatch.context() as m:
        _kill_after(m, ft.FinetuneStep, 1)
        stats, stopped = _run(root, path, tmp_path, "ft")
    assert stats["epoch"] == 0 and "mAP" not in stats and _states(stopped) == [2]
    _run(root, path, tmp_path, "ft", 6, resume=stopped)
    _run(root, path, tmp_path, "straight", 6)
    a, b = _load(str(tmp_path / "straight_chkp"), 6), _load(stopped, 6)
    for key in ("model", "optimizer", "generator", "loader"):
        assert _equal_tensors(a[key], b[key]), key
    shutil.rmtree(tmp_path, ignore_errors=True)  # its checkpoints, hundreds of MB: a whole run's disk stays bounded


def test_clustering_trainers_stop_on_sigterm(tmp_path, monkeypatch, sigterm_ignored):
    """DECAR-v2 and DeepCluster-v1 (d=32, B=4, 4 steps an epoch, log_every 1):
    SIGTERM after step 1 stops each at step 1 with its epoch-end save. DECAR's
    records the loader after batch 1 (its resume continues the epoch);
    DeepCluster's records epoch 0, not 1: it is epoch-granular, so a resume
    re-runs the interrupted epoch (JAX's deepcluster_loop.py:268-272)."""
    from audiossl_tpu_torch.train.decar_loop import DecarStep, train_decar
    from audiossl_tpu_torch.train.deepcluster_loop import train_deepcluster_v1
    from audiossl_tpu_torch.train.step import TrainStep

    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    files = []
    for i in range(16):
        files.append(str(tmp_path / f"c{i}.wav"))
        write_wav(files[-1], (0.4 * np.sin(2 * np.pi * rng.uniform(80, 800) * t)).astype(np.float32))
    csv = str(tmp_path / "m.csv")
    pd.DataFrame({"files": files}).to_csv(csv, index=False)

    def config(name, **pretrain):
        with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg["pretrain"]["base_encoder"]["output_dim"] = 32
        cfg["pretrain"].update(pretrain)
        cfg["run"].update(batch_size=4, epochs=2, num_dataloader_workers=2, log_every=1,
                          save_path=str(tmp_path / name))
        return cfg

    with monkeypatch.context() as m:
        _kill_after(m, DecarStep, 1)
        _, step, ckpt = train_decar(config("decar_v2", feat_dim=8, nmb_prototypes=[4, 3]), csv, device="cpu")
    saved = _load(ckpt, 1)
    assert step == 1 and _states(ckpt) == [1] and saved["loader"]["epoch"] == 0 and saved["loader"]["batch"] == 1
    with monkeypatch.context() as m:
        _kill_after(m, TrainStep, 1)
        _, step, ckpt, _ = train_deepcluster_v1(config("decar_v1", num_clusters=3), csv, device="cpu")
    assert step == 1 and _states(ckpt) == [1] and _load(ckpt, 1)["epoch"] == 0
