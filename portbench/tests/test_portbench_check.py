"""The output check at tiny sizes on the CPU: the reference agrees with the
port's plain versions, the run comes out correct, and it comes out not
correct with the control (the reference at the precision below the
configuration's) in the program's place and with each fault a cell can
have planted under its timed path."""
import contextlib
import io
import json
import time

import numpy as np
import pytest
import torch

from portbench.loops import train_common
from portbench.harness import check, runner
from portbench.reference import frontend as ref_frontend
from portbench.reference import models as ref_models
from portbench.reference.precision import Precision
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 12345


def run(cell, monkeypatch=None) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert runner.run_cell(cell, SEED, 0.5, False, time.perf_counter(), CPU) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_reference_models_match_the_port():
    from audiossl_tpu_torch.models.ast import ASTEncoder
    from audiossl_tpu_torch.models.mast import MASTEncoder

    torch.manual_seed(0)
    x = torch.randn(2, 1, 64, 256)
    m = MASTEncoder(64, 256, "tiny", compute_dtype=None).eval()
    arch = dict(embed_dim=96, depth=10, num_heads=1, stage_blocks=[1, 3, 8], droppath_rate=0.1, patch=16, stride=10)
    with torch.no_grad():
        assert torch.allclose(m(x), ref_models.encoder_forward("MAST", x, dict(m.state_dict()), arch), atol=1e-5)
    a = ASTEncoder(64, 256, "tiny").eval()
    with torch.no_grad():
        got = ref_models.encoder_forward("AST", x, dict(a.state_dict()), dict(depth=12, num_heads=3, stride=10))
        assert torch.allclose(a(x), got, atol=1e-5)


def test_reference_frontends_match_the_port():
    from audiossl_tpu_torch.frontend.fbank import FbankConfig, kaldi_fbank, pad_or_trim_frames
    from audiossl_tpu_torch.frontend.stft import LogMelConfig, log_mel

    w = 0.1 * torch.randn(2, 32000, generator=torch.Generator().manual_seed(1))
    fb = pad_or_trim_frames(kaldi_fbank(w, FbankConfig()), 256).transpose(1, 2)
    assert (ref_frontend.kaldi_fbank(w, 128, 16000, 256) - fb).abs().max() < 1e-3
    assert (ref_frontend.log_mel(w, 128) - log_mel(w, LogMelConfig(n_mels=128))).abs().max() < 1e-4


def failed(numbers: dict, limits: dict) -> bool:
    return any(v > limits[n] for n, v in numbers.items() if n in limits)


@pytest.mark.parametrize("name", ["mast_b.ssmast_b256", "ast_base.finetune_b32"])
def test_training_cells(name, monkeypatch):
    cell = tiny.cell(name)
    assert run(cell)["correct"]
    from portbench.loops import probe_train, ssmast_train

    loop = (ssmast_train if cell.loop == "ssmast_train" else probe_train).Loop(cell, SEED, CPU)
    loop.release()
    loop.checks()
    ref, prec = loop.ref, cell.config["precision"]
    taps, weights, prefix = loop.stage_source()
    # each control: the reference one precision below one the configuration states, in the program's place
    for kw in prec["controls"].values():
        control = Precision(**kw)
        numbers = train_common.training_numbers(loop.reference(control), ref)
        numbers.update(check.stage_numbers(cell.config["stages"], taps, weights, prefix, cell.config["encoder"],
                                           Precision(**prec["stage"]), control))
        assert failed(numbers, cell.limits), (kw, numbers)
    # half of the batch left out, the mean taken over the rest
    got = train_common.training_numbers(loop.reference(Precision("f32"), half_batch=True), ref)
    assert failed(got, cell.limits), got
    # the queue never advanced, the key encoder's EMA skipped, read from the state
    faults = train_common.faults_of_state(loop.prog, ref, getattr(loop, "queue0", lambda: None)())
    assert set(faults) == ({"frozen_queue", "no_ema"} if cell.loop == "ssmast_train" else set())
    for numbers in faults.values():
        assert failed(numbers, cell.limits), numbers


@pytest.mark.parametrize("name", ["mast_b.ssmast_b256", "ast_base.finetune_b32"])
def test_training_faults_fail(name, monkeypatch):
    cell = tiny.cell(name)
    # a step that returns its state unchanged
    with monkeypatch.context() as m:
        for opt in (torch.optim.Adam, torch.optim.AdamW):
            m.setattr(opt, "step", lambda self, closure=None: None)
        r = run(cell)
    assert not r["correct"] and r["checks"]["change_gap"]["value"] > 0.9
    # the loss over half of the batch
    if cell.loop == "ssmast_train":
        from audiossl_tpu_torch.objectives import ssmast as mod

        orig, name_ = mod.info_nce, "info_nce"
        half = lambda q, k, queue, t: orig(q[: len(q) // 2], k[: len(k) // 2], queue, t)  # noqa: E731
    else:
        from audiossl_tpu_torch.downstream import probe as mod

        orig, name_ = mod.cross_entropy, "cross_entropy"
        half = lambda logits, labels: orig(logits[: len(logits) // 2], labels[: len(labels) // 2])  # noqa: E731
    with monkeypatch.context() as m:
        m.setattr(mod, name_, half)
        assert not run(cell)["correct"]
    if cell.loop != "ssmast_train":
        return
    # the queue never advanced; the key encoder's EMA skipped
    with monkeypatch.context() as m:
        m.setattr(mod, "queue_update", lambda queue, ptr, keys: (queue, ptr))
        r = run(cell)
    assert not r["correct"] and r["checks"]["queue_gap"]["value"] > 0.5
    with monkeypatch.context() as m:
        m.setattr(mod.SSMast, "_ema_", lambda self, momentum: None)
        r = run(cell)
    assert not r["correct"] and r["checks"]["key_gap"]["value"] > 0.9


@pytest.mark.parametrize("name", ["ast_base.serve_open", "mast_b.embed_b256"])
def test_serving_cells(name, monkeypatch):
    from audiossl_tpu_torch.serve import export

    cell = tiny.cell(name)
    assert run(cell)["correct"]
    orig = export.ServingEncoder.__call__

    def altered(self, waves):  # an answer altered where it is produced
        out = orig(self, waves)
        out[0] = out[0] * 1.2
        return out

    def half_left_out(self, waves):  # half of the batch's answers missing
        out = orig(self, waves)
        out[len(out) // 2:] = 0.0
        return out

    for fault in (altered, half_left_out):
        with monkeypatch.context() as m:
            m.setattr(export.ServingEncoder, "__call__", fault)
            assert not run(cell)["correct"]


@pytest.mark.parametrize("name", ["ast_base.serve_open", "mast_b.embed_b256"])
def test_serving_controls_fail(name):
    from portbench.loops import embed_closed, serve_open

    cell = tiny.cell(name)
    loop = (serve_open if cell.loop == "serve_open" else embed_closed).Loop(cell, SEED, CPU)
    loop.window(0.5)
    loop.release()
    numbers = loop.checks()
    assert all(v <= limit for _, v, limit in numbers)
    prec, waves = cell.config["precision"], loop.checked[0]
    ref = loop.served.reference(waves, Precision(**prec["reference"]))
    taps, weights, prefix = loop.stage_source()
    for kw in prec["controls"].values():
        control = Precision(**kw)
        got = {"emb_gap": check.row_gap(loop.served.reference(waves, control), ref)}
        got.update(check.stage_numbers(cell.config["stages"], taps, weights, prefix, cell.config["encoder"],
                                       Precision(**prec["stage"]), control))
        assert failed(got, cell.limits), (kw, got)


def test_stage_not_reached_fails():
    cell = tiny.cell("ast_base.finetune_b32")
    cell.config["stages"][0] = dict(cell.config["stages"][0], input_of="blocks.5.attn.qkv")  # never called as a module
    r = run(cell)
    assert not r["correct"] and r["checks"]["mlp_gap"]["value"] == float("inf")


def test_leaf_gap_uses_the_median_leaf():
    prog = {"a": 1.0, "b": 2.0, "c": 1e-9}
    ref = {"a": 1.0, "b": 1.0, "c": 0.0}
    gap, leaf = check.leaf_gap(prog, ref)
    assert leaf == "b" and gap == 1.0
    assert check.moved_leaves(ref) == {"a", "b"}
    assert check.rel_gap([1.0, 2.0], [1.0, 2.2]) == pytest.approx(0.2 / 2.2)
    assert check.row_gap(torch.tensor([[1.0, 0.0]]), torch.tensor([[1.0, 1.0]])) == pytest.approx(2 ** -0.5)
    assert np.isfinite(gap)
