"""The port's SS-MAST objective (audiossl_tpu_torch.objectives.ssmast)
against the JAX package's on the CPU: MAST tiny at 64 mels x 96 frames, f32,
drop path 0, B = 2, a 64-key queue. The loss of one step on both view paths
(batched and sequential) with its gradients and the MoCo state it leaves
(key encoder, queue, pointer), and a 4-step AdamW trajectory; then the CLI
on WAVs: train, checkpoint, resume bit for bit, export. The JAX side runs
the XLA attention path, the port's the autograd Function over the kernels'
plain versions. Inputs are numpy from a seed."""
import copy
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import yaml

from audiossl_tpu.objectives.ssmast import SSMast as JaxSSMast
from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.models.convert import mast_with_head_from_flax
from audiossl_tpu_torch.objectives import init_objective
from audiossl_tpu_torch.train_upstream import main as train_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F_, T_ = 2, 64, 96
TOL_LOSS = 1e-5  # relative
TOL_TRAJ = 1e-4  # relative to max(1, max|ref|)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread for these tiny models: with the suite's
    workers sharing the cores, torch's default of a thread a core makes each
    small op wait for threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(batched: bool):
    with open(os.path.join(ROOT, "configs", "ssmast.yaml")) as f:
        cfg = yaml.safe_load(f)
    pre = cfg["pretrain"]
    pre.update(model_size="tiny", num_negatives=64, contrastive_dim=16, droppath_rate=0.0, compute_dtype="f32",
               steps_per_epoch=2, batched_views=batched)
    pre["input"].update(n_mels=F_, target_length=T_)
    return cfg


def _views(seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, 1, F_, T_)).astype(np.float32) for _ in range(2)]


@functools.lru_cache(maxsize=2)
def _jax_side(batched: bool):
    """The JAX objective's (params, ssl state, jitted value_and_grad), compiled once per view path."""
    jcfg = _config(batched)
    jcfg["pretrain"]["fused_attention"] = "off"
    jobj = JaxSSMast(jcfg, axis_name=None)
    nhwc = lambda v: jnp.asarray(v.transpose(0, 2, 3, 1))
    params, bs, ssl = jax.jit(jobj.init)(jax.random.key(0), tuple(nhwc(v) for v in _views(0)))
    vg = jax.jit(lambda p, s, v1, v2: jobj.value_and_grad(p, bs, s, (nhwc(v1), nhwc(v2)), jax.random.key(1), True, None))
    return params, ssl, vg


def _pair(batched: bool):
    """The JAX side and the port's objective holding the same weights and MoCo state."""
    params, ssl, vg = _jax_side(batched)
    obj = init_objective("ssmast", _config(batched), seed=0).train()
    to_np = lambda t: jax.tree.map(np.asarray, t)
    obj.encoder.load_state_dict(mast_with_head_from_flax(to_np(params["encoder"])))
    obj.encoder_k.load_state_dict(mast_with_head_from_flax(to_np(ssl.params_k)))
    obj.queue.copy_(torch.from_numpy(np.array(ssl.queue)))
    return params, ssl, vg, obj


def _state_close(obj, params, ssl, tol):
    """Weights, queue, pointer and step against the JAX state."""
    ref_q = mast_with_head_from_flax(jax.tree.map(np.asarray, params["encoder"]))
    ref_k = mast_with_head_from_flax(jax.tree.map(np.asarray, ssl.params_k))
    for mod, ref in ((obj.encoder, ref_q), (obj.encoder_k, ref_k)):
        for n, p in mod.state_dict().items():
            want = ref[n].numpy()
            assert np.abs(p.numpy() - want).max() <= tol * max(1.0, np.abs(want).max()), n
    assert np.abs(obj.queue.numpy() - np.asarray(ssl.queue)).max() <= tol
    assert int(obj.queue_ptr) == int(ssl.queue_ptr) and int(obj.step) == int(ssl.step)


@pytest.mark.parametrize("batched", [True, False])
def test_loss_gradients_and_moco_state_match_jax(batched):
    params, ssl, vg, obj = _pair(batched)
    v1, v2 = _views(3)
    (loss_j, aux), g_j = vg(params, ssl, v1, v2)
    loss = obj.loss(torch.from_numpy(v1), torch.from_numpy(v2))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= TOL_LOSS * abs(float(loss_j))
    ref = mast_with_head_from_flax(jax.tree.map(np.asarray, g_j["encoder"]))
    largest = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for n, p in obj.encoder.named_parameters():
        want = ref[n].numpy()
        bound = 1e-3 * np.abs(want).max() + 1e-5 * largest
        assert np.abs(p.grad.numpy() - want).max() <= bound, n
    assert all(p.grad is None for p in obj.encoder_k.parameters())
    # the key weights are an exact EMA; the queue holds unit keys out of a
    # 10-block f32 trunk, which differ at round-off (1e-6)
    _state_close(obj, params, aux.ssl_state, 1e-5)


def test_adamw_trajectory_matches_jax():
    """AdamW at the config's rate, with eps 1e-4 on both sides: some gradients
    are exactly zero (the pooled keys' LayerNorm bias shifts every score of a
    row alike) or round-off small, and at eps 1e-8 AdamW turns the two sides'
    differing round-off there into steps of up to the full rate (3e-4) in
    either direction, 1e-4 apart after 4 steps at 1e-6. The port's AdamW is
    held against optax's at eps 1e-8 in test_torch_port_train.py."""
    params, ssl, vg, obj = _pair(True)
    tx = optax.adamw(3e-4, b1=0.9, b2=0.999, eps=1e-4, weight_decay=0.0)
    opt_state = tx.init(params)
    trainable = [p for p in obj.parameters() if p.requires_grad]
    assert len(trainable) == len(list(obj.encoder.parameters()))
    opt = torch.optim.AdamW(trainable, lr=3e-4, betas=(0.9, 0.999), eps=1e-4, weight_decay=0.0)
    for step in range(4):
        v1, v2 = _views(10 + step)
        (_, aux), g = vg(params, ssl, v1, v2)
        updates, opt_state = tx.update(g, opt_state, params)
        params, ssl = optax.apply_updates(params, updates), aux.ssl_state
        opt.zero_grad(set_to_none=True)
        obj.loss(torch.from_numpy(v1), torch.from_numpy(v2)).backward()
        opt.step()
    assert int(obj.queue_ptr) == 4 * 2 * B and int(obj.step) == 4
    _state_close(obj, params, ssl, TOL_TRAJ)


def test_init_and_config_guards():
    cfg = _config(True)
    obj = init_objective("ssmast", cfg, seed=0)
    norms = obj.queue.norm(dim=0)
    torch.testing.assert_close(norms, torch.ones_like(norms))
    for pk, p in zip(obj.encoder_k.parameters(), obj.encoder.parameters()):
        assert torch.equal(pk, p) and not pk.requires_grad and p.requires_grad
    ln = obj.encoder.mast.blocks[0].norm1
    assert torch.equal(ln.weight, torch.ones_like(ln.weight)) and not ln.bias.any()
    rel = obj.encoder.mast.blocks[0].attn.rel_pos_h.detach()
    assert rel.abs().max() <= 0.04 and 0.01 < float(rel.std()) < 0.02
    accum = copy.deepcopy(cfg)
    accum["pretrain"]["grad_accum_steps"] = 2  # builds; a batch of 3 it does not divide raises JAX's ValueError
    with pytest.raises(ValueError, match="not divisible by pretrain.grad_accum_steps 2"):
        init_objective("ssmast", accum, seed=0).loss_and_backward(torch.zeros(3, 1, F_, T_), torch.zeros(3, 1, F_, T_))
    with pytest.raises(ValueError, match="divisible"):  # 64 queue slots, batches of 3
        obj.loss(torch.zeros(3, 1, F_, T_), torch.zeros(3, 1, F_, T_))


def test_cli_trains_checkpoints_resumes_and_exports(tmp_path):
    """MAST tiny on 1.2 s WAVs (fbank 118 frames, cut to 96), B=2, 2 epochs of
    3 batches: four steps straight against two, then a resume to four; the
    resumed run ends on the same weights, queue and key encoder bit for bit.
    The export is the MAST trunk in the reference layout."""
    from audiossl_tpu_torch.models.convert import mvit_reference_layout
    from audiossl_tpu_torch.models.mast import MASTEncoder

    files = []
    for i in range(6):
        t = np.arange(int(16000 * 1.2)) / 16000.0
        files.append(str(tmp_path / f"w{i}.wav"))
        write_wav(files[-1], (0.4 * np.sin(2 * np.pi * (200 + 90 * i) * t)).astype(np.float32))
    csv = str(tmp_path / "m.csv")
    pd.DataFrame({"files": files}).to_csv(csv, index=False)
    cfg = _config(True)
    cfg["pretrain"]["droppath_rate"] = 0.1  # drop path on: its draws must resume too
    cfg["pretrain"]["input"]["length_wave"] = 1.2
    cfg["run"].update(batch_size=B, epochs=2, num_dataloader_workers=2, log_every=1)
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    def run(name, steps, resume=None):
        argv = ["--upstream", "ssmast", "--input", csv, "-c", path, "--device", "cpu",
                "--max_steps", str(steps), "--save_path", str(tmp_path / name)]
        train_main(argv + (["--load_checkpoint", resume] if resume else []))
        return str(tmp_path / f"{name}_chkp")

    straight = run("a", 4)
    half = run("b", 2)
    resumed = run("b", 4, resume=half)
    a = torch.load(os.path.join(straight, "state", "4.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "state", "4.pt"), weights_only=True)
    assert a["step"] == b["step"] == 4 and int(a["objective"]["queue_ptr"]) == 4 * 2 * B
    assert a["config"]["pretrain"]["steps_per_epoch"] == 3 and "steps_per_epoch" not in cfg["run"]
    for k, v in a["objective"].items():
        assert torch.equal(v, b["objective"][k]), k
    assert any(k.startswith("encoder_k.") for k in a["objective"])
    # AdamW holds moments for the query encoder's parameters only
    assert len(a["optimizer"]["state"]) == sum(1 for k in a["objective"] if k.startswith("encoder."))
    with open(os.path.join(straight, "stats.jsonl")) as f:
        losses = [yaml.safe_load(line)["train_loss"] for line in f]
    assert len(losses) == 4 and all(np.isfinite(losses))

    enc = torch.load(os.path.join(straight, "encoder", "4.pt"), weights_only=True)
    assert "blocks.0.attn.rel_pos_h" in enc and "mlp_fc1.weight" not in enc
    trunk = MASTEncoder(F_, T_, "tiny", compute_dtype=None).eval()
    trunk.load_state_dict(mvit_reference_layout(enc))
    with torch.no_grad():
        z = trunk(torch.randn(3, 1, F_, T_))
    assert z.shape == (3, 768) and torch.isfinite(z).all()
    shutil.rmtree(tmp_path, ignore_errors=True)  # its checkpoints, hundreds of MB: a whole run's disk stays bounded
