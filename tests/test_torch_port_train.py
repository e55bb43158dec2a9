"""The port's DeLoRes-S training path against the JAX package on the CPU:
the manifest loader, the Barlow heads and loss, the objective's loss and
gradients, the optimizers, an 8-step SGD trajectory, and the pretraining
CLI with resume. f32, dropout 0 where the two frameworks are compared;
inputs are numpy from a seed."""
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
from audiossl_tpu.models import heads as jheads
from audiossl_tpu.models.torch_export import projection_to_torch
from audiossl_tpu.objectives.delores_s import DeloresS as JaxDeloresS
from audiossl_tpu.train import optim as joptim
from audiossl_tpu_torch.data.pipeline import ManifestLoader
from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.models import heads
from audiossl_tpu_torch.models.convert import audiontt_from_flax, projection_from_flax
from audiossl_tpu_torch.objectives import init_objective
from audiossl_tpu_torch.train import optim
from audiossl_tpu_torch.train_upstream import main as train_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = 15200  # 0.95 s at 16 kHz: views of 64 mels x 96 frames


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread for these tiny models: with the suite's
    workers sharing the cores, torch's default of a thread a core makes each
    small op wait for threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, D = 8, 64


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------- loader


@pytest.fixture(scope="module")
def wav_manifest(tmp_path_factory):
    """16 sine WAVs of 0.5-2 s (some shorter than a clip, so padding and
    random crops both occur) and a manifest listing them."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    files = []
    for i in range(16):
        n = int(16000 * rng.uniform(0.5, 2.0))
        t = np.arange(n) / 16000.0
        files.append(str(d / f"s{i}.wav"))
        write_wav(files[-1], (0.5 * np.sin(2 * np.pi * (110 + 40 * i) * t)).astype(np.float32))
    csv = str(d / "manifest.csv")
    pd.DataFrame({"files": files}).to_csv(csv, index=False)
    return csv


@pytest.mark.parametrize("wire_dtype", ["float32", "int16"])
def test_loader_matches_jax(wav_manifest, monkeypatch, wire_dtype):
    monkeypatch.setattr(native, "available", lambda: False)  # the JAX loader's NumPy path
    kw = dict(batch_size=5, clip_samples=CLIP, seed=3, wire_dtype=wire_dtype)
    for epoch in (0, 1):
        ref = list(JaxManifestLoader(wav_manifest, num_workers=1, **kw).epoch(epoch))
        for workers in (1, 3):
            got = list(ManifestLoader(wav_manifest, num_workers=workers, native=False, **kw).epoch(epoch))
            assert len(got) == len(ref) == 3
            for (g, gl), (r, rl) in zip(got, ref):
                assert g.dtype == r.dtype and gl is None and rl is None
                np.testing.assert_array_equal(g, r)


def test_loader_resumes_mid_epoch_and_substitutes_silence(wav_manifest, tmp_path):
    df = pd.read_csv(wav_manifest)
    df.loc[2, "files"] = str(tmp_path / "missing.wav")
    loader = ManifestLoader(df, batch_size=4, clip_samples=CLIP, seed=1, num_workers=2, on_error="zeros",
                            native=False)
    full = list(loader.epoch(0))
    it = loader.epoch(0)
    next(it)
    pos = dict(loader.position)
    it.close()
    rest = list(loader.epoch(0, pos["batch"], pos["rng"]))
    assert len(rest) == len(full) - 1
    for (a, _), (b, _) in zip(rest, full[1:]):
        np.testing.assert_array_equal(a, b)
    assert any((w == 0).all() for batch, _ in full for w in batch)
    with pytest.raises(FileNotFoundError):
        list(ManifestLoader(df, batch_size=4, clip_samples=CLIP, num_workers=2, native=False).epoch(0))


def test_loader_options_of_later_items_raise(wav_manifest):
    """host_shard and tar rows are ported (tests/test_torch_port_host_data.py),
    as are labelled manifests and balanced sampling (tests/test_torch_port_probe.py);
    what stays refused: balanced without labels, a host_shard rank outside
    the world, and bare tar rows in a labelled manifest."""
    with pytest.raises(ValueError, match="labeled"):
        ManifestLoader(wav_manifest, 4, CLIP, balanced=True)
    with pytest.raises(ValueError, match="host_shard"):
        ManifestLoader(wav_manifest, 4, CLIP, host_shard=(2, 2))
    with pytest.raises(ValueError, match="bare .tar"):
        ManifestLoader(pd.DataFrame({"files": ["a.tar"], "label": ["x"]}), 4, CLIP, labeled=True)


# ---------------------------------------------------------------- heads and objective


def _config(d=D, dropout=0.0):
    with open(os.path.join(ROOT, "configs", "delores_s.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"]["base_encoder"].update(output_dim=d, compute_dtype="float32", dropout=dropout)
    cfg["pretrain"]["projection_dim"] = d
    return cfg


@pytest.fixture(scope="module")
def jax_delores():
    """(config, JAX objective, params, batch_stats) at d=64 with randomised
    biases and BN affines, and four batches of view pairs [B, 64, 96]."""
    cfg = _config()
    obj = JaxDeloresS(cfg, axis_name=None)
    dummy = jnp.zeros((B, 64, 96, 1), jnp.float32)
    params, batch_stats, _ = obj.init(jax.random.key(0), (dummy, dummy))
    rng = np.random.default_rng(1)

    def perturb(path, v):
        v = np.asarray(v)
        if "'kernel'" in jax.tree_util.keystr(path):
            return v
        return (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    batch_stats = jax.tree_util.tree_map(np.asarray, batch_stats)
    views = [tuple((1.5 * rng.standard_normal((B, 64, 96))).astype(np.float32) for _ in range(2)) for _ in range(4)]
    return cfg, obj, params, batch_stats, views


def _port_objective(cfg, params, batch_stats):
    obj = init_objective("delores_s", cfg, seed=0)
    sd = {f"encoder.{k}": v for k, v in
          audiontt_from_flax({"params": params["encoder"], "batch_stats": batch_stats["encoder"]}).items()}
    sd.update({f"projector.{k}": v for k, v in projection_from_flax(params["projector"], batch_stats["projector"]).items()})
    obj.load_state_dict(sd, strict=True)
    return obj.train()


def _port_grads(params, batch_stats, grads):
    """JAX gradients as the port's named-parameter gradients."""
    enc = audiontt_from_flax({"params": grads["encoder"], "batch_stats": batch_stats["encoder"]})
    proj = projection_from_flax(grads["projector"], batch_stats["projector"])
    return {**{f"encoder.{k}": v for k, v in enc.items()}, **{f"projector.{k}": v for k, v in proj.items()}}


def test_projection_from_flax_equals_projection_to_torch(jax_delores):
    _, _, params, batch_stats, _ = jax_delores
    ours = projection_from_flax(params["projector"], batch_stats["projector"])
    ref = projection_to_torch(params["projector"], batch_stats["projector"])
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    heads.MLPProjector(D, D, D).load_state_dict(ours, strict=True)


def test_barlow_loss_and_projector_match_jax():
    rng = np.random.default_rng(2)
    z1, z2 = (rng.standard_normal((16, 32)).astype(np.float32) for _ in range(2))
    t1, t2 = torch.from_numpy(z1), torch.from_numpy(z2)
    np.testing.assert_allclose(heads.batch_standardize(t1).numpy(), jheads.batch_standardize(jnp.asarray(z1)), atol=1e-5)
    got = float(heads.barlow_loss(t1, t2))
    assert _rel(got, jheads.barlow_loss(jnp.asarray(z1), jnp.asarray(z2))) < 1e-5
    assert _rel(float(heads.barlow_loss(t1, t2, lambd=None)), jheads.barlow_loss(jnp.asarray(z1), jnp.asarray(z2), None)) < 1e-5

    proj = jheads.MLPProjector(hidden=48, out=24, compute_dtype=jnp.float32)
    variables = proj.init(jax.random.key(2), jnp.asarray(z1), True)
    out_j, upd = proj.apply(variables, jnp.asarray(z1), True, mutable=["batch_stats"])
    ours = heads.MLPProjector(32, 48, 24, compute_dtype=torch.float32)
    ours.load_state_dict(projection_from_flax(variables["params"], variables["batch_stats"]), strict=True)
    out = ours.train()(t1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    sd = projection_from_flax(variables["params"], jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
    for k in ("projector.1.running_mean", "projector.1.running_var", "projector.4.running_var"):
        np.testing.assert_allclose(ours.state_dict()[k].numpy(), sd[k].numpy(), atol=1e-6, rtol=1e-5, err_msg=k)


def test_delores_s_loss_and_grads_match_jax(jax_delores):
    cfg, jobj, params, batch_stats, views = jax_delores
    v1, v2 = views[0]

    def loss_fn(p):
        return jobj.loss(p, batch_stats, (), (jnp.asarray(v1)[..., None], jnp.asarray(v2)[..., None]),
                         jax.random.key(1), True, None)

    (loss_j, aux), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    obj = _port_objective(cfg, params, batch_stats)
    loss = obj.loss(torch.from_numpy(v1)[:, None], torch.from_numpy(v2)[:, None])
    loss.backward()
    assert _rel(loss.item(), float(loss_j)) < 1e-5
    want = _port_grads(params, batch_stats, jax.tree_util.tree_map(np.asarray, grads_j))
    named = dict(obj.named_parameters())
    assert sorted(named) == sorted(k for k in want if "running" not in k and "num_batches" not in k)
    # f32 both sides, through five BatchNorms on the statistics of 8 clips,
    # which amplify summation-order differences, plus 1e-5 of the largest
    # gradient for the round-off of gradients that are exactly 0 (a conv bias
    # before batch-statistics BN)
    scale = max(float(np.abs(want[name].numpy()).max()) for name in named)
    for name, p in named.items():
        r = want[name].numpy()
        assert np.abs(p.grad.numpy() - r).max() <= 1e-3 * float(np.abs(r).max()) + 1e-5 * scale, name
    stats = {f"encoder.{k}": v for k, v in audiontt_from_flax(
        {"params": params["encoder"], "batch_stats": jax.tree_util.tree_map(np.asarray, aux.batch_stats["encoder"])}).items()}
    for k, v in stats.items():
        if "running" in k:
            np.testing.assert_allclose(obj.state_dict()[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


def test_eight_step_sgd_trajectory_matches_optax(jax_delores):
    """8 SGD steps (lr 0.03, momentum 0.9, wd 1e-4) from the same weights on
    the same views, as tests/test_reference_equiv.py runs the reference."""
    cfg, jobj, params, batch_stats, views = jax_delores
    tx = joptim.sgd_torch(0.03)

    @jax.jit
    def step(p, bs, opt_state, v1, v2):
        def loss_fn(q):
            return jobj.loss(q, bs, (), (v1, v2), jax.random.key(1), True, None)

        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), aux.batch_stats, opt_state, loss

    obj = _port_objective(cfg, params, batch_stats)
    opt, _ = optim.build_optimizer("sgd", obj.parameters(), 0.03)
    p, bs, opt_state = params, batch_stats, tx.init(params)
    ours, ref = [], []
    for i in range(8):
        v1, v2 = views[i % len(views)]
        p, bs, opt_state, loss_j = step(p, bs, opt_state, jnp.asarray(v1)[..., None], jnp.asarray(v2)[..., None])
        ref.append(float(loss_j))
        loss = obj.loss(torch.from_numpy(v1)[:, None], torch.from_numpy(v2)[:, None])
        opt.zero_grad()
        loss.backward()
        opt.step()
        ours.append(loss.item())
    rel = np.abs(np.asarray(ours) - ref) / np.abs(ref)
    assert rel[0] < 1e-4
    # f32 summation-order drift compounds step over step through the batch
    # statistics
    assert rel.max() < 1e-4, rel
    final = _port_grads(p, bs, jax.tree_util.tree_map(np.asarray, p))  # the JAX weights in the port's names
    for name, q in obj.named_parameters():
        assert _rel(q.detach().numpy(), final[name].numpy()) < 1e-4, name


def test_optimizers_and_schedule_match_optax():
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    sched_j = joptim.warmup_cosine(0.1, 20, 4)
    sched = optim.warmup_cosine(0.1, 20, 4)
    for s in (0, 1, 3, 4, 5, 12, 19, 20):
        assert abs(sched(s) - float(sched_j(s))) < 1e-7
    cases = [("sgd", 0.03, joptim.sgd_torch(0.03)), ("adam", 0.01, joptim.adam_torch(0.01)),
             ("adamw", 0.01, joptim.adamw_torch(0.01)), ("sgd", sched, joptim.sgd_torch(sched_j))]
    for name, lr, tx in cases:
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt, scheduler = optim.build_optimizer(name, [p], lr)
        q, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
        for g in grads:
            p.grad = torch.from_numpy(g)
            opt.step()
            if scheduler is not None:
                scheduler.step()
            upd, state = tx.update(jnp.asarray(g), state, q)
            q = optax.apply_updates(q, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), atol=1e-6, err_msg=name)
    # LARS and LARC (held to optax in tests/test_torch_port_decar.py) build; a typo raises
    for name, cls in (("lars", optim.Lars), ("larc", optim.Larc)):
        assert isinstance(optim.build_optimizer(name, [torch.nn.Parameter(torch.zeros(1))], 0.1)[0], cls)
    with pytest.raises(KeyError, match="unknown optimizer"):
        optim.build_optimizer("lamb", [torch.nn.Parameter(torch.zeros(1))], 0.1)


# ---------------------------------------------------------------- the CLI


def test_cli_trains_checkpoints_resumes_and_serves(wav_manifest, tmp_path):
    """Two-epoch runs of four batches at d=32 on the CPU: six steps straight
    through against three steps, then a resume to six; the resumed run ends
    on the same weights bit for bit. The exported encoder serves."""
    from audiossl_tpu_torch.frontend import build_frontend
    from audiossl_tpu_torch.serve.export import build_embedder

    cfg = _config(d=32, dropout=0.3)
    cfg["pretrain"]["base_encoder"].pop("compute_dtype")
    cfg["run"].update(batch_size=4, epochs=2, num_dataloader_workers=2, log_every=2)
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    def run(name, steps, resume=None):
        argv = ["--upstream", "delores_s", "--input", wav_manifest, "-c", path, "--device", "cpu",
                "--max_steps", str(steps), "--save_path", str(tmp_path / name)]
        train_main(argv + (["--load_checkpoint", resume] if resume else []))
        return str(tmp_path / f"{name}_chkp")

    straight = run("a", 6)
    half = run("b", 3)
    resumed = run("b", 6, resume=half)
    assert resumed == half
    assert sorted(os.listdir(straight)) == ["config.yaml", "encoder", "state", "stats.jsonl"]
    assert sorted(os.listdir(os.path.join(straight, "state"))) == ["4.pt", "6.pt"]  # epoch-end best, then max_steps
    a = torch.load(os.path.join(straight, "state", "6.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "state", "6.pt"), weights_only=True)
    assert a["step"] == b["step"] == 6 and a["loader"]["epoch"] == 1
    for k, v in a["objective"].items():
        assert torch.equal(v, b["objective"][k]), k
    assert torch.equal(a["augment"]["mixup"]["bank"], b["augment"]["mixup"]["bank"])
    with open(os.path.join(straight, "stats.jsonl")) as f:
        losses = [yaml.safe_load(line)["train_loss"] for line in f]
    assert len(losses) == 6 and all(np.isfinite(losses))

    enc = torch.load(os.path.join(straight, "encoder", "6.pt"), weights_only=True)
    emb = build_embedder(enc, build_frontend(cfg["pretrain"]["input"]), CLIP, torch.float32, device="cpu")
    with torch.no_grad():
        out = emb(torch.from_numpy(np.random.default_rng(0).standard_normal((3, CLIP)).astype(np.float32)))
    assert out.shape == (3, 32) and torch.isfinite(out).all()
