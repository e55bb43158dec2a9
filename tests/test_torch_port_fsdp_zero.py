"""Sharded training state over the data axis on the CPU: gloo ranks of the
port (two ``torch.multiprocessing.spawn``s of 2 ranks started together,
tests/torch_fsdp_zero_worker.py) under ``run.fsdp`` (parallel/fsdp.py) and
``run.zero_optimizer`` (train/zero.py), against the JAX package on 2 of
the 8 host devices tests/conftest.py forces: ``make_train_step_gspmd``'s
step with ``tree_shardings`` (value_and_grad with ``axis_name=None``, the
gradients pinned to the parameter shardings, AdamW), ``make_train_step``'s
ZeRO branch (``zero_init`` and ``zero_update`` in ``shard_map``), and
``train_finetune_mast`` with ``fsdp``; and against the port's own
one-process run. The JAX references are built while the ranks run. f32;
drop path 0 unless said; inputs are numpy from a seed; weights cross through
``models/convert.py``. MAST tiny cut to 2 blocks on both sides; the SS-MAST
queue is [16, 256], so that JAX's rule splits it on K.

Tolerances, each relative to max(1, max|ref|) unless said otherwise:
* the SS-MAST step under fsdp (and with two microbatches) against JAX's
  GSPMD step: the loss 1e-5 relative; each gradient within 1e-3 of its own
  max|ref| + 1e-5 of the largest (tests/test_torch_port_tp.py's bound: some
  gradients are round-off); after AdamW at eps 1e-4 (both sides) the
  parameters, the key tower and the queue 1e-5, the pointer exact, each
  moment by the gradients' bound; the pieces each rank held before the step
  equal JAX's addressable shards exactly;
* the ZeRO steps (DeLoRes-S with SGD on AudioNTT, SS-MAST with AdamW)
  against JAX's ZeRO step: the loss 1e-5 relative, the parameters and
  running statistics 1e-5, rank r's moment slices within 1e-5 of row r of
  JAX's moments carried to the port's layout (``zero.rank_state_from_rows``);
* the fine-tune step under fsdp with the clip engaged, against one port
  process on the same batch: the loss and the clip's global norm 1e-5
  relative, each gradient by the gradients' bound; the CLI's two steps
  against JAX's trainer with ``fsdp`` at world 2: the losses 1e-5 relative,
  the saved parameters 1e-5, both Adam moments by the gradients' bound;
* each planted fault (the gradients reduce-scattered as a sum; the whole
  leaves counted n times in the clip's norm, in one step and in the CLI's
  two against JAX's trainer; a ZeRO slice one row off) must break the
  bound the correct step meets;
* the checkpoint: an fsdp run resumed from step 1 equals the straight run
  at step 2 bit for bit (dense parameters, key tower, queue, moments); its
  export serves at world 1; a ZeRO checkpoint holds [2, k] moment rows and
  its resume at world 1 raises.
"""
import concurrent.futures
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import yaml
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from audiossl_tpu.models import mast as jmast
from audiossl_tpu.models import mvit as jmvit
from audiossl_tpu.objectives.ssmast import SSMast as JaxSSMast
from audiossl_tpu.parallel.fsdp import fsdp_spec as jax_fsdp_spec
from audiossl_tpu.parallel.fsdp import tree_shardings
from audiossl_tpu.train import optim as joptim
from audiossl_tpu.train.zero import zero_init, zero_update
from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.convert import mast_classifier_from_flax, mast_with_head_from_flax
from audiossl_tpu_torch.models.mvit import MViTConfig
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel import fsdp
from audiossl_tpu_torch.train import zero
from tests import torch_fsdp_zero_worker as worker
from tests.test_torch_port_ddp import _delores_s_inputs, _port_delores_s_state
from tests.test_torch_port_finetune_cli import N_CLASSES, data  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MF, MT, B, WORLD = 64, 96, 4, 2
FT_CLIP = 1e-2  # the fine-tune's clip_grad_norm: below the gradient's norm, so the clip scales


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def short_tiny():
    """MAST tiny cut to 2 blocks (the second one pools and doubles the width)
    on both sides; the spawned ranks cut theirs alike."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmast.VARIANTS, "tiny", lambda **kw: jmvit.MViTConfig._variant(2, 0.1, (1,), kw))
        mp.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(2, 0.1, (1,), kw))
        yield


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def _grads_close(got, want, rel=1e-3, of_largest=1e-5):
    """Each tensor within rel of its own max|want| + of_largest of the
    largest; returns the names that are not."""
    largest = max(float(np.abs(w).max()) for w in want.values())
    return [n for n, w in want.items()
            if not np.abs(np.asarray(got[n]) - w).max() <= rel * np.abs(w).max() + of_largest * largest]


def _mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))


def _nhwc(v):
    return jnp.asarray(v.transpose(0, 2, 3, 1))


def _device_trees(tree, mesh):
    """Each device's addressable shard of every leaf, as numpy trees."""
    return [jax.tree.map(lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == dev)), tree)
            for dev in mesh.devices.flat]


# ---------------------------------------------------------------- inputs


def _ssmast_cfg():
    with open(os.path.join(ROOT, "configs", "ssmast.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"].update(model_size="tiny", num_negatives=256, contrastive_dim=16, droppath_rate=0.0,
                           compute_dtype="f32", steps_per_epoch=2, fused_attention="off")
    cfg["pretrain"]["input"].update(n_mels=MF, target_length=MT)
    return cfg


@functools.lru_cache(maxsize=1)
def _ssmast_init():
    cfg = _ssmast_cfg()
    jobj = JaxSSMast(cfg, axis_name=None)
    rng = np.random.default_rng(4)
    v1, v2 = (rng.standard_normal((B, 1, MF, MT)).astype(np.float32) for _ in range(2))
    params, bs, ssl = jax.jit(jobj.init)(jax.random.key(0), (_nhwc(v1[:2]), _nhwc(v2[:2])))
    return cfg, jobj, _np_tree(params), bs, _np_tree(ssl), v1, v2


def _ssmast_state(params, ssl):
    """The port SS-MAST's state_dict from JAX's (params, ssl_state) trees,
    whole or one device's shards."""
    state = {f"encoder.{k}": v for k, v in mast_with_head_from_flax(params["encoder"]).items()}
    state.update({f"encoder_k.{k}": v for k, v in mast_with_head_from_flax(ssl.params_k).items()})
    state.update(queue=torch.from_numpy(np.array(ssl.queue)), queue_ptr=torch.tensor(int(ssl.queue_ptr)),
                 step=torch.tensor(int(ssl.step)))
    return {k: v.numpy() for k, v in state.items()}


def _ssmast_inputs():
    cfg, _, params, _, ssl, v1, v2 = _ssmast_init()
    return {"config": cfg, "state": _ssmast_state(params, ssl), "v1": v1, "v2": v2}


@functools.lru_cache(maxsize=1)
def _delores_s():
    """DeLoRes-S (AudioNTT, d = 32) from the data-parallel test's draws."""
    cfg, jobj, params, bs, v1, v2 = _delores_s_inputs()
    return cfg, jobj, params, bs, v1[:B], v2[:B]


FT = {"model_size": "tiny", "freqm": 0, "timem": 0, "compute_dtype": "f32", "droppath_rate": 0.0,
      "norm_stats": {"mean": -13.9, "std": 5.3},
      "input": {"type": "fbank", "sampling_rate": 16000, "length_wave": 0.5, "n_mels": MF, "target_length": MT,
                "mixup": 0.0, "noise": False}}


@functools.lru_cache(maxsize=1)
def _ft_params():
    """The classifier's initial flax params: SS-MAST's query trunk and a
    seeded head (one MViT init compiled for the file; JAX's trainer is
    handed them in place of its own init)."""
    rng = np.random.default_rng(8)
    encoder = _ssmast_init()[2]["encoder"]
    width = np.shape(encoder["mlp_fc1"]["kernel"])[0]
    return {"mast": encoder["mast"],
            "head_norm": {"scale": (1 + 0.1 * rng.standard_normal(width)).astype(np.float32),
                          "bias": (0.1 * rng.standard_normal(width)).astype(np.float32)},
            "head": {"kernel": (0.05 * rng.standard_normal((width, N_CLASSES))).astype(np.float32),
                     "bias": np.zeros(N_CLASSES, np.float32)}}


def _ft_init():
    return {k: v.numpy() for k, v in mast_classifier_from_flax(_ft_params()).items()}


def _finetune_inputs():
    rng = np.random.default_rng(7)
    return {"ft": FT, "n_classes": N_CLASSES, "state": _ft_init(), "clip": FT_CLIP,
            "waves": (0.3 * rng.standard_normal((8, 8000))).astype(np.float32),
            "targets": (rng.random((8, N_CLASSES)) < 0.4).astype(np.float32)}


def _ft_config(d, fsdp_on=True):
    return {"run": {"batch_size": 8, "epochs": 1, "num_dataloader_workers": 1, "learning_rate": 1e-3,
                    "layer_decay": 0.75, "weight_decay": 0.05, "clip_grad_norm": FT_CLIP, "log_every": 1,
                    "fsdp": fsdp_on, "save_path": str(d)},
            "finetune": copy.deepcopy(FT)}


def _cli_inputs(d):
    files = []
    for i in range(6):
        t = np.arange(int(16000 * 1.2)) / 16000.0
        files.append(str(d / f"w{i}.wav"))
        write_wav(files[-1], (0.4 * np.sin(2 * np.pi * (200 + 90 * i) * t)).astype(np.float32))
    csv = str(d / "m.csv")
    pd.DataFrame({"files": files}).to_csv(csv, index=False)
    out = {"csv": csv, "dir": str(d)}
    for knob in ("fsdp", "zero_optimizer"):
        cfg = _ssmast_cfg()
        cfg["pretrain"].update(droppath_rate=0.1, fused_attention="auto")  # drop path on
        cfg["pretrain"]["input"]["length_wave"] = 1.2
        cfg["run"].update(batch_size=2, epochs=2, num_dataloader_workers=1, log_every=1, **{knob: True})
        out[f"{knob.split('_')[0]}_config"] = path = str(d / f"tiny_{knob}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
    return out


def _ft_cli_inputs(d, ft_data):
    ft_cfg = _ft_config(d / "ft_port")
    ft_cfg["run"].pop("fsdp")  # the CLI's --fsdp sets it
    with open(str(d / "ft.yaml"), "w") as f:
        yaml.safe_dump(ft_cfg, f)
    return {"ft_train": str(ft_data / "train.json"), "ft_labels": str(ft_data / "labels.csv"), "ft_state": _ft_init(),
            "ft_config": str(d / "ft.yaml"), "save_path": str(d / "ft_port")}


def _inputs(d, ft_data):
    """Two spawns' checks: fsdp (and the CLI runs), ZeRO and the fine-tune."""
    ss = _ssmast_inputs()
    accum = copy.deepcopy(ss)
    accum["config"]["pretrain"]["grad_accum_steps"] = 2
    cfg, _, params, bs, v1, v2 = _delores_s()
    ds = {"name": "delores_s", "config": cfg, "state": {k: v.numpy() for k, v in _port_delores_s_state(params, bs).items()},
          "v1": v1, "v2": v2}
    ftd = _finetune_inputs()
    ft_cli = _ft_cli_inputs(d, ft_data)
    return {"a": {"ssmast_fsdp": ss, "ssmast_fsdp_accum": accum,
                  "ssmast_fsdp_sum_reduce_scatter": {**ss, "fault": "sum_reduce_scatter"},
                  "cli": _cli_inputs(d), "finetune_cli": {**ft_cli, "resume": True}},
            "b": {"zero_ssmast": {**ss, "name": "ssmast"},
                  "zero_ssmast_zero_row_offset": {**ss, "name": "ssmast", "fault": "zero_row_offset"},
                  "zero_delores_s": ds, "finetune_fsdp": ftd,
                  "finetune_fsdp_replicated_n_times": {**ftd, "fault": "replicated_n_times"},
                  "finetune_cli_replicated_n_times": {**ft_cli, "fault": "replicated_n_times",
                                                      "save_path": str(d / "ft_fault")}}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data):  # noqa: F811 (the fine-tune's data fixture)
    """Every rank's results of every check, both spawns at once; while they
    run, this process makes the JAX references and the port's one-process
    fine-tune step."""
    d = tmp_path_factory.mktemp("fsdp_zero")
    inputs = _inputs(d, data)
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    ctxs = {}
    try:
        for name, checks in inputs.items():
            sub = d / name
            sub.mkdir()
            torch.save(checks, str(sub / "inputs.pt"))
            ctxs[name] = torch.multiprocessing.spawn(
                worker.run, args=(WORLD, f"file://{sub / 'rendezvous'}", str(sub / "inputs.pt"), str(sub)), nprocs=WORLD, join=False)
    finally:
        os.environ.pop("OMP_NUM_THREADS") if saved is None else os.environ.__setitem__("OMP_NUM_THREADS", saved)
    try:  # JAX's trainer installs a signal handler: it runs in this thread, the other references beside it
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jobs = [pool.submit(_jax_fsdp_ssmast), pool.submit(_jax_zero, "ssmast"), pool.submit(_jax_zero, "delores_s"),
                    pool.submit(_one_process_finetune)]
            _jax_finetune(str(data), str(d / "ft_jax"))
            for job in jobs:
                job.result()
    finally:
        for ctx in ctxs.values():
            while not ctx.join():
                pass
    out = {}
    for name in ctxs:
        rs = [torch.load(str(d / name / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
        for r, res in enumerate(rs):
            for k, v in res.items():
                out.setdefault(k, [None] * WORLD)[r] = v
    return out | {"dir": d}


# ---------------------------------------------------------------- fsdp_spec


def test_fsdp_spec_follows_jax_on_its_cases_and_every_mast_leaf():
    """JAX's tests/test_fsdp.py cases, and every leaf of SS-MAST's MAST tiny
    (both towers, the queue, the counters) at n = 2 and 8: the port's
    ``fsdp_spec`` names the dimension JAX's PartitionSpec shards."""
    assert fsdp.fsdp_spec((64, 512), 8, min_size=1) == 1
    assert fsdp.fsdp_spec((512, 63), 8, min_size=1) == 0
    assert fsdp.fsdp_spec((63, 65), 8, min_size=1) is None
    assert fsdp.fsdp_spec((64,), 8, min_size=4096) is None
    assert fsdp.fsdp_spec((64, 64), 8, min_size=1) == 0 and fsdp.DEFAULT_MIN_SIZE == 2**12  # ties: the first
    _, _, params, _, ssl, _, _ = _ssmast_init()
    leaves = jax.tree.leaves({"params": params, "ssl": ssl})
    assert len(leaves) > 100
    for n in (2, 8):
        for leaf in leaves:
            spec = tuple(jax_fsdp_spec(np.shape(leaf), n))
            want = spec.index("data") if "data" in spec else None
            assert fsdp.fsdp_spec(np.shape(leaf), n) == want, (np.shape(leaf), n)


# ---------------------------------------------------------------- SS-MAST under fsdp


@functools.lru_cache(maxsize=1)
def _jax_fsdp_ssmast():
    """JAX's GSPMD SS-MAST step on a 2-device data mesh: the state under
    ``tree_shardings`` (query tower, key tower, queue), value_and_grad with
    axis_name None, the gradients pinned to the parameters' shardings, AdamW
    on the sharded moments; each device's shards before the step."""
    cfg, jobj, params, bs, ssl, v1, v2 = _ssmast_init()
    mesh = _mesh()
    p_sh, s_sh = tree_shardings(params, mesh), tree_shardings(ssl, mesh)
    tx = optax.adamw(3e-4, b1=0.9, b2=0.999, eps=1e-4, weight_decay=0.0)
    o_sh = tree_shardings(jax.eval_shape(tx.init, params), mesh)
    params, ssl = jax.device_put(params, p_sh), jax.device_put(ssl, s_sh)
    opt_state = jax.jit(tx.init, out_shardings=o_sh)(params)
    before = [_ssmast_state(p, s) for p, s in zip(_device_trees(params, mesh), _device_trees(ssl, mesh))]

    def step(params, opt_state, ssl, v1, v2):
        (loss, aux), g = jobj.value_and_grad(params, bs, ssl, (v1, v2), jax.random.key(1), True, None)
        g = jax.lax.with_sharding_constraint(g, p_sh)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, aux.ssl_state, loss, g

    batch = NamedSharding(mesh, P("data"))
    params, opt_state, ssl, loss, g = jax.jit(step, out_shardings=(p_sh, o_sh, s_sh, NamedSharding(mesh, P()), p_sh))(
        params, opt_state, ssl, jax.device_put(_nhwc(v1), batch), jax.device_put(_nhwc(v2), batch))
    enc = lambda tree: {f"encoder.{k}": v.numpy() for k, v in mast_with_head_from_flax(_np_tree(tree)).items()}  # noqa: E731
    adam = opt_state[0]
    return {"loss": float(loss), "grads": enc(g["encoder"]), "after": _ssmast_state(_np_tree(params), _np_tree(ssl)),
            "mu": enc(adam.mu["encoder"]), "nu": enc(adam.nu["encoder"]), "before": before}


@pytest.mark.parametrize("check", ["ssmast_fsdp", "ssmast_fsdp_accum"])
def test_ssmast_step_under_fsdp_matches_the_jax_gspmd_step(ranks, check):
    """One SS-MAST AdamW step at world 2 under fsdp, 2 clips a rank (and the
    same as two microbatches of 1): the loss, the gradients, the parameters,
    key tower, queue and pointer after the step, and both moments, against
    JAX's GSPMD step with ``tree_shardings``; every leaf JAX shards is half
    on each rank between steps, moments included. Per step and rank: one
    gather of the queue, and a forward gathers each unit that holds pieces
    (a tower's own weights and each of its blocks) and its backward
    reduce-scatters each (with two microbatches two key and two query
    forwards and two backwards: each microbatch's backward reduces its
    gradients, the sum of the means being the mean of the sums), one
    all-reduce of the whole leaves' gradients after the last, the keys' two
    all-gathers."""
    want = _jax_fsdp_ssmast()
    for r in ranks[check]:
        assert abs(float(r["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"]), (r["loss"], want["loss"])
        assert not _grads_close(r["grads"], want["grads"])
        for k, v in want["after"].items():
            if k in ("queue_ptr", "step"):
                assert int(r["after"][k]) == int(v), k
            else:
                assert _rel(r["after"][k], v) <= 1e-5, k
        assert int(r["after"]["queue_ptr"]) == 2 * B
        for m, k in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            assert not _grads_close({n: v[k] for n, v in r["moments"].items()}, want[m]), m
        for k, d in r["dims"].items():
            whole = want["after"][k].shape
            shape = r["piece_shapes"][k]
            assert shape == (whole if d is None else tuple(s // WORLD if i == d else s for i, s in enumerate(whole))), k
            if k in r["moment_shapes"]:
                assert r["moment_shapes"][k] == shape, k
        assert r["dims"]["queue"] == 1 and r["piece_shapes"]["queue"] == (16, 256 // WORLD)
        accum, units = 2 if check.endswith("accum") else 1, 3  # units with pieces: a tower and its 2 blocks
        assert r["step_calls"] == {"fsdp_gather": 2 * units * accum + 1, "fsdp_reduce_scatter": units * accum,
                                   "all_reduce_grads": 1, "all_gather": 2, "all_reduce": 1}, r["step_calls"]
    _, _, params, _, ssl, _, _ = _ssmast_init()
    leaves = jax.tree.leaves((params["encoder"], ssl.params_k, ssl.queue))
    sharded = [k for k, d in ranks[check][0]["dims"].items() if d is not None]
    assert len(sharded) == sum("data" in tuple(jax_fsdp_spec(np.shape(leaf), WORLD)) for leaf in leaves)
    assert "encoder_k.mast.blocks.0.attn.qkv.weight" in sharded


def test_each_rank_held_the_jax_addressable_shards(ranks):
    """Before the step rank r's pieces of every leaf (both towers, the queue)
    are JAX's addressable shard r under ``tree_shardings``, after the flax ->
    torch conversion, bit for bit."""
    want = _jax_fsdp_ssmast()["before"]
    for r, res in enumerate(ranks["ssmast_fsdp"]):
        assert set(res["pieces"]) == set(want[r])
        for k, v in want[r].items():
            np.testing.assert_array_equal(res["pieces"][k], v, err_msg=k)


def test_gradients_reduce_scattered_as_a_sum_fail_the_check(ranks):
    """The planted fault: the pieces' gradients summed over the data axis,
    not averaged; only the sharded leaves break the gradient bound."""
    want = _jax_fsdp_ssmast()
    for r in ranks["ssmast_fsdp_sum_reduce_scatter"]:
        bad = _grads_close(r["grads"], want["grads"])
        assert bad and all(r["dims"][n] is not None for n in bad), bad


# ---------------------------------------------------------------- ZeRO


@functools.lru_cache(maxsize=None)
def _jax_zero(name):
    """JAX's ZeRO step on a 2-device data mesh (train/step.py:119-126): the
    objective's value_and_grad in ``shard_map``, ``zero_update`` on the state
    ``zero_init`` made; SGD for DeLoRes-S, AdamW at eps 1e-4 for SS-MAST.
    The state after the step, and each trained parameter's moment rows
    carried to the port's layout: each leaf's [n, k] rows joined and
    unpadded to the JAX leaf, the tree converted, each port tensor cut into
    rows again (``zero.shard_rows``)."""
    if name == "ssmast":
        cfg, _, params, bs, ssl, v1, v2 = _ssmast_init()
        jobj = JaxSSMast(cfg, axis_name="data")
        tx = optax.adamw(3e-4, b1=0.9, b2=0.999, eps=1e-4, weight_decay=0.0)
    else:
        cfg, jobj, params, bs, v1, v2 = _delores_s()
        ssl = ()
        tx = joptim.sgd_torch(0.03)
    opt_state = zero_init(tx, params, WORLD)

    def local(p, o, s, v1, v2):
        o = jax.tree.map(lambda a: a[0], o)
        if name == "ssmast":
            (loss, aux), g = jobj.value_and_grad(p, bs, s, (v1, v2), jax.random.key(1), True, "data")
            extra = aux.ssl_state
        else:
            (loss, aux), g = jax.value_and_grad(
                lambda q: jobj.loss(q, bs, (), (v1, v2), jax.random.key(1), True, "data"), has_aux=True)(p)
            extra = aux.batch_stats
        updates, o = zero_update(tx, g, o, p, WORLD, "data")
        return optax.apply_updates(p, updates), jax.tree.map(lambda a: a[None], o), extra, jax.lax.pmean(loss, "data")

    fn = jax.jit(shard_map(local, mesh=_mesh(), in_specs=(P(), P("data"), P(), P("data"), P("data")),
                               out_specs=(P(), P("data"), P(), P()), check_vma=False))
    new_p, new_o, extra, loss = _np_tree(fn(params, opt_state, ssl, _nhwc(v1), _nhwc(v2)))
    if name == "ssmast":
        after = _ssmast_state(new_p, extra)
        to_port = lambda t: {f"encoder.{k}": v for k, v in mast_with_head_from_flax(t["encoder"]).items()}  # noqa: E731
        moments, count = {"mu": new_o[0].mu, "nu": new_o[0].nu}, int(new_o[0].count[0])
        torch_names = {"mu": "exp_avg", "nu": "exp_avg_sq"}
    else:
        after = {k: v.numpy() for k, v in _port_delores_s_state(new_p, extra).items()}
        to_port = lambda t: _port_delores_s_state(t, extra)  # noqa: E731
        moments, count = {"trace": new_o[1].trace}, 1
        torch_names = {"trace": "momentum_buffer"}
    rows: dict[str, dict[str, np.ndarray]] = {}
    for m, tree in moments.items():
        whole = jax.tree.map(lambda r, leaf: np.asarray(r).reshape(-1)[:np.size(leaf)].reshape(np.shape(leaf)),
                             tree, params)
        for n, v in to_port(whole).items():
            rows.setdefault(n, {})[m] = zero.shard_rows(torch.as_tensor(np.asarray(v)), WORLD).numpy()
    return {"loss": float(loss), "after": after, "rows": rows, "count": count, "torch_names": torch_names}


@pytest.mark.parametrize("name", ["delores_s", "ssmast"])
def test_zero_step_matches_the_jax_zero_step(ranks, name):
    """One step under ZeRO at world 2: DeLoRes-S (AudioNTT, SyncBN, SGD with
    momentum and coupled decay) and SS-MAST (AdamW); the loss and the whole
    state after the step against JAX's ZeRO step, rank r's moment slices
    against row r of JAX's moments (the converter's per-rank state), the
    saved state [2, k]; per step and rank one reduce-scatter and one
    all-gather of one flat buffer each, and no gradient all-reduce."""
    want = _jax_zero(name)
    for r, res in enumerate(ranks[f"zero_{name}"]):
        assert abs(float(res["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
        for k, v in want["after"].items():
            if not k.endswith("num_batches_tracked"):
                assert _rel(res["after"][k], v) <= 1e-5, k
        names = list(res["slices"])
        state = zero.rank_state_from_rows([want["rows"][n] for n in names], want["count"], r, want["torch_names"])
        for i, n in enumerate(names):
            assert set(res["slices"][n]) == set(want["torch_names"].values()), n
            for k, v in res["slices"][n].items():
                assert _rel(v, state[i][k].numpy()) <= 1e-5, (n, k)
                assert res["saved_rows"][n] == (WORLD, v.size), n
        calls = res["step_calls"]
        assert calls["zero_reduce_scatter"] == calls["zero_all_gather"] == 1 and "all_reduce_grads" not in calls


def test_a_zero_slice_one_row_off_fails_the_check(ranks):
    """The planted fault: each rank's slice taken from the next row, while its
    gradient is its own row's; the parameters after the step break the bound."""
    want = _jax_zero("ssmast")
    for res in ranks["zero_ssmast_zero_row_offset"]:
        assert max(_rel(res["after"][k], v) for k, v in want["after"].items() if k.startswith("encoder.")) > 1e-2


# ---------------------------------------------------------------- the fine-tune under fsdp


@functools.lru_cache(maxsize=1)
def _one_process_finetune():
    assert not dist.active()
    return worker.finetune_fsdp_check(copy.deepcopy(_finetune_inputs()))


@pytest.mark.parametrize("check", ["finetune_fsdp", "finetune_fsdp_replicated_n_times"])
def test_finetune_step_under_fsdp_equals_one_process(ranks, check):
    """One fine-tune step at world 2 under fsdp, 4 clips a rank, the clip at
    1e-2 (below the gradient's norm, so it scales): the loss, the global
    norm the clip reads and every gradient against one port process on the
    8 clips. The planted fault (the whole leaves' squares summed over the
    data axis as the pieces' are) breaks the norm."""
    want = _one_process_finetune()
    assert want["norm"] > 10 * FT_CLIP
    for r in ranks[check]:
        assert abs(float(r["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        assert not _grads_close(r["grads"], want["grads"])
        held = abs(r["norm"] - want["norm"]) <= 1e-5 * want["norm"]
        assert held == (check == "finetune_fsdp"), (r["norm"], want["norm"])


@functools.lru_cache(maxsize=1)
def _jax_finetune(data_dir, save):
    """JAX's train_finetune_mast with ``fsdp`` on a mesh of 2 devices, the
    augmentations off, 2 steps, from ``_ft_params``: its stats' losses, and
    the parameters and Adam moments it saved after step 2, in the port's
    names."""
    import json

    from audiossl_tpu.train import finetune_mast as jft

    class Seeded(jft.MASTClassifier):
        def init(self, *args, **kw):
            return {"params": jax.tree.map(jnp.asarray, _ft_params())}

    saved = []

    def save_checkpoint(ckpt_dir, step, state, *args, **kw):
        saved.append(_np_tree({"params": state["params"], "opt_state": state["opt_state"]}))
        return save_checkpoint.original(ckpt_dir, step, state, *args, **kw)

    save_checkpoint.original = jft.ckptmod.save_checkpoint
    cfg = _ft_config(save)
    cfg["run"]["world_size"] = WORLD
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jft, "MASTClassifier", Seeded)
        mp.setattr(jft.ckptmod, "save_checkpoint", save_checkpoint)
        jft.train_finetune_mast(cfg, os.path.join(data_dir, "train.json"), os.path.join(data_dir, "labels.csv"),
                                max_steps=2)
    with open(save + "_chkp/stats.jsonl") as f:
        losses = [rec["train_loss"] for rec in map(json.loads, f) if "step" in rec]
    port = lambda tree: {k: v.numpy() for k, v in mast_classifier_from_flax(tree).items()}  # noqa: E731
    adam = next(s for s in saved[-1]["opt_state"] if hasattr(s, "mu"))
    return {"losses": losses, "params": port(saved[-1]["params"]), "mu": port(adam.mu), "nu": port(adam.nu)}


def test_finetune_cli_with_fsdp_matches_the_jax_trainer(ranks, data):  # noqa: F811
    """``finetune_mast --fsdp`` at world 2 from the same initial classifier, 2
    steps with the clip engaged, against JAX's fsdp trainer on a mesh of 2:
    the losses of both steps; the checkpoint is dense."""
    import json

    want = _jax_finetune(str(data), str(ranks["dir"] / "ft_jax"))["losses"]
    with open(str(ranks["dir"] / "ft_port_chkp" / "stats.jsonl")) as f:
        got = [rec["train_loss"] for rec in map(json.loads, f) if "step" in rec]
    assert len(want) == len(got) == 2 and want[0] != want[1]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)
    saved = torch.load(str(ranks["dir"] / "ft_port_chkp" / "state" / "2.pt"), weights_only=True)
    assert saved["model"]["mast.blocks.0.attn.qkv.weight"].shape == (3 * 96, 96)
    moments = [st["exp_avg"] for st in saved["optimizer"]["state"].values()]
    assert sum(m.numel() for m in moments) == sum(v.numel() for k, v in saved["model"].items())
    assert max(m.numel() for m in moments) == saved["model"]["mast.blocks.1.mlp.fc1.weight"].numel()


@pytest.mark.parametrize("save", ["ft_port", "ft_fault"])
def test_finetune_cli_state_under_fsdp_matches_the_jax_trainer(ranks, data, save):  # noqa: F811
    """The dense state the fine-tune CLI with ``--fsdp`` saved after its 2
    steps against the state JAX's fsdp trainer saved: the parameters 1e-5,
    both Adam moments by the gradients' bound. The clip scales every
    gradient by 1e-2 over the global norm before the moments take it, so
    the moments carry the norm, where Adam's normalised update does not.
    The planted fault (``ft_fault``: the whole leaves counted twice in the
    clip's norm) breaks both moments."""
    from audiossl_tpu_torch.train import finetune_mast as ft
    from audiossl_tpu_torch.train.layer_decay import adamw_layer_decay

    want = _jax_finetune(str(data), str(ranks["dir"] / "ft_jax"))
    saved = torch.load(str(ranks["dir"] / f"{save}_chkp" / "state" / "2.pt"), weights_only=True)
    with torch.device("meta"):
        model = ft.build_classifier(FT, N_CLASSES)
    opt = adamw_layer_decay(model.named_parameters(), 1e-3, ft.MVIT_DEPTH["tiny"], 0.75)
    name_of = {id(p): n for n, p in model.named_parameters()}
    names = [name_of[id(p)] for g in opt.param_groups for p in g["params"]]  # the optimizer's order
    moments = {m: {names[i]: st[k].numpy() for i, st in saved["optimizer"]["state"].items()}
               for m, k in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    bad = {m: _grads_close(moments[m], want[m]) for m in moments}
    if save == "ft_port":
        for k, v in want["params"].items():
            assert _rel(saved["model"][k].numpy(), v) <= 1e-5, k
        assert bad == {"mu": [], "nu": []}, bad
    else:
        assert bad["mu"] and bad["nu"], bad


# ---------------------------------------------------------------- checkpoints and refusals


def test_fsdp_checkpoint_resumes_bit_for_bit_and_serves_at_world_1(ranks):
    """SS-MAST under fsdp through train_upstream (drop path on): each rank held
    half of every leaf JAX shards; rank 0 wrote the dense state; a resume from
    step 1 ends on the straight run's step-2 state bit for bit (parameters,
    key tower, queue, moments); the export serves at world 1."""
    from audiossl_tpu_torch.serve.export import embedder_from_checkpoint

    d = ranks["dir"]
    for r in ranks["cli"]:
        assert r["step"] == 2 and r["pieces"]["queue"] == (16, 256 // WORLD)
        assert r["pieces"]["encoder.mast.blocks.0.attn.qkv.weight"] == (3 * 96 // WORLD, 96)
        assert r["pieces"]["encoder_k.mast.blocks.0.mlp.fc1.weight"] == (4 * 96 // WORLD, 96)
    a = torch.load(str(d / "straight_chkp" / "state" / "2.pt"), weights_only=True)
    b = torch.load(str(d / "half_chkp" / "state" / "2.pt"), weights_only=True)
    assert a["objective"]["queue"].shape == (16, 256) and a["objective"]["queue_ptr"] == 8
    for k, v in a["objective"].items():
        assert torch.equal(v, b["objective"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert a["optimizer"]["state"][0]["exp_avg"].shape == a["objective"]["encoder.mast.patch_embed.proj.weight"].shape
    emb = embedder_from_checkpoint(str(d / "straight_chkp"), int(16000 * 1.2), "f32", "cpu")
    with torch.no_grad():
        z = emb(torch.from_numpy(np.random.default_rng(7).standard_normal((2, int(16000 * 1.2))).astype(np.float32)))
    assert z.shape == (2, 192) and torch.isfinite(z).all()


def test_finetune_fsdp_checkpoint_resumes_bit_for_bit(ranks):
    """The fine-tune CLI with ``--fsdp`` at world 2: 1 step, then a resume of
    its dense checkpoint cut to each rank's pieces, ends on the straight
    2-step run's state bit for bit (parameters and both moments)."""
    d = ranks["dir"]
    a = torch.load(str(d / "ft_port_chkp" / "state" / "2.pt"), weights_only=True)
    b = torch.load(str(d / "ft_port_half_chkp" / "state" / "2.pt"), weights_only=True)
    assert b["step"] == 2 and a["model"]["mast.blocks.1.mlp.fc1.weight"].shape == (4 * 192, 192)
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(b["optimizer"]["state"][i][k])), (i, k)


def test_zero_checkpoint_holds_rows_and_refuses_another_world(ranks):
    """The ZeRO checkpoint holds every moment as [2, k] rows and the world it
    was saved at; a resume at world 1 raises, as JAX's restore does."""
    from audiossl_tpu_torch.config import load_config
    from audiossl_tpu_torch.train.loop import train_upstream

    d = ranks["dir"]
    saved = torch.load(str(d / "zero_chkp" / "state" / "1.pt"), weights_only=True)
    assert saved["optimizer"]["zero_world"] == WORLD
    n = saved["objective"]["encoder.mast.patch_embed.proj.weight"].numel()
    assert saved["optimizer"]["state"][0]["exp_avg"].shape == (WORLD, -(-n // WORLD))
    cfg = load_config(os.path.join(str(d), "tiny_zero_optimizer.yaml"))
    cfg["run"]["save_path"] = str(d / "zero_world1")
    with pytest.raises(ValueError, match="ZeRO optimizer state sharded over 2 process"):
        train_upstream(cfg, str(d / "m.csv"), "ssmast", load_checkpoint=str(d / "zero_chkp"), device="cpu")


def _cfg(name):
    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def test_refusals_keep_jax_messages():
    """run.fsdp with stateful augmentation (JAX's ValueError, naming the knob),
    with remat, for an objective that names no gathering units; ZeRO with
    LARS / LARC (JAX's message); the fine-tune refuses ZeRO and, under fsdp,
    remat; DECAR and DeepCluster refuse both knobs; all before any data is
    read."""
    from audiossl_tpu_torch.train.decar_loop import train_decar
    from audiossl_tpu_torch.train.finetune_mast import train_finetune_mast
    from audiossl_tpu_torch.train.loop import train_upstream

    def upstream(name, run=None, **pre):
        cfg = _cfg(name)
        cfg["run"].update(run or {})
        cfg["pretrain"].update(pre)
        return cfg

    with pytest.raises(ValueError, match="run.fsdp requires stateless augmentation"):
        train_upstream(upstream("delores_s", {"fsdp": True}), "unused.csv", "delores_s", device="cpu")
    with pytest.raises(NotImplementedError, match="run.fsdp with remat"):
        train_upstream(upstream("ssmast", {"fsdp": True}, remat=True), "unused.csv", "ssmast", device="cpu")
    with pytest.raises(NotImplementedError, match="run.fsdp is ported for SS-MAST: DeloresS"):
        train_upstream(upstream("delores_s", {"fsdp": True}, normalization="l2", augmentations={}), "unused.csv",
                       "delores_s", device="cpu")
    for opt in ("lars", "larc"):
        with pytest.raises(ValueError, match=f"zero_optimizer supports elementwise optimizers .*'{opt}' needs "
                                             "full-tensor norms"):
            train_upstream(upstream("delores_s", {"zero_optimizer": True, "optimizer": opt}), "unused.csv",
                           "delores_s", device="cpu")
    ft = _cfg("mast_ft")
    with pytest.raises(NotImplementedError, match="run.zero_optimizer is run by train_upstream only.*JAX's fine-tune"):
        train_finetune_mast({**ft, "run": {**ft["run"], "zero_optimizer": True}}, "t.json", "l.csv", device="cpu")
    with pytest.raises(NotImplementedError, match="run.fsdp with remat"):
        train_finetune_mast({"run": {**ft["run"], "fsdp": True}, "finetune": {**ft["finetune"], "remat": True}},
                            "t.json", "l.csv", device="cpu")
    for knob, match in (("fsdp", "run.fsdp is run by train_upstream .* no fully sharded path"),
                        ("zero_optimizer", "run.zero_optimizer is run by train_upstream only")):
        with pytest.raises(NotImplementedError, match=match):
            train_decar(upstream("decar_v2", {knob: True}), "unused.csv", device="cpu")
    with pytest.raises(ValueError, match="zero_optimizer supports elementwise"):
        zero.assert_zero_compatible("LARS")
    zero.assert_zero_compatible("AdamW")
