"""Tensor parallelism across processes on the CPU: gloo ranks of the port on
a dp x tp grid (one ``torch.multiprocessing.spawn`` for each world size, 2
ranks at tp 2 and 4 ranks at dp 2 x tp 2; tests/torch_tp_worker.py) against
the JAX package's GSPMD jits on the same mesh shapes (the host devices
tests/conftest.py forces: ``make_dp_tp_mesh(1, 2)`` and ``(2, 2)``), the
dense JAX encoder, and the port's own one-process run. f32; dropout and drop
path 0 unless said; inputs are numpy from a seed; weights cross through
``models/convert.py``. MAST tiny is cut to 4 blocks on both sides (as the
other SS-MAST files cut it; JAX's tp jit pools ``unrolled``, as its tp loop
sets it, and the port pools with the grouped conv whatever the key says);
AST takes tiny's width (192) with 4 heads at depth 2, since tiny's 3 heads
do not divide by 2.

Tolerances, each relative to max(1, max|ref|) unless said otherwise:
* the primitives: JAX's tests/test_tp.py bounds (forward 1e-5, gradients
  1e-4 absolute); the gather / scatter chain against its dense form 1e-5;
* the encoders at tp 2 against JAX's tp jit and the dense JAX encoder:
  forward 1e-5; each gradient within 1e-3 of its own max|ref| + 1e-5 of the
  largest gradient (the SS-MAST file's bound: some gradients are round-off,
  e.g. a pooled key LayerNorm's bias, which shifts a whole score row); each
  rank's shards equal JAX's addressable shards exactly;
* the SS-MAST step at dp 2 x tp 2 (and at tp 2 with two microbatches)
  against JAX's (2, 2) mesh: the loss 1e-5
  relative; the gradients as the encoders'; after AdamW (eps 1e-4 on both
  sides, as the SS-MAST trajectory test: at 1e-8 round-off gradients step
  by the full rate) the parameters 1e-5, the EMA key tower 1e-5, the queue
  1e-5 (unit keys out of an f32 trunk), the pointer exact. Each planted
  fault must break the gradient bound;
* the probe step at tp 2 against one port process on the same batch: the
  loss 1e-5 relative, every gradient 1e-4 of its max + 1e-6 of the largest
  (sums in another order); frozen, the encoder's shards bit-identical;
* the port's MAST-tiny read with ``pool_impl: unrolled`` (one process)
  against JAX's unrolled tp jit and its dense conv: as the encoders';
* the checkpoint: a tp 2 run resumed from step 1 equals the straight run at
  step 2 bit for bit; its export loads whole at tp 1.
"""
import copy
import dataclasses
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
from jax.sharding import NamedSharding, PartitionSpec as P

from audiossl_tpu.models import mast as jmast
from audiossl_tpu.models import mvit as jmvit
from audiossl_tpu.models.ast import ASTConfig as JaxASTConfig
from audiossl_tpu.models.ast import ASTEncoder as JaxASTEncoder
from audiossl_tpu.objectives.ssmast import SSMast as JaxSSMast
from audiossl_tpu.parallel.tp import make_2d_mesh, shard_mlp_weights, tp_mlp
from audiossl_tpu.parallel.tp_ast import ast_tp_shardings, make_dp_tp_mesh
from audiossl_tpu.parallel.tp_mvit import mvit_tp_shardings
from audiossl_tpu_torch.data.wav import write_wav
from audiossl_tpu_torch.models import ast as past
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.convert import (ast_from_flax, mast_from_flax, mast_with_head_from_flax,
                                               mvit_reference_layout, shard_state_dict)
from audiossl_tpu_torch.models.mvit import MViTConfig
from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel import tp as tpar
from audiossl_tpu_torch.parallel.tp_ast import ast_spec, ast_tp_specs
from audiossl_tpu_torch.parallel.tp_mvit import mvit_spec, mvit_tp_specs
from tests import torch_tp_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MF, MT, AF, AT, B = 64, 96, 32, 58, 4
PROBE_CLIP = 8000  # 0.5 s: 51 frames, a 4 x 5 AST patch grid


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def short_tiny():
    """MAST tiny with 4 blocks on both sides, the port's AST tiny at 4 heads
    (the spawned ranks cut theirs alike)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmast.VARIANTS, "tiny", lambda **kw: jmvit.MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
        mp.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
        mp.setitem(past.VARIANTS, "tiny", lambda **kw: past.ASTConfig(embed_dim=192, num_heads=4, depth=2, **kw))
        yield


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def _grads_close(got, want, rel=1e-3, of_largest=1e-5):
    """Each gradient within rel of its own max|want| + of_largest of the
    largest; returns the names that are not."""
    largest = max(float(np.abs(w).max()) for w in want.values())
    return [n for n, w in want.items()
            if not np.abs(np.asarray(got[n]) - w).max() <= rel * np.abs(w).max() + of_largest * largest]


def _perturbed(variables, seed):
    leaves, tree = jax.tree.flatten(_np_tree(variables))
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [x + 0.05 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves])


# ---------------------------------------------------------------- inputs


def _jax_mast(pool_impl="unrolled"):
    return jmast.MASTEncoder(input_fdim=MF, input_tdim=MT, model_size="tiny", compute_dtype=None,
                             fused_attention="off", pool_impl=pool_impl)


def _jax_ast():
    cfg = dataclasses.replace(JaxASTConfig.tiny(), depth=2, num_heads=4, fused_attention="off")
    return JaxASTEncoder(input_fdim=AF, input_tdim=AT, cfg=cfg)


@functools.lru_cache(maxsize=None)
def _encoder_inputs(kind):
    rng = np.random.default_rng(1 if kind == "mast" else 2)
    f, t, width = (MF, MT, 768) if kind == "mast" else (AF, AT, 192)
    x = rng.standard_normal((B, 1, f, t)).astype(np.float32)
    cot = rng.standard_normal((B, width)).astype(np.float32)
    model = _jax_mast() if kind == "mast" else _jax_ast()
    if kind == "mast":  # SS-MAST's query trunk (one MViT init compiled for the file)
        variables = _perturbed({"params": _ssmast_init()[2]["encoder"]["mast"]}, 3)
    else:
        variables = _perturbed(jax.jit(model.init, static_argnums=2)(jax.random.key(0), jnp.zeros((1, f, t, 1)), False),
                               3)
    state = mvit_reference_layout(mast_from_flax(variables)) if kind == "mast" else ast_from_flax(variables)
    return {"kind": kind, "f": f, "t": t, "x": x, "cot": cot,
            "state": {k: v.numpy() for k, v in state.items()}}, model, variables


def _ssmast_cfg():
    with open(os.path.join(ROOT, "configs", "ssmast.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"].update(model_size="tiny", num_negatives=64, contrastive_dim=16, droppath_rate=0.0,
                           compute_dtype="f32", steps_per_epoch=2, fused_attention="off",
                           pool_impl="unrolled")  # JAX's tp settings; the port reads both and acts on neither
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


def _nhwc(v):
    return jnp.asarray(v.transpose(0, 2, 3, 1))


def _ssmast_inputs():
    cfg, _, params, _, ssl, v1, v2 = _ssmast_init()
    state = {f"encoder.{k}": v for k, v in mast_with_head_from_flax(params["encoder"]).items()}
    state.update({f"encoder_k.{k}": v for k, v in mast_with_head_from_flax(ssl.params_k).items()})
    state.update(queue=torch.from_numpy(np.array(ssl.queue)), queue_ptr=torch.tensor(0), step=torch.tensor(0))
    return {"config": cfg, "state": {k: v.numpy() for k, v in state.items()}, "v1": v1, "v2": v2}


def _probe_inputs():
    from audiossl_tpu_torch.downstream.model import DownstreamModel

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = DownstreamModel(n_mels=64, d=192, num_classes=3, encoder_type="AST", input_tdim=51, model_size="tiny")
    rng = np.random.default_rng(6)
    waves = (0.3 * rng.standard_normal((B, PROBE_CLIP))).astype(np.float32)
    return {"state": {k: v.numpy() for k, v in model.state_dict().items()}, "frames": 51, "waves": waves,
            "labels": np.arange(B) % 3}


def _cli_inputs(d):
    files = []
    for i in range(6):
        t = np.arange(int(16000 * 1.2)) / 16000.0
        files.append(str(d / f"w{i}.wav"))
        write_wav(files[-1], (0.4 * np.sin(2 * np.pi * (200 + 90 * i) * t)).astype(np.float32))
    csv = str(d / "m.csv")
    pd.DataFrame({"files": files}).to_csv(csv, index=False)
    cfg = _ssmast_cfg()
    cfg["pretrain"].update(tp=2, droppath_rate=0.1, fused_attention="auto", pool_impl="conv")  # drop path on
    cfg["pretrain"]["input"]["length_wave"] = 1.2
    cfg["run"].update(batch_size=2, epochs=2, num_dataloader_workers=1, log_every=1)
    path = str(d / "tiny_tp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return {"csv": csv, "config": path, "dir": str(d)}


@functools.lru_cache(maxsize=1)
def _prims_inputs():
    rng = np.random.default_rng(12)
    b, d, h, f, k = 8, 16, 32, 16, 12
    return {"x": rng.standard_normal((b, d)).astype(np.float32),
            "w1": (0.1 * rng.standard_normal((d, h))).astype(np.float32),
            "w2": (0.1 * rng.standard_normal((h, f))).astype(np.float32),
            "wa": (0.3 * rng.standard_normal((d, k))).astype(np.float32),
            "wb": (0.3 * rng.standard_normal((k, f))).astype(np.float32),
            "cot": rng.standard_normal((b, f)).astype(np.float32)}


def _inputs(d):
    """The inputs of each world's checks (2: tp 2; 4: dp 2 x tp 2)."""
    ss = _ssmast_inputs()
    accum = copy.deepcopy(ss)
    accum["config"]["pretrain"]["grad_accum_steps"] = 2
    return {2: {"prims": _prims_inputs(), "mast": _encoder_inputs("mast")[0], "ast": _encoder_inputs("ast")[0],
                "probe": _probe_inputs(), "cli": _cli_inputs(d), "ssmast_accum": accum},
            4: {"prims": _prims_inputs(), "ssmast": ss,
                **{f"ssmast_{fault}": {**ss, "fault": fault} for fault in ("sum_backward_reduce", "world_grad_mean")}}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of every check, both worlds spawned at once;
    while they run, this process makes the JAX references and the port's
    one-process probe step."""
    d = tmp_path_factory.mktemp("tp")
    inputs = _inputs(d)
    env = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",)}
    os.environ["OMP_NUM_THREADS"] = "1"
    ctxs = {}
    try:
        for world, tp in ((2, 2), (4, 2)):
            sub = d / f"world{world}"
            sub.mkdir()
            torch.save(inputs[world], str(sub / "inputs.pt"))
            ctxs[world] = torch.multiprocessing.spawn(
                worker.run, args=(world, tp, f"file://{sub / 'rendezvous'}", str(sub / "inputs.pt"), str(sub)), nprocs=world, join=False)
    finally:
        for k, v in env.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    try:
        for kind in ("mast", "ast"):
            _jax_encoder(kind)
        _jax_ssmast_step()
        for data in (1, 2):
            _jax_prims(data)
        _one_process_probe()
    finally:
        for ctx in ctxs.values():
            while not ctx.join():
                pass
    return {world: [torch.load(str(d / f"world{world}" / f"rank{r}.pt"), weights_only=False) for r in range(world)]
            for world in ctxs} | {"dir": d}


# ---------------------------------------------------------------- the primitives


@functools.lru_cache(maxsize=None)
def _jax_prims(data):
    """tests/test_tp.py's two cases on a (data, 2) mesh: tp_mlp's forward and
    the gradients of sum(y^2) psummed over data; the chain's dense form."""
    p = _prims_inputs()
    mesh = make_2d_mesh(data=data, model=2)
    x, w1, w2 = (jnp.asarray(p[k]) for k in ("x", "w1", "w2"))
    w1s, w2s = shard_mlp_weights(mesh, w1, w2)
    smap = lambda fn, i, o: jax.jit(shard_map(fn, mesh=mesh, in_specs=i, out_specs=o, check_vma=False))  # noqa: E731
    y = smap(lambda xl, a, b: tp_mlp(xl, a, b), (P("data", None), P(None, "model"), P("model", None)),
             P("data", None))(x, w1s, w2s)

    def grads_tp(a, b, xl):
        g1, g2 = jax.grad(lambda a, b: jnp.sum(jnp.square(tp_mlp(xl, a, b))) / jax.lax.axis_size("model"),
                          argnums=(0, 1))(a, b)
        return jax.lax.psum(g1, "data"), jax.lax.psum(g2, "data")

    g1, g2 = smap(grads_tp, (P(None, "model"), P("model", None), P("data", None)),
                  (P(None, "model"), P("model", None)))(w1s, w2s, x)
    chain = lambda xa, wa, wb: jnp.sum((jnp.tanh(xa @ wa) @ wb) * p["cot"])  # noqa: E731
    y2 = jnp.tanh(x @ jnp.asarray(p["wa"])) @ jnp.asarray(p["wb"])
    dxa, dwa, dwb = jax.grad(chain, argnums=(0, 1, 2))(x, jnp.asarray(p["wa"]), jnp.asarray(p["wb"]))
    return {"y": np.asarray(y), "dw1": np.asarray(g1), "dw2": np.asarray(g2), "y2": np.asarray(y2),
            "dxa": np.asarray(dxa), "dwa": np.asarray(dwa), "dwb": np.asarray(dwb)}


@pytest.mark.parametrize("world", [2, 4])
def test_primitives_match_jax_tp_cases(ranks, world):
    """tp_mlp (copy, column, ReLU, row, reduce) against JAX's shard_map cases
    on a (1, 2) and a (2, 2) mesh, forward and gradients; the gather /
    scatter pair of MViT's attention against its dense chain. Per rank: one
    reduce forward in each, one gather forward and one scatter backward in
    the chain, one copy backward where the input takes a gradient (the
    chain's)."""
    want = _jax_prims(world // 2)
    for r in ranks[world]:
        out = r["prims"]
        np.testing.assert_allclose(out["y"], want["y"], atol=1e-5)
        np.testing.assert_allclose(out["dw1"], want["dw1"], atol=1e-4)
        np.testing.assert_allclose(out["dw2"], want["dw2"], atol=1e-4)
        for k in ("y2", "dxa", "dwa", "dwb"):
            assert _rel(out[k], want[k]) <= 1e-5, k
        assert {k: v for k, v in out["calls"].items() if k.startswith("tp_")} == \
            {"tp_copy": 1, "tp_reduce": 2, "tp_gather": 1, "tp_scatter": 1}


# ---------------------------------------------------------------- the encoders at tp 2


@functools.lru_cache(maxsize=None)
def _jax_encoder(kind):
    """The encoder's forward and the gradients of sum(y * cot): JAX's tp jit
    on a (1, 2) mesh and the dense jit; and JAX's addressable shards of the
    weights under the tp specs, through the port's conversion."""
    d, model, variables = _encoder_inputs(kind)
    x, cot = _nhwc(d["x"]), jnp.asarray(d["cot"])

    def fwd_grad(model):
        def fn(p, xb):
            loss = lambda p: jnp.sum(model.apply({"params": p}, xb, False) * cot)  # noqa: E731
            return model.apply({"params": p}, xb, False), jax.grad(loss)(p)
        return fn

    mesh = make_dp_tp_mesh(1, 2)
    shardings = (mvit_tp_shardings if kind == "mast" else ast_tp_shardings)(variables["params"], mesh)
    placed = jax.device_put(variables["params"], shardings)
    dense = _jax_mast("conv") if kind == "mast" else model  # the grouped conv: the same parameters, a smaller graph
    out = {"dense": jax.jit(fwd_grad(dense))(variables["params"], x),
           "tp_jit": jax.jit(fwd_grad(model), in_shardings=(shardings, NamedSharding(mesh, P("data"))))(placed, x)}
    convert = (lambda tree: mvit_reference_layout(mast_from_flax({"params": tree}))) if kind == "mast" else \
        (lambda tree: ast_from_flax({"params": tree}))
    res = {name: (np.asarray(y), {k: v.numpy() for k, v in convert(_np_tree(g)).items()})
           for name, (y, g) in out.items()}
    shards = []
    for t in range(2):
        dev = mesh.devices[0, t]
        tree = jax.tree.map(lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == dev)), placed)
        shards.append({k: v.numpy() for k, v in convert(tree).items()})
    return res, shards


@pytest.mark.parametrize("ref", ["tp_jit", "dense"])
@pytest.mark.parametrize("kind", ["mast", "ast"])
def test_encoder_at_tp2_matches_jax(ranks, kind, ref):
    """MAST-tiny and AST at tp 2: the forward and every gradient of both
    ranks against JAX's tp jit on a (1, 2) mesh and the dense JAX encoder.
    Per rank and block, MAST: qkv gathered and proj / fc2 reduced forward,
    the two copies and proj's slice backward; AST: proj / fc2 reduced
    forward, the two copies backward."""
    y, grads = _jax_encoder(kind)[0][ref]
    blocks = 4 if kind == "mast" else 2
    for r in ranks[2]:
        out = r[kind]
        assert _rel(out["y"], y) <= 1e-5
        assert not _grads_close(out["grads"], grads)
        want_calls = {"tp_reduce": 2 * blocks, "tp_copy": 2 * blocks}
        if kind == "mast":
            want_calls.update(tp_gather=blocks, tp_scatter=blocks)
        assert {k: v for k, v in out["calls"].items() if k.startswith("tp_")} == want_calls


@pytest.mark.parametrize("kind", ["mast", "ast"])
def test_each_rank_holds_the_jax_shards(ranks, kind):
    """Rank t's shards are JAX's addressable shard t of every leaf under
    mvit_tp_specs / ast_tp_specs after the flax -> torch conversion, and
    convert.py's ``shard_state_dict`` reproduces them from the dense
    state_dict, and tp.py's ``gather`` joins them back."""
    _, jax_shards = _jax_encoder(kind)
    dense = {k: torch.from_numpy(v) for k, v in _encoder_inputs(kind)[0]["state"].items()}
    spec_of = mvit_spec if kind == "mast" else ast_spec
    for t, r in enumerate(ranks[2]):
        got = r[kind]["shards"]
        assert set(got) == set(jax_shards[t])
        for k, v in jax_shards[t].items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            np.testing.assert_array_equal(shard_state_dict(dense, spec_of, t, 2)[k].numpy(), v, err_msg=k)
    shards = [shard_state_dict(dense, spec_of, t, 2) for t in range(2)]
    for k, v in dense.items():
        assert torch.equal(v if spec_of(k) is None else tpar.gather([s[k] for s in shards], spec_of(k)), v), k
    sharded = [k for k in dense if spec_of(k) is not None]  # qkv weight and bias, attn.proj, fc1 both, fc2
    assert len(sharded) == 6 * (4 if kind == "mast" else 2)


# ---------------------------------------------------------------- SS-MAST at dp 2 x tp 2


@functools.lru_cache(maxsize=1)
def _jax_ssmast_step():
    """JAX's GSPMD SS-MAST step on a (2, 2) mesh (the tp loop's jit: the query
    tower, the key tower and the moments under mvit_tp_shardings, the views
    on the data axis, axis_name None): value_and_grad, then AdamW."""
    cfg, jobj, params, bs, ssl, v1, v2 = _ssmast_init()
    mesh = make_dp_tp_mesh(2, 2)
    p_sh, s_sh = mvit_tp_shardings(params, mesh), mvit_tp_shardings(ssl, mesh)
    params, ssl = jax.device_put(params, p_sh), jax.device_put(ssl, s_sh)
    tx = optax.adamw(3e-4, b1=0.9, b2=0.999, eps=1e-4, weight_decay=0.0)
    opt_state = jax.jit(tx.init)(params)

    def step(params, opt_state, ssl, v1, v2):
        (loss, aux), g = jobj.value_and_grad(params, bs, ssl, (v1, v2), jax.random.key(1), True, None)
        g = jax.lax.with_sharding_constraint(g, p_sh)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), aux.ssl_state, loss, g

    batch = NamedSharding(mesh, P("data"))
    params, ssl, loss, g = jax.jit(step)(params, opt_state, ssl, jax.device_put(_nhwc(v1), batch),
                                          jax.device_put(_nhwc(v2), batch))
    return float(loss), _np_tree(params), _np_tree(ssl), _np_tree(g)


def _ssmast_reference():
    loss, params, ssl, g = _jax_ssmast_step()
    grads = {f"encoder.{k}": v.numpy() for k, v in mast_with_head_from_flax(g["encoder"]).items()}
    state = {f"encoder.{k}": v.numpy() for k, v in mast_with_head_from_flax(params["encoder"]).items()}
    state.update({f"encoder_k.{k}": v.numpy() for k, v in mast_with_head_from_flax(ssl.params_k).items()})
    return loss, grads, state, ssl


def test_ssmast_step_at_dp2_tp2_matches_the_jax_mesh(ranks):
    """One SS-MAST step on 4 ranks, 2 clips a data index, each rank half of
    every qkv, attn.proj and MLP weight and of their AdamW moments: the loss,
    the gradients, the parameters and the EMA key tower after the step, the
    queue (the data axis's keys in JAX's order) and the pointer, against
    JAX's GSPMD step on a (2, 2) mesh; all four ranks alike."""
    loss, grads, state, ssl = _ssmast_reference()
    for r in ranks[4]:
        out = r["ssmast"]
        assert abs(float(out["loss"]) - loss) <= 1e-5 * abs(loss), (out["loss"], loss)
        assert not _grads_close(out["grads"], grads)
        for k, v in state.items():
            assert _rel(out["state"][k], v) <= 1e-5, k
        assert _rel(out["state"]["queue"], ssl.queue) <= 1e-5
        assert int(out["state"]["queue_ptr"]) == int(ssl.queue_ptr) == 2 * B
        assert out["qkv_rows"] == out["moment_rows"] == 3 * 96 // 2
        assert out["calls"]["all_reduce_grads"] == 1 and out["calls"]["all_gather"] == 2
    for r in ranks[4][1:]:
        np.testing.assert_array_equal(r["ssmast"]["state"]["queue"], ranks[4][0]["ssmast"]["state"]["queue"])


def test_ssmast_step_at_tp2_composes_with_gradient_accumulation(ranks):
    """JAX's test_pretrain_tp_with_grad_accum, held to its numbers: at tp 2
    with ``grad_accum_steps: 2`` (two microbatches of 2, each forward and
    backward through the model axis's collectives) the step equals JAX's
    GSPMD step on the whole batch, as the accumulation is exact."""
    loss, grads, state, ssl = _ssmast_reference()
    for r in ranks[2]:
        out = r["ssmast_accum"]
        assert abs(float(out["loss"]) - loss) <= 1e-5 * abs(loss), (out["loss"], loss)
        assert not _grads_close(out["grads"], grads)
        for k, v in state.items():
            assert _rel(out["state"][k], v) <= 1e-5, k
        assert _rel(out["state"]["queue"], ssl.queue) <= 1e-5 and int(out["state"]["queue_ptr"]) == 2 * B
        assert out["qkv_rows"] == out["moment_rows"] == 3 * 96 // 2


@pytest.mark.parametrize("fault", ["sum_backward_reduce", "world_grad_mean"])
def test_planted_faults_fail_the_step_check(ranks, fault):
    """The all-reduce after a row-parallel layer with a summed backward (every
    replicated gradient upstream scaled), and the gradients averaged over the
    whole world (shards of one weight mixed across the model axis): each
    breaks the gradient bound the correct step meets."""
    _, grads, _, _ = _ssmast_reference()
    for r in ranks[4]:
        bad = _grads_close(r[f"ssmast_{fault}"]["grads"], grads)
        assert bad, fault
        if fault == "world_grad_mean":  # only the sharded weights mix
            assert all(mvit_spec(n) is not None for n in bad)


# ---------------------------------------------------------------- the probe at tp 2


@functools.lru_cache(maxsize=1)
def _one_process_probe():
    assert not dist.active()
    dist.set_tp(1)
    return worker.probe_check(copy.deepcopy(_probe_inputs()))


@pytest.mark.parametrize("mode", ["finetune", "freeze"])
def test_probe_step_at_tp2_equals_one_process(ranks, mode):
    """One probe step (log-mel, AST with 4 heads, cross-entropy, Adam) at tp 2
    against one port process on the same 4 clips: the loss and every
    gradient; each rank ran 2 of the 4 heads; frozen, the encoder's shards
    did not move and the head took the one-process gradient."""
    want = _one_process_probe()[mode]
    init = _probe_inputs()["state"]
    largest = max(float(np.abs(g).max()) for g in want["grads"].values())
    for r in ranks[2]:
        out = r["probe"][mode]
        assert abs(float(out["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        assert set(out["grads"]) == set(want["grads"])
        for n, g in want["grads"].items():
            assert np.abs(out["grads"][n] - g).max() <= 1e-4 * np.abs(g).max() + 1e-6 * largest, n
        assert out["qkv_rows"] == 3 * 192 // 2 and want["qkv_rows"] == 3 * 192
        if mode == "freeze":
            assert all(not n.startswith("encoder.") for n in out["grads"])
            for k, v in init.items():
                if k.startswith("encoder."):
                    np.testing.assert_array_equal(out["state"][k], v, err_msg=k)


# ---------------------------------------------------------------- pool_impl, checkpoints, refusals


@pytest.mark.parametrize("ref", ["tp_jit", "dense"])
def test_pool_impl_unrolled_is_read_and_matches_jax(ref):
    """``pool_impl`` is a JAX key the port reads, checks and does not act on
    (JAX's shift-multiply-add works around its partitioner): MAST-tiny built
    with ``pool_impl: unrolled`` in one process, forward and every gradient,
    against JAX's unrolled MAST (its tp jit) and its dense grouped conv; an
    unknown value is refused."""
    d = _encoder_inputs("mast")[0]
    y_want, grads_want = _jax_encoder("mast")[0][ref]
    m = pmast.MASTEncoder(MF, MT, "tiny", compute_dtype=None, pool_impl="unrolled").eval()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in d["state"].items()}, strict=True)
    y = m(torch.from_numpy(d["x"]))
    (y * torch.from_numpy(d["cot"])).sum().backward()
    assert _rel(y.detach().numpy(), y_want) <= 1e-5
    assert not _grads_close({n: p.grad.numpy() for n, p in m.named_parameters()}, grads_want)
    with pytest.raises(ValueError, match="pool_impl must be conv\\|unrolled"):
        pmast.MASTEncoder(MF, MT, "tiny", pool_impl="strided")


def test_a_sharded_module_refuses_another_model_group():
    """A module's ``tp`` and the model group decide together: AST and MAST
    sharded as rank 0 of 2, then run by one process (a model group of 1),
    raise rather than run half the heads; unsharded, the same process runs
    them."""
    from audiossl_tpu_torch.parallel.tp_ast import shard_ast_
    from audiossl_tpu_torch.parallel.tp_mvit import shard_mvit_

    assert not dist.active() and dist.tp_world() == 1
    ast = past.ASTEncoder(AF, AT, "tiny", attention_dtype=torch.float32).eval()
    mast = pmast.MASTEncoder(MF, MT, "tiny", compute_dtype=None).eval()
    x_ast, x_mast = torch.zeros(1, 1, AF, AT), torch.zeros(1, 1, MF, MT)
    with torch.no_grad():
        assert ast(x_ast).shape == (1, 192) and mast(x_mast).shape == (1, 768)
    for model, shard, x in ((ast, shard_ast_, x_ast), (mast, shard_mvit_, x_mast)):
        with pytest.MonkeyPatch.context() as mp:  # sharded as rank 0 of a model group of 2
            mp.setattr(dist, "tp_world", lambda: 2)
            mp.setattr(dist, "tp_rank", lambda: 0)
            shard(model)
        with pytest.raises(RuntimeError, match="a module sharded 2 ways runs in a model group of 1"), torch.no_grad():
            model(x)


def test_checkpoint_saved_at_tp2_resumes_at_tp2_and_serves_at_tp1(ranks):
    """SS-MAST at ``pretrain.tp: 2`` (drop path on, its draws alike on both
    ranks): each rank held half of every qkv and MLP weight in both towers;
    rank 0 wrote the dense state; a resume from step 2 ends on the straight run's step-3 state bit for bit (parameters, key
    tower, queue, moments); the caller's config is unchanged and the run's
    keeps ``pool_impl`` and ``fused_attention`` as given; the encoder
    export serves and loads into the probe at tp 1."""
    from audiossl_tpu_torch.downstream.model import DownstreamModel
    from audiossl_tpu_torch.downstream.probe import load_encoder
    from audiossl_tpu_torch.serve.export import embedder_from_checkpoint

    d = ranks["dir"]
    for r in ranks[2]:
        out = r["cli"]
        assert out["qkv_rows"] == out["key_qkv_rows"] == 3 * 96 // 2 and out["fc1_rows"] == 4 * 96 // 2
        assert out["step"] == 2 and out["config"] == {"pool_impl": "conv", "fused_attention": "auto"}
    a = torch.load(str(d / "straight_chkp" / "state" / "2.pt"), weights_only=True)
    b = torch.load(str(d / "half_chkp" / "state" / "2.pt"), weights_only=True)
    assert a["step"] == b["step"] == 2
    assert {k: a["config"]["pretrain"][k] for k in ("pool_impl", "fused_attention")} == out["config"]  # as given
    assert a["objective"]["encoder.mast.blocks.0.attn.qkv.weight"].shape == (3 * 96, 96)
    for k, v in a["objective"].items():
        assert torch.equal(v, b["objective"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert a["optimizer"]["state"][0]["exp_avg"].shape == a["objective"]["encoder.mast.patch_embed.proj.weight"].shape
    ckpt = str(d / "straight_chkp")
    emb = embedder_from_checkpoint(ckpt, int(16000 * 1.2), "f32", "cpu")
    with torch.no_grad():
        z = emb(torch.from_numpy(np.random.default_rng(7).standard_normal((2, int(16000 * 1.2))).astype(np.float32)))
    assert z.shape == (2, 768) and torch.isfinite(z).all()
    model = DownstreamModel(n_mels=MF, d=768, num_classes=3, encoder_type="MAST", input_tdim=MT, model_size="tiny")
    load_encoder(model, ckpt, (MT, MF))
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, a["objective"][f"encoder.mast.{k}"]), k


def _cfg(name):
    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def test_refusals_keep_jax_messages(tmp_path):
    """JAX's ValueErrors: tp with a world it does not divide (each knob), with
    an encoder it cannot shard, with heads, dim_out or an MLP width tp does
    not divide, with zero_optimizer; the grid itself; and the checks of the
    knobs tp excludes, which the trainer runs too (tests/test_torch_port_fsdp_zero.py):
    fsdp needs stateless augmentation, ZeRO an elementwise optimizer."""
    from audiossl_tpu_torch.downstream.probe import run_downstream
    from audiossl_tpu_torch.train.loop import train_upstream

    cfg = _ssmast_cfg()
    cfg["pretrain"]["tp"] = 2
    with pytest.raises(ValueError, match="1 devices not divisible by pretrain.tp=2"):
        train_upstream(cfg, "unused.csv", "ssmast", device="cpu")
    ds = _cfg("downstream")
    ds["downstream"]["tp"] = 2
    with pytest.raises(ValueError, match="downstream.tp requires base_encoder.type: AST"):
        run_downstream(ds, {}, device="cpu")
    ds["downstream"]["base_encoder"]["type"] = "AST"
    with pytest.raises(ValueError, match="1 devices not divisible by downstream.tp=2"):
        run_downstream(ds, {}, device="cpu")
    ast = past.ASTEncoder(AF, AT, past.ASTConfig(embed_dim=48, num_heads=3, depth=1))
    with pytest.raises(ValueError, match="num_heads divisible by the model axis: 3 heads vs tp=2"):
        ast_tp_specs(ast.state_dict(), 2, 3)
    with pytest.raises(ValueError, match="MLP hidden dim divisible by the model axis: 192 vs tp=5"):
        ast_tp_specs(past.ASTEncoder(AF, AT, past.ASTConfig(embed_dim=40, num_heads=5, depth=1,
                                                            mlp_ratio=4.8)).state_dict(), 5, 5)
    mast = pmast.MASTEncoder(MF, MT, "tiny")
    with pytest.raises(ValueError, match="attention dim_out divisible by the model axis: 96 vs tp=5"):
        mvit_tp_specs(mast.state_dict(), 5)
    with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
        dist.set_tp(2)
    for extra, err, match in (({"zero_optimizer": True}, ValueError, "incompatible with run.zero_optimizer"),
                              ({"fsdp": True}, ValueError, "mutually exclusive")):
        bad = copy.deepcopy(cfg)
        bad["run"].update(extra)
        with pytest.raises(err, match=match):
            train_upstream(bad, "unused.csv", "ssmast", device="cpu")
    for extra, match in (({"fsdp": True}, "run.fsdp requires stateless augmentation"),
                         ({"zero_optimizer": True, "optimizer": "larc"}, "zero_optimizer supports elementwise")):
        bad = _ssmast_cfg()
        bad["run"].update(extra)
        bad["pretrain"]["normalization"] = "mean_var"
        with pytest.raises(ValueError, match=match):
            train_upstream(bad, "unused.csv", "ssmast", device="cpu")


def test_the_grid_puts_rank_r_at_data_r_div_tp_and_model_r_mod_tp(ranks):
    """make_dp_tp_mesh's layout: the 4 ranks' (data, model) indices; each
    rank's queue pointer and keys came from its data group only (2 keys a
    data index a pass, gathered into 4)."""
    grid = [tuple(r["grid"]) for r in ranks[4]]
    assert grid == [(0, 0, 2, 2), (0, 1, 2, 2), (1, 0, 2, 2), (1, 1, 2, 2)]
    assert [tuple(r["grid"]) for r in ranks[2]] == [(0, 0, 1, 2), (0, 1, 1, 2)]
