"""Pipeline parallelism across processes on the CPU: gloo ranks of the port
(one ``torch.multiprocessing.spawn`` at world 2 and one at world 4;
tests/torch_parallel_lib_worker.py) against the JAX package's
``pipelined_apply`` / ``pipeline_forward`` and ``pipelined_ast_forward``
on pipe meshes of the same sizes (the host devices tests/conftest.py
forces), every case of tests/test_pipeline.py and tests/test_pipeline_ast.py:
stages 2 and 4, forward and the loss and gradients against JAX's
``value_and_grad``; at 4 stages (where JAX's own tests run them) a single
microbatch and an uneven M; a checkpointed stage and a frozen first stage
at 2; a dp 2 x pp 2 grid, the pipelined AST at (2 stages, 2 microbatches) and
(4, 8), one stage in one process, the block twin, and the two errors.
f32; inputs and the blocks' weights are numpy from a seed; the AST's
weights are the port's, seeded, carried to flax through
``models/convert.py:ast_reference_layout`` and the JAX package's
``ast_from_torch``; the blocks cross through ``vit_block_from_jax``.

Tolerances (JAX's own tests' bounds): outputs rtol 2e-5, atol 2e-5; the
loss rtol 1e-5; gradients rtol 5e-4, atol 1e-5 (the checkpointed stage
against the plain one: rtol 1e-5, atol 1e-7). The planted fault (the
output collective's backward summed over the stages) must break the
gradient bound. The collectives a rank are counted exactly: one
"pp_permute" a tick in which the rank sends or receives, each way, and
one "pp_output".
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from audiossl_tpu.models.ast import ASTConfig as JaxASTConfig
from audiossl_tpu.models.ast import ASTEncoder as JaxASTEncoder
from audiossl_tpu.parallel.pipeline import PIPE_AXIS, make_pipe_mesh, pipeline_forward, stack_stage_params, vit_block
from audiossl_tpu.parallel.pipeline_ast import ast_block, pipelined_ast_forward as jax_pipelined_ast
from audiossl_tpu.models.torch_import import ast_from_torch
from audiossl_tpu_torch.models.ast import ASTConfig, ASTEncoder, patch_grid
from audiossl_tpu_torch.models.convert import ast_reference_layout, vit_block_from_jax
from audiossl_tpu_torch.parallel import pipeline
from audiossl_tpu_torch.parallel.pipeline_ast import ast_stage_stack, pipelined_ast_forward
from tests import torch_parallel_lib_worker as worker

HEADS, D, TOKENS = 2, 16, 6
AST_KW = dict(embed_dim=32, depth=8, num_heads=2, mlp_ratio=2.0, fstride=8, tstride=8, patch=8)
F_IN, T_IN, BATCH = 32, 64, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


# ---------------------------------------------------------------- inputs


@functools.lru_cache(maxsize=None)
def _blocks(depth):
    return worker.jax_vit_blocks(depth, D, np.random.default_rng(depth))


def _x(seed, n_micro, mb):
    return (0.5 * np.random.default_rng(seed).standard_normal((n_micro, mb, TOKENS, D))).astype(np.float32)


def _case(stages, n_micro, mb=2, seed=0, grad=False, **kw):
    d = {"stages": stages, "heads": HEADS, "blocks": _blocks(stages), "x": _x(seed, n_micro, mb), **kw}
    if grad:
        d["tgt"] = np.random.default_rng(seed + 100).standard_normal(d["x"].shape).astype(np.float32)
    return d


@functools.lru_cache(maxsize=None)
def _cases(world):
    """Each world's cases: stages 2 and 4 forward and with gradients; at 4
    stages (where JAX's tests run them) a single microbatch, an uneven M and
    dp 2 x pp 2; at 2 the checkpointed stage (its first call imports
    torch's compiler stack, ~2 s a process, in turn along the stages), a
    frozen first stage with an input that takes no gradient, and the
    planted fault."""
    if world == 2:  # "pp frozen" runs before "pp grad": a message it left behind would reach the latter
        return {"pp fwd": _case(2, 8), "pp frozen": _case(2, 4, seed=3, grad=True, frozen=[0]),
                "pp grad": _case(2, 4, seed=3, grad=True),
                "pp remat": _case(2, 4, seed=3, grad=True, remat=True),
                "pp fault": _case(2, 4, seed=3, grad=True, fault="summed_output_backward")}
    return {"pp fwd": _case(4, 8), "pp single": _case(4, 1, seed=1), "pp uneven": _case(4, 3, seed=2),
            "pp grad": _case(4, 4, seed=3, grad=True), "pp dp": _case(2, 4, mb=4, seed=4, grad=True, data=2)}


AST_CASES = {2: (2, 2), 4: (4, 8)}  # world -> (stages, n_micro)


@functools.lru_cache(maxsize=1)
def _ast_state():
    """The port's AST at JAX's test config, seeded in torch (its state as
    numpy), and the input [B, F, T, 1]: the ranks need no JAX to start."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        enc = ASTEncoder(F_IN, T_IN, ASTConfig(**AST_KW))
    x = np.random.default_rng(17).standard_normal((BATCH, F_IN, T_IN, 1)).astype(np.float32)
    return {k: v.numpy() for k, v in enc.state_dict().items()}, x


@functools.lru_cache(maxsize=1)
def _ast_inputs():
    """The same weights as flax variables, through the reference layout and
    the JAX package's own importer, and the flax encoder's output."""
    state, x = _ast_state()
    cfg = JaxASTConfig(**AST_KW, fused_attention="off")
    grid_ft = patch_grid(F_IN, T_IN, ASTConfig(**AST_KW))[::-1]
    ref_layout = ast_reference_layout({k: torch.from_numpy(v) for k, v in state.items()}, grid_ft)
    variables = _np_tree(ast_from_torch(ref_layout, AST_KW["num_heads"], grid_ft))
    enc = JaxASTEncoder(input_fdim=F_IN, input_tdim=T_IN, cfg=cfg)
    ref = np.asarray(jax.jit(enc.apply, static_argnums=2)(variables, jnp.asarray(x), False))
    return cfg, variables, x, ref, state


def _ast_case(stages, n_micro):
    state, x = _ast_state()
    return {"stages": stages, "n_micro": n_micro, "f": F_IN, "t": T_IN, "cfg": AST_KW, "state": state,
            "x": x.transpose(0, 3, 1, 2)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of every case, both worlds spawned at once; while
    they run, this process makes the JAX references."""
    d = tmp_path_factory.mktemp("pp")
    ctxs = {}
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for world in (2, 4):
            sub = d / f"world{world}"
            sub.mkdir()
            torch.save({**_cases(world), "pp_ast": _ast_case(*AST_CASES[world])}, str(sub / "in.pt"))
            ctxs[world] = torch.multiprocessing.spawn(worker.run, args=(world, f"file://{sub / 'rendezvous'}",
                                                                        str(sub / "in.pt"), str(sub)), nprocs=world,
                                                      join=False)
    finally:
        os.environ.pop("OMP_NUM_THREADS") if env is None else os.environ.__setitem__("OMP_NUM_THREADS", env)
    try:
        for world in (2, 4):
            for name in _cases(world):
                if name not in ("pp fault", "pp frozen", "pp remat"):  # held against "pp grad"'s
                    _jax_pp(world, name.split()[1])
            _jax_ast(*AST_CASES[world])
    finally:
        for ctx in ctxs.values():
            while not ctx.join():
                pass
    return {world: [torch.load(str(d / f"world{world}" / f"rank{r}.pt"), weights_only=False) for r in range(world)]
            for world in ctxs}


# ---------------------------------------------------------------- the JAX references


def _stage_fn(p, a):
    return vit_block(p, a, HEADS)


@functools.lru_cache(maxsize=None)
def _jax_pp(world, kind):
    """JAX's output, or loss and gradients (each stage's row of the stacked
    gradients in the port's names), of a case on a pipe mesh of its stages
    (for "dp", a (2, stages) data x pipe mesh)."""
    case = _cases(world)[f"pp {kind}"]
    stages = case["stages"]
    blocks = [jax.tree.map(jnp.asarray, b) for b in case["blocks"]]
    stacked = stack_stage_params(blocks)
    x = jnp.asarray(case["x"])
    if kind == "dp":
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, stages), ("data", PIPE_AXIS))
        tgt = jnp.asarray(case["tgt"])

        def local_loss(p, xl, tl):
            out = pipeline_forward(_stage_fn, p, xl)
            return jax.lax.psum(jnp.sum((out - tl) ** 2), "data") / tgt.size

        def loss(p, xin):
            return jax.shard_map(local_loss, mesh=mesh, in_specs=(P(PIPE_AXIS), P(None, "data"), P(None, "data")),
                                 out_specs=P(), check_vma=False)(p, xin, tgt)
    else:
        mesh = make_pipe_mesh(stages)
        fwd = jax.shard_map(lambda pl_, xl: pipeline_forward(_stage_fn, pl_, xl), mesh=mesh,
                            in_specs=(P(PIPE_AXIS), P()), out_specs=P(), check_vma=False)
        if "tgt" not in case:
            return {"out": np.asarray(jax.jit(fwd)(stacked, x))}
        tgt = jnp.asarray(case["tgt"])

        def loss(p, xin):
            return jnp.mean((fwd(p, xin) - tgt) ** 2)

    (lv, (gp, gx)) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(stacked, x)
    grads = [vit_block_from_jax(_np_tree(jax.tree.map(lambda a, i=i: a[i], gp))) for i in range(stages)]
    return {"loss": float(lv), "grads": [{k: v.numpy() for k, v in g.items()} for g in grads], "dx": np.asarray(gx)}


@functools.lru_cache(maxsize=None)
def _jax_ast(stages, n_micro):
    cfg, variables, x, _, _ = _ast_inputs()
    return np.asarray(jax_pipelined_ast(make_pipe_mesh(stages), variables, jnp.asarray(x), cfg, n_micro))


def _sequential(case):
    y = jnp.asarray(case["x"]).reshape(-1, TOKENS, D)
    for blk in case["blocks"]:
        y = vit_block(jax.tree.map(jnp.asarray, blk), y, HEADS)
    return np.asarray(y).reshape(case["x"].shape)


def _expected_permutes(stages, n_micro, stage):
    """The ticks in which ``stage`` sends or receives, one way."""
    ticks = set()
    for t in range(n_micro + stages - 1):
        for i in range(stages - 1):
            if 0 <= t - i < n_micro and stage in (i, i + 1):
                ticks.add(t)
    return len(ticks)


def _grads_close(got, want, rtol=5e-4, atol=1e-5):
    return [k for k, w in want.items() if not np.allclose(got[k], w, rtol=rtol, atol=atol)]


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("world,kind", [(2, "fwd"), (4, "fwd"), (4, "single"), (4, "uneven")])
def test_pipeline_forward_matches_jax(ranks, world, kind):
    """stages = world, M = 8 (JAX's test_matches_sequential) at 2 and 4
    stages; M = 1 and 3 at 4 (test_single_microbatch_and_uneven_m): every
    rank holds the whole output, equal to JAX's pipelined_apply and its sequential stack; each
    rank exchanges only at the ticks that carry a microbatch."""
    case = _cases(world)[f"pp {kind}"]
    m = case["x"].shape[0]
    want = _jax_pp(world, kind)["out"]
    np.testing.assert_allclose(want, _sequential(case), rtol=2e-5, atol=2e-5)
    for r, res in enumerate(ranks[world]):
        out = res[f"pp {kind}"]
        np.testing.assert_allclose(out["out"], want, rtol=2e-5, atol=2e-5)
        assert out["stage_blocks"] == [r]
        assert out["calls"] == {"pp_permute": _expected_permutes(world, m, r), "pp_output": 1}


# ---------------------------------------------------------------- gradients


@pytest.mark.parametrize("world,kind", [(2, "grad"), (4, "grad"), (2, "remat")])
def test_pipeline_grads_match_jax_value_and_grad(ranks, world, kind):
    """The loss mean((out - tgt)^2) and its gradients through the schedule
    against JAX's value_and_grad through pipeline_forward (its own jit):
    each rank's stage gradients equal JAX's rows of the stacked gradients,
    and the input's gradient (stage 0's) JAX's. The checkpointed stage is
    held to the same reference (JAX's test_checkpointed_stage_matches shows
    jax.checkpoint leaves JAX's gradients as they are) and to the port's
    plain stage. The backward exchanges as the forward does."""
    want = _jax_pp(world, "grad")
    for r, res in enumerate(ranks[world]):
        out = res[f"pp {kind}"]
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
        assert not _grads_close(out["grads"], {f"0.{k}": v for k, v in want["grads"][r].items()}), r
        np.testing.assert_allclose(out["dx"], want["dx"], rtol=5e-4, atol=1e-5)
        assert out["calls"]["pp_permute"] == 2 * _expected_permutes(world, 4, r)
    if kind == "remat":  # the checkpointed stage leaves the gradients of the plain one
        for r, res in enumerate(ranks[world]):
            plain = res["pp grad"]["grads"]
            assert not _grads_close(res["pp remat"]["grads"], plain, rtol=1e-5, atol=1e-7)


def test_dp_pp_grid_matches_jax(ranks):
    """dp 2 x pp 2 over 4 ranks (JAX's test_2d_dp_pp_mesh on a (2, 2) mesh):
    the microbatches' rows split over the data axis, each data row its own
    pipe; the loss's shares and the stage gradients summed over the data
    axis equal JAX's."""
    want = _jax_pp(4, "dp")
    for r, res in enumerate(ranks[4]):
        out = res["pp dp"]
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
        assert out["stage_blocks"] == [r % 2]
        assert not _grads_close(out["grads"], {f"0.{k}": v for k, v in want["grads"][r % 2].items()}), r
        np.testing.assert_allclose(out["dx"], np.split(want["dx"], 2, axis=1)[r // 2], rtol=5e-4, atol=1e-5)


def test_frozen_first_stage_still_runs_the_backward_schedule(ranks):
    """Stage 0's blocks frozen and the input taking no gradient (a fine-tune
    that trains the later blocks): stage 0 still walks the reverse ticks
    and receives the cotangents stage 1 sends, so stage 1's gradients are
    JAX's, stage 0 holds none, and the next case on the same ranks ("pp
    grad") finds no message left over."""
    want = _jax_pp(2, "grad")
    for r, res in enumerate(ranks[2]):
        out = res["pp frozen"]
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
        assert out["dx"] is None
        assert out["calls"]["pp_permute"] == 2 * _expected_permutes(2, 4, r)
        if r == 0:
            assert out["grads"] == {}
        else:
            assert not _grads_close(out["grads"], {f"0.{k}": v for k, v in want["grads"][r].items()})


def test_summed_output_backward_breaks_the_gradient_bound(ranks):
    """The planted fault: the output collective's backward summing the
    stages' cotangents gives each stage twice its gradient at 2 stages."""
    want = _jax_pp(2, "grad")
    for r, res in enumerate(ranks[2]):
        got = res["pp fault"]["grads"]
        bad = _grads_close(got, {f"0.{k}": v for k, v in want["grads"][r].items()})
        assert len(bad) == len(got), (r, bad)
        np.testing.assert_allclose(got["0.mlp.fc2.weight"], 2 * want["grads"][r]["mlp.fc2.weight"], rtol=5e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------- the pipelined AST


@pytest.mark.parametrize("world", [2, 4])
def test_pipelined_ast_matches_jax(ranks, world):
    """pipelined_ast_forward at (2 stages, 2 microbatches) and (4, 8) against
    JAX's on pipe meshes of those sizes and the flax ASTEncoder (eval), the
    same weights (the port's, carried to flax)."""
    stages, n_micro = AST_CASES[world]
    ref = _ast_inputs()[3]
    want = _jax_ast(stages, n_micro)
    np.testing.assert_allclose(want, ref, rtol=2e-5, atol=2e-5)
    for res in ranks[world]:
        np.testing.assert_allclose(res["pp_ast"]["out"], ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(res["pp_ast"]["out"], want, rtol=2e-5, atol=2e-5)
        assert res["pp_ast"]["calls"]["pp_output"] == 1


def _port_encoder():
    _, _, x, ref, state = _ast_inputs()
    enc = ASTEncoder(F_IN, T_IN, ASTConfig(**AST_KW)).eval()
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return enc, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), ref


def test_one_stage_pipelined_ast_equals_the_encoder():
    """One stage holding every block, in one process with no process group
    (JAX's test_block_matches_flax): the encoder's own forward and the
    flax encoder."""
    enc, x, ref = _port_encoder()
    with torch.no_grad():
        out = pipelined_ast_forward(enc, x, 2).numpy()
        np.testing.assert_allclose(out, enc(x).numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_block_twin_matches_jax_ast_block():
    """The port's ViTBlock (a stage's block) against JAX's pure ast_block on
    block 0's flax parameters."""
    enc, _, _ = _port_encoder()
    variables = _ast_inputs()[1]
    tok = np.random.default_rng(18).standard_normal((3, 10, AST_KW["embed_dim"])).astype(np.float32)
    want = np.asarray(ast_block(jax.tree.map(jnp.asarray, variables["params"]["block0"]), jnp.asarray(tok),
                                AST_KW["num_heads"]))
    with torch.no_grad():
        got = enc.blocks[0](torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_depth_or_batch_that_does_not_divide_raises():
    """JAX's test_depth_not_divisible_raises, and pipelined_ast_forward's
    batch check: both before any collective."""
    enc, x, _ = _port_encoder()
    with pytest.raises(ValueError, match="not divisible"):
        ast_stage_stack(enc, 3, 0)
    with pytest.raises(ValueError, match="depth 8 not divisible by 3 stages"):
        pipeline.stage_range(8, 3, 0)
    with pytest.raises(ValueError, match="batch 8 not divisible by n_micro 3"):
        pipelined_ast_forward(enc, x, 3)
