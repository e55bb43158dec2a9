"""Expert and sequence parallelism across processes on the CPU: gloo ranks of
the port (one ``torch.multiprocessing.spawn`` at world 2 and one at world
4; tests/torch_parallel_lib_worker.py) against the JAX package on meshes of
the host devices tests/conftest.py forces, every case of tests/test_moe.py,
tests/test_ring.py and tests/test_sp_frontend.py, and the collectives they
ride on:

* ``dist.ppermute`` and ``dist.all_to_all``, forward and backward, against
  JAX's semantics in numpy (zeros where no pair arrives; tiled all-to-all):
  exact;
* the Switch MoE (``moe_apply``) with ample capacity at E = 8 over 2 and 4
  ranks, and over 4 (JAX's tests' size) with capacity drops (E = 4,
  capacity 1) and the gradients, and on a dp 2 x ep 2 grid,
  against JAX's ``moe_apply`` / ``moe_ffn`` on meshes of the same shape and
  the dense per-token reference: outputs rtol 2e-5, atol 2e-5, the aux
  loss rtol 1e-5 (JAX's bounds); the router's and w1's gradients of
  mean(out^2) + 0.01 aux against JAX's ``jax.grad`` through ``moe_apply``:
  rtol 1e-4, atol 1e-7 (sums in another order);
* ring attention against dense softmax and JAX's ring: atol 2e-5 (JAX's);
* ``long_audio_forward`` on 2 and 4 ranks against JAX's on a 1-device mesh
  (one shard): logits atol 2e-4, rtol 1e-4 (JAX's 8-against-1 bound); the
  ranks' mean gradient of sum(emb^2) against JAX's ``jax.grad`` on that
  mesh: each tensor within 1e-4 of its own max|ref| + 1e-6 of the largest;
* ``sp_log_mel_local`` (10 s clips, the default config) against JAX's on a
  mesh of the same size: atol 1e-4 (JAX's own test holds it to the
  one-device frontend at atol 2e-3; the port's joined blocks are held to
  the port's one-process ``log_mel`` at 1e-4 too).

Planted faults that must break their bounds: an all-to-all whose backward
is not its inverse (a local re-layout), and a halo sent to the right
neighbour instead of the left.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from audiossl_tpu.frontend.sp import pad_for_sp as jax_pad_for_sp
from audiossl_tpu.frontend.sp import sp_log_mel_local as jax_sp_log_mel_local
from audiossl_tpu.frontend.stft import LogMelConfig as JaxLogMelConfig
from audiossl_tpu.frontend.stft import log_mel as jax_log_mel
from audiossl_tpu.parallel.mesh import make_mesh
from audiossl_tpu.parallel.moe import EXPERT_AXIS, make_expert_mesh, moe_apply, moe_ffn
from audiossl_tpu.parallel.ring import LongASTConfig as JaxLongASTConfig
from audiossl_tpu.parallel.ring import long_audio_forward, ring_attention
from audiossl_tpu_torch.frontend import sp
from audiossl_tpu_torch.frontend.stft import LogMelConfig, log_mel
from audiossl_tpu_torch.models.convert import long_ast_from_jax
from audiossl_tpu_torch.parallel import ring
from tests import torch_parallel_lib_worker as worker

D, H = 16, 32
LONG_FWD = dict(n_mels=64, time_patch=4, embed_dim=64, depth=2, num_heads=2, tokens_global=64, num_classes=5)
LONG_GRAD = dict(n_mels=64, time_patch=4, embed_dim=64, depth=1, num_heads=2, tokens_global=64, num_classes=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- inputs


def _prims(w):
    rng = _rng(20 + w)
    return {"x": rng.standard_normal((w, 4, 6)).astype(np.float32),
            "cot_y": rng.standard_normal((w, 4, 6)).astype(np.float32),
            "a": rng.standard_normal((w, 2 * w, 3, 5)).astype(np.float32),
            "cot_b": rng.standard_normal((w, 2, 3, 5 * w)).astype(np.float32),
            "perm": [(0, 1)] if w == 2 else [(0, 1), (1, 3), (3, 0)]}


@functools.lru_cache(maxsize=None)
def _moe_params(key, n_exp):
    """init_moe_params's dict (router [D, E], w1 [E, D, H], b1, w2 [E, H, D],
    b2), drawn in numpy (biases too, so they are held)."""
    rng = _rng(90 + key)
    w = lambda *s: (0.02 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {"router": (0.5 * rng.standard_normal((D, n_exp))).astype(np.float32), "w1": w(n_exp, D, H),
            "b1": w(n_exp, H), "w2": w(n_exp, H, D), "b2": w(n_exp, D)}


def _moe(key, n_exp, n, capacity, ep, seed, **kw):
    x = (0.7 * _rng(seed).standard_normal((n, D))).astype(np.float32)
    return {"params": _moe_params(key, n_exp), "x": x, "capacity": capacity, "ep": ep, **kw}


def _moe_cases(w):
    """Ample capacity at both worlds; at 4 (JAX's tests' size) the drops,
    the gradients with the planted fault, and dp 2 x ep 2."""
    cases = {"moe ample": _moe(0, 8, 8 * w, 8, w, 30 + w)}
    if w == 4:
        cases.update({"moe drops": _moe(1, 4, 4 * w, 1, w, 40 + w),
                      "moe grad": _moe(2, 4, 4 * w, 4, w, 50 + w, grad=True),
                      "moe dp": _moe(3, 8, 8 * w, 16, 2, 60, data=2)})
        cases["moe fault"] = {**cases["moe grad"], "fault": "local_all_to_all_backward"}
    return cases


@functools.lru_cache(maxsize=None)
def _long_params(kind):
    kw = LONG_FWD if kind == "fwd" else LONG_GRAD
    return JaxLongASTConfig(**kw), worker.jax_long_ast_params(kw, _rng(80 if kind == "fwd" else 81))


@functools.lru_cache(maxsize=None)
def _long_wave(kind):
    return (0.3 * _rng(17 if kind == "fwd" else 18).standard_normal((2 if kind == "fwd" else 1, 8 * 5120))).astype(
        np.float32)


def _seq_cases(w):
    rng = _rng(70 + w)
    qkv = {n: rng.standard_normal((2, 3, 8 * w, 16)).astype(np.float32) for n in ("q", "k", "v")}
    wave = (0.3 * _rng(13).standard_normal((2, 160000))).astype(np.float32)
    cases = {"ring_attention": qkv,
             "long_audio": {"cfg": LONG_FWD, "params": _long_params("fwd")[1], "wave": _long_wave("fwd")},
             "long_audio grad": {"cfg": LONG_GRAD, "params": _long_params("grad")[1], "wave": _long_wave("grad"),
                                 "grad": True},
             "sp": {"wave": wave}}
    if w == 2:
        cases["sp fault"] = {"wave": wave, "fault": "halo_to_right_neighbour"}
    return cases


def _inputs(w):
    return {"prims": _prims(w), **_moe_cases(w), **_seq_cases(w)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, both worlds spawned at once; while they run,
    this process makes the JAX references."""
    d = tmp_path_factory.mktemp("moe_sp")
    ctxs = {}
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for world in (2, 4):
            sub = d / f"world{world}"
            sub.mkdir()
            torch.save(_inputs(world), str(sub / "in.pt"))
            ctxs[world] = torch.multiprocessing.spawn(worker.run, args=(world, f"file://{sub / 'rendezvous'}",
                                                                        str(sub / "in.pt"), str(sub)), nprocs=world,
                                                      join=False)
    finally:
        os.environ.pop("OMP_NUM_THREADS") if env is None else os.environ.__setitem__("OMP_NUM_THREADS", env)
    try:
        for world in (2, 4):
            for name in _moe_cases(world):
                if name != "moe fault":
                    _jax_moe(world, name.split()[1])
            _jax_ring(world)
            _jax_sp(world)
        _jax_long("fwd")
        _jax_long("grad")
    finally:
        for ctx in ctxs.values():
            while not ctx.join():
                pass
    return {world: [torch.load(str(d / f"world{world}" / f"rank{r}.pt"), weights_only=False) for r in range(world)]
            for world in ctxs}


def _joined(res, name, key="out", axis=0):
    return np.concatenate([r[name][key] for r in res], axis=axis)


# ---------------------------------------------------------------- the collectives


@pytest.mark.parametrize("world", [2, 4])
def test_ppermute_and_all_to_all_have_jax_semantics(ranks, world):
    """ppermute: each destination gets its source's rows, a rank no pair
    reaches gets zeros, the backward runs the inverted pairs; all_to_all
    (split dim 0, join dim 2): jax.lax.all_to_all(tiled=True), its backward
    the inverse. One call each way on a rank that sends or receives."""
    d = _prims(world)
    perm = dict((dst, src) for src, dst in d["perm"])
    for r, res in enumerate(ranks[world]):
        out = res["prims"]
        want_y = d["x"][perm[r]] if r in perm else np.zeros_like(d["x"][r])
        dst = dict(d["perm"]).get(r)
        want_dx = d["cot_y"][dst] if dst is not None else np.zeros_like(d["x"][r])
        np.testing.assert_array_equal(out["y"], want_y)
        np.testing.assert_array_equal(out["dx"], want_dx)
        want_b = np.concatenate([d["a"][i][2 * r:2 * r + 2] for i in range(world)], axis=2)
        want_da = np.concatenate([d["cot_b"][j][..., 5 * r:5 * r + 5] for j in range(world)], axis=0)
        np.testing.assert_array_equal(out["b"], want_b)
        np.testing.assert_array_equal(out["da"], want_da)
        moves = int(r in perm) + int(dst is not None) > 0
        assert out["calls"] == {**({"test_ppermute": 2} if moves else {}), "test_all_to_all": 2}
    mesh = make_mesh(world, "x")  # JAX's own all_to_all on the same rows
    got = shard_map(lambda a: jax.lax.all_to_all(a[0], "x", 0, 2, tiled=True)[None], mesh=mesh, in_specs=P("x"),
                    out_specs=P("x"), check_vma=False)(jnp.asarray(d["a"]))
    np.testing.assert_array_equal(np.asarray(got), np.stack([r["prims"]["b"] for r in ranks[world]]))


# ---------------------------------------------------------------- experts


def _dense_reference(params, x, dropped=None):
    """JAX's test_moe.py reference: per-token top-1 expert FFN, gate-scaled."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x @ params["router"]), axis=-1))
    expert, gate = probs.argmax(-1), probs.max(-1)
    out = np.zeros_like(x)
    for i, (e, g) in enumerate(zip(expert, gate)):
        if dropped is None or not dropped[i]:
            h = jax.nn.gelu(jnp.asarray(x[i]) @ params["w1"][e] + params["b1"][e], approximate=False)
            out[i] = g * np.asarray(h @ params["w2"][e] + params["b2"][e])
    return out, expert, probs


@functools.lru_cache(maxsize=None)
def _jax_moe(world, kind):
    case = _moe_cases(world)[f"moe {kind}"]
    params, x, cap = jax.tree.map(jnp.asarray, case["params"]), jnp.asarray(case["x"]), case["capacity"]
    if kind == "dp":
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", EXPERT_AXIS))
        specs = {"router": P(), "w1": P(EXPERT_AXIS), "b1": P(EXPERT_AXIS), "w2": P(EXPERT_AXIS),
                 "b2": P(EXPERT_AXIS)}

        def f(p, xl):
            out, aux = moe_ffn(p, xl, capacity=cap, axis=EXPERT_AXIS)
            return out, jax.lax.pmean(aux, "data")

        out, aux = jax.jit(shard_map(f, mesh=mesh, in_specs=(specs, P(("data", EXPERT_AXIS))),
                                     out_specs=(P(("data", EXPERT_AXIS)), P()), check_vma=False))(params, x)
        return {"out": np.asarray(out), "aux": float(aux)}
    mesh = make_expert_mesh(world)
    out, aux = moe_apply(mesh, params, x, capacity=cap)
    ref = {"out": np.asarray(out), "aux": float(aux)}
    if kind == "grad":
        def loss(p):
            o, a = moe_apply(mesh, p, x, capacity=cap)
            return jnp.mean(o ** 2) + 0.01 * a

        g = jax.grad(loss)(params)
        ref.update(router=np.asarray(g["router"]), w1=np.asarray(g["w1"]))
    return ref


@pytest.mark.parametrize("world,kind", [(2, "ample"), (4, "ample"), (4, "drops")])
def test_moe_matches_jax(ranks, world, kind):
    """Ample capacity (E = 8: 4 or 2 experts a rank) and, over 4 ranks,
    capacity 1 (E = 4, tokens past a full expert dropped): the joined outputs and the aux loss
    against JAX's moe_apply on a mesh of the same size and the dense
    reference (with the drops JAX's test works out). Two all-to-alls and
    one aux sum a rank."""
    case = _moe_cases(world)[f"moe {kind}"]
    want = _jax_moe(world, kind)
    dropped = None
    _, expert, probs = _dense_reference(case["params"], case["x"])
    if kind == "drops":
        dropped = np.zeros(len(expert), bool)
        for dev in range(world):
            seen = {}
            for i in range(dev * 4, dev * 4 + 4):
                dropped[i] = seen.get(expert[i], 0) >= case["capacity"]
                seen[expert[i]] = seen.get(expert[i], 0) + 1
        assert dropped.any(), "the case should overflow at capacity 1"
    ref, _, _ = _dense_reference(case["params"], case["x"], dropped)
    got = _joined(ranks[world], f"moe {kind}")
    np.testing.assert_allclose(want["out"], ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want["out"], rtol=2e-5, atol=2e-5)
    n_exp = probs.shape[1]
    expected_aux = n_exp * float(np.sum(np.eye(n_exp)[expert].mean(0) * probs.mean(0)))
    for res in ranks[world]:
        np.testing.assert_allclose(res[f"moe {kind}"]["aux"], want["aux"], rtol=1e-5)
        np.testing.assert_allclose(res[f"moe {kind}"]["aux"], expected_aux, rtol=1e-5)
        assert res[f"moe {kind}"]["calls"] == {"ep_all_to_all": 2, "ep_aux": 1}


def test_moe_on_a_dp_ep_grid_matches_jax(ranks):
    """dp 2 x ep 2 over 4 ranks (JAX's test_2d_dp_ep_mesh on a (2, 2) mesh):
    tokens split over both axes, experts over the expert axis; the outputs
    against JAX's and the dense reference, the aux loss (the data rows'
    mean) against JAX's pmean."""
    case = _moe_cases(4)["moe dp"]
    want = _jax_moe(4, "dp")
    ref, _, _ = _dense_reference(case["params"], case["x"])
    got = _joined(ranks[4], "moe dp")
    np.testing.assert_allclose(want["out"], ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want["out"], rtol=2e-5, atol=2e-5)
    for res in ranks[4]:
        np.testing.assert_allclose(res["moe dp"]["aux"], want["aux"], rtol=1e-5)


def test_moe_grads_match_jax_grad(ranks):
    """Over 4 ranks (JAX's test_router_receives_gradient): the router's
    gradient (each rank's share of mean(out^2) + 0.01 aux, the aux loss
    counted once, summed over the group) and w1's (each rank's experts'
    rows) against JAX's jax.grad through moe_apply."""
    want = _jax_moe(4, "grad")
    assert np.abs(want["router"]).max() > 0 and np.abs(want["w1"]).max() > 0
    for res in ranks[4]:
        np.testing.assert_allclose(res["moe grad"]["router"], want["router"], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(res["moe grad"]["w1"], want["w1"], rtol=1e-4, atol=1e-7)
        # two forward, one backward: the dispatch's input takes no gradient (x and the one-hot slots are constants)
        assert res["moe grad"]["calls"]["ep_all_to_all"] == 3


def test_all_to_all_backward_that_is_not_the_inverse_breaks_the_bound(ranks):
    """The planted fault: each rank's cotangents re-laid locally, never
    exchanged, in the all-to-alls' backward: w1's gradient leaves the
    bound. The forward is untouched, and so is the router's gradient, which
    reaches the router through the gate and the aux loss, not back through
    an all-to-all."""
    want = _jax_moe(4, "grad")
    for res in ranks[4]:
        np.testing.assert_array_equal(res["moe fault"]["out"], res["moe grad"]["out"])
        np.testing.assert_array_equal(res["moe fault"]["router"], res["moe grad"]["router"])
        assert not np.allclose(res["moe fault"]["w1"], want["w1"], rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------- sequence


@functools.lru_cache(maxsize=None)
def _jax_ring(world):
    d = _seq_cases(world)["ring_attention"]
    q, k, v = (jnp.asarray(d[n]) for n in ("q", "k", "v"))
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(16.0)
    dense = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v))
    mesh, spec = make_mesh(world), P(None, None, "data", None)
    out = jax.jit(shard_map(lambda a, b, c: ring_attention(a, b, c, "data"), mesh=mesh, in_specs=(spec,) * 3,
                            out_specs=spec, check_vma=False))(q, k, v)
    return dense, np.asarray(out)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_equals_dense_softmax(ranks, world):
    """Each rank's queries against the whole sequence's keys, K and V
    rotated W - 1 hops (one tensor a hop), equal dense softmax attention and
    JAX's ring_attention."""
    dense, jax_ring = _jax_ring(world)
    got = _joined(ranks[world], "ring_attention", axis=2)
    np.testing.assert_allclose(got, dense, atol=2e-5)
    np.testing.assert_allclose(got, jax_ring, atol=2e-5)
    for res in ranks[world]:
        assert res["ring_attention"]["calls"] == {"sp_ring": world - 1}


@functools.lru_cache(maxsize=None)
def _jax_long(kind):
    """JAX's long_audio_forward on a 1-device mesh (one shard): the logits,
    or the gradient of sum(emb^2) in the port's names."""
    cfg, params = _long_params(kind)
    mel_cfg = JaxLogMelConfig(center=False)
    mesh = make_mesh(1)
    wave = jax.device_put(jnp.asarray(_long_wave(kind)), NamedSharding(mesh, P(None, "data")))
    p = jax.tree.map(jnp.asarray, params)
    if kind == "fwd":
        f = shard_map(lambda p_, wl: long_audio_forward(p_, wl, mel_cfg, cfg, "data"), mesh=mesh,
                      in_specs=(P(), P(None, "data")), out_specs=P(), check_vma=False)
        return np.asarray(jax.jit(f)(p, wave))

    def loss(p_, wl):
        emb = long_audio_forward(p_, wl, mel_cfg, cfg, "data")
        return jnp.sum(emb * emb)

    g = jax.jit(shard_map(lambda p_, wl: jax.grad(loss)(p_, wl), mesh=mesh, in_specs=(P(), P(None, "data")),
                          out_specs=P(), check_vma=False))(p, wave)
    return {k: v.numpy() for k, v in long_ast_from_jax(_np_tree(g)).items()}


@pytest.mark.parametrize("world", [2, 4])
def test_long_audio_sharded_matches_jax_on_one_device(ranks, world):
    """The blockwise AST behind the sp log-mel, the waveform split over 2
    and 4 ranks (20480 and 10240 samples a rank, 32 and 16 tokens), against
    JAX's long_audio_forward unsharded: every rank holds the whole logits.
    Collectives a rank: one halo, W - 1 ring hops a block, one pool sum."""
    want = _jax_long("fwd")
    for res in ranks[world]:
        assert res["long_audio"]["out"].shape == (2, 5)
        np.testing.assert_allclose(res["long_audio"]["out"], want, atol=2e-4, rtol=1e-4)
        assert res["long_audio"]["calls"] == {"sp_halo": 1, "sp_ring": 2 * (world - 1), "sp_pool": 1}


@pytest.mark.parametrize("world", [2, 4])
def test_long_audio_mean_grads_match_jax_grad(ranks, world):
    """The ranks' mean gradient of sum(emb^2) (each rank JAX's per-device
    gradient inside shard_map: the pool's sum has a summed backward) against
    JAX's jax.grad on one device; every tensor, the positional table (each
    rank's own rows) included."""
    want = _jax_long("grad")
    largest = max(float(np.abs(w).max()) for w in want.values())
    for res in ranks[world]:
        got = res["long_audio grad"]["grads"]
        bad = {k: float(np.abs(got[k] - w).max()) for k, w in want.items()
               if np.abs(got[k] - w).max() > 1e-4 * np.abs(w).max() + 1e-6 * largest}
        assert not bad, bad


def test_long_ast_refuses_a_split_that_does_not_fit():
    """JAX's two errors: a local frame count the time patch does not divide,
    and shards x local tokens that are not tokens_global (a later shard
    would read positions past the table)."""
    model = ring.LongAST(ring.LongASTConfig(**LONG_FWD))
    with pytest.raises(ValueError, match="not divisible by time_patch 4"):
        model(torch.zeros(1, 64, 30))
    with pytest.raises(ValueError, match="1 shards x 8 tokens/shard != tokens_global=64"):
        model(torch.zeros(1, 64, 32))


@functools.lru_cache(maxsize=None)
def _jax_sp(world):
    cfg = JaxLogMelConfig()
    wave = jnp.asarray(_seq_cases(world)["sp"]["wave"])
    mesh = make_mesh(world)
    padded = jax.device_put(jax_pad_for_sp(wave, cfg, world), NamedSharding(mesh, P(None, "data")))
    f = shard_map(lambda wl: jax_sp_log_mel_local(wl, cfg, "data"), mesh=mesh, in_specs=P(None, "data"),
                  out_specs=P(None, None, "data"), check_vma=False)
    return np.asarray(jax.jit(f)(padded)), np.asarray(jax_log_mel(wave, cfg))


@pytest.mark.parametrize("world", [2, 4])
def test_sp_log_mel_matches_jax(ranks, world):
    """10 s clips (JAX's test_sp_log_mel_matches_single_device), padded by
    pad_for_sp and split over 2 and 4 ranks: the joined blocks against
    JAX's sp_log_mel_local on a mesh of that size; cut to sp_num_frames,
    against the one-process frontends (JAX's, at its 2e-3; the port's,
    at 1e-4). Each rank's block stays its own (1001 frames padded to a
    multiple of W, T / W a rank); one halo call."""
    want, ref = _jax_sp(world)
    got = _joined(ranks[world], "sp", axis=2)
    n_frames = sp.sp_num_frames(LogMelConfig(), 160000)
    assert got.shape == want.shape and ranks[world][0]["sp"]["out"].shape[2] == want.shape[2] // world
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got[..., :n_frames], ref, atol=2e-3, rtol=1e-5)
    port_ref = log_mel(torch.from_numpy(_seq_cases(world)["sp"]["wave"])).numpy()
    np.testing.assert_allclose(got[..., :n_frames], port_ref, atol=1e-4)
    for res in ranks[world]:
        assert res["sp"]["calls"] == {"sp_halo": 1}


def test_halo_to_the_wrong_neighbour_breaks_the_bound(ranks):
    """The planted fault: the head sent right instead of left; the frames
    that read past rank 0's slice leave the bound."""
    want, _ = _jax_sp(2)
    got = _joined(ranks[2], "sp fault", axis=2)
    assert np.abs(got - want).max() > 1.0


def test_sp_log_mel_refuses_a_slice_it_cannot_frame():
    """JAX's two errors: a slice shorter than the halo, a length that is
    not a multiple of hop."""
    cfg = LogMelConfig()
    with pytest.raises(ValueError, match="shorter than the frame halo"):
        sp.sp_log_mel_local(torch.zeros(1, 800), cfg)
    with pytest.raises(ValueError, match="multiple of hop"):
        sp.sp_log_mel_local(torch.zeros(1, 1000), cfg)
