"""The port's DECAR-v2 and DeepCluster-v1 pieces against the JAX package on
the CPU, on the same numpy inputs and fed draws: LARS and LARC over 5 steps
(1e-6), ``decar_ce`` (0 where every target is ignored), ``memory_update``,
``kmeans_on_mesh`` from the same initial picks (assignments equal), one
DECAR step (loss, gradients, BatchNorm statistics, the LARC update with the
frozen prototypes' decay, the bank), two DeepCluster steps around the top
layer's momentum reset, the converters and the DINO loss. f32, dropout 0,
d = 64, B = 8, views [8, 64, 96]; the tolerances of
tests/test_torch_port_objectives.py, gradients at 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from audiossl_tpu.models.audiontt import AudioNTT2020Task6 as JaxAudioNTT
from audiossl_tpu.objectives import decar as jdecar
from audiossl_tpu.objectives import dino as jdino
from audiossl_tpu.objectives.unfused import cross_entropy as jax_cross_entropy
from audiossl_tpu.train import optim as joptim
from audiossl_tpu.train.deepcluster_loop import reset_subtree_opt_state as jax_reset
from audiossl_tpu_torch.models.convert import decar_from_flax, deepcluster_from_flax
from audiossl_tpu_torch.objectives import decar, dino, init_objective
from audiossl_tpu_torch.objectives.unfused import cross_entropy
from audiossl_tpu_torch.train import optim
from audiossl_tpu_torch.train.deepcluster_loop import DeepClusterNet, reset_subtree_opt_state
from tests.test_torch_port_objectives import B, D, TOL_LOSS, TOL_STATS, config, jax_state, rel

TOL_OPT = 1e-6  # optimizer trajectories, relative
TOL_GRAD = 1e-4  # of each tensor's max|ref|, + TOL_GRAD_FLOOR of the largest gradient
TOL_GRAD_FLOOR = 1e-5
TOL_PARAM = 1e-4  # parameters after an update, relative to each tensor's max: the gradients' bound
# biases in front of a batch-statistics BatchNorm: their gradient is 0 up to
# round-off, which LARC rescales to trust * |p| / |g| (so its direction is noise)
TOL_BANK = 1e-4  # view 1's embeddings: a training-mode forward through BatchNorms on 8 clips' statistics
ROUNDOFF_GRADS = ("net.encoder.features_1.0.bias", "net.encoder.features_2.0.bias", "net.encoder.features_3.0.bias",
                  "net.proj_fc1.bias")
PROTOTYPES = (6, 4)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread for these tiny models: with the suite's
    workers sharing the cores, torch's default of a thread a core makes each
    small op wait for threads the other workers hold (the CLI runs of the
    clustering family took 23x their time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- optimizers


def _opt_case(seed):
    """Parameters (a matrix, a conv kernel, a bias, one at zero) and five
    steps of gradients (one tensor's gradient is 0 in every step)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (5, 3), "conv": (2, 1, 3, 3), "b": (3,), "zero": (4, 2), "still": (3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params["zero"][:] = 0.0
    grads = [{k: (0.0 if k == "still" else 1.0) * rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    return params, grads


def _run_optax(tx, params, grads):
    p, st = jax.tree_util.tree_map(jnp.asarray, params), tx.init(params)
    for g in grads:
        u, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, p)
        p = optax.apply_updates(p, u)
    return np_tree(p)


def _run_torch(name, params, grads, lr, **kw):
    ts = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched = optim.build_optimizer(name, list(ts.values()), lr, **kw)
    for g in grads:
        for k, t in ts.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        if sched is not None:
            sched.step()
    return {k: t.detach().numpy() for k, t in ts.items()}


@pytest.mark.parametrize("clip", [False, True])
def test_larc_matches_optax_over_five_steps(clip):
    params, grads = _opt_case(0)
    sched_t = optim.warmup_cosine(0.5, 5, 2, end_lr_factor=0.1)
    sched_j = joptim.warmup_cosine(0.5, 5, 2, end_lr_factor=0.1)
    kw = dict(momentum=0.9, weight_decay=1e-2, trust_coefficient=0.02, clip=clip)
    got = _run_torch("larc", params, grads, sched_t, **kw)
    want = _run_optax(joptim.larc(sched_j, **kw), params, grads)
    for k in params:
        assert rel(got[k], want[k]) <= TOL_OPT, k
    # a zero gradient takes scale 1: its decay alone moved the parameter
    assert not np.array_equal(got["still"], params["still"])


def test_lars_matches_optax_descending_over_five_steps():
    """The port's LARS descends, as the reference's (p -= lr * mu); optax
    ``lars`` of the JAX package negates its update twice and ascends, so it
    is held with the rate negated, and its own sign is recorded."""
    params, grads = _opt_case(1)
    kw = dict(weight_decay=1e-2, momentum=0.9, eta=0.02)
    got = _run_torch("lars", params, grads, 0.1, **kw)
    want = _run_optax(joptim.lars(-0.1, **kw), params, grads)
    for k in params:
        assert rel(got[k], want[k]) <= TOL_OPT, k
    one = _run_torch("lars", params, grads[:1], 0.1, **kw)
    ascends = _run_optax(joptim.lars(0.1, **kw), params, grads[:1])
    # after one step (mu = the update): the port moves against it, JAX with it, by the same amount
    np.testing.assert_allclose(one["w"] - params["w"], params["w"] - ascends["w"], rtol=1e-5, atol=1e-8)
    assert np.sum((one["b"] - params["b"]) * grads[0]["b"]) < 0  # 1-D: no decay, no trust ratio


# ---------------------------------------------------------------- DECAR pieces


def test_decar_ce_matches_jax_and_is_zero_when_every_target_is_ignored():
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((6, 5)).astype(np.float32)
    for targets in ([1, -100, 2, 4, -100, 0], [-100] * 6, [3] * 6):
        t = np.asarray(targets)
        got = decar.decar_ce(torch.from_numpy(scores), torch.from_numpy(t), 0.7)
        want = float(jdecar.decar_ce(jnp.asarray(scores), jnp.asarray(t), 0.7))
        assert abs(float(got) - want) <= TOL_LOSS * max(abs(want), 1.0)
    assert float(got) > 0.0
    empty = decar.decar_ce(torch.from_numpy(scores), torch.full((6,), -100), 1.0)
    assert float(empty) == 0.0
    assert torch.isnan(F.cross_entropy(torch.from_numpy(scores), torch.full((6,), -100), ignore_index=-100))


def test_memory_update_and_kmeans_on_mesh_match_jax():
    rng = np.random.default_rng(3)
    m, dim, k, n_total = 24, 8, 5, 30
    emb = rng.standard_normal((m, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    idx = rng.permutation(n_total)[:m].astype(np.int32)
    idx[[3, 17]] = -1  # unfilled slots
    new = rng.standard_normal((4, dim)).astype(np.float32)
    new_idx = np.setdiff1d(np.arange(n_total), idx)[:4].astype(np.int32)  # clips no slot held
    e_j, i_j = jdecar.memory_update(jnp.asarray(emb), jnp.asarray(idx), jnp.asarray(new), jnp.asarray(new_idx), 7)
    e_t, i_t = torch.from_numpy(emb.copy()), torch.from_numpy(idx.astype(np.int64))
    decar.memory_update(e_t, i_t, torch.from_numpy(new), torch.from_numpy(new_idx.astype(np.int64)), 7)  # slots 4..7
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    key = jax.random.key(5)
    c_j, a_j = jdecar.kmeans_on_mesh(e_j, i_j, n_total, k, key, n_iters=4, axis_name=None)
    pick = torch.from_numpy(np.array(jax.random.permutation(key, m)[:k]))
    c, a = decar.kmeans_on_mesh(e_t, i_t, n_total, k, pick, n_iters=4)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    assert rel(c.numpy(), c_j) <= TOL_LOSS
    held = np.unique(i_t.numpy()[i_t.numpy() >= 0])
    assert (a.numpy() == -100).sum() == n_total - len(held)  # clips no slot holds
    with pytest.raises(ValueError, match="exceeds per-shard memory"):
        decar.kmeans_on_mesh(e_t, i_t, n_total, m + 1, torch.arange(m + 1))


@pytest.fixture(scope="module")
def jax_decar():
    cfg = config("decar_v2", feat_dim=16, nmb_prototypes=list(PROTOTYPES), temperature=0.5)
    jobj = jdecar.DecarV2(cfg, axis_name=None)
    params, batch_stats, _, views = jax_state(jobj, 4)
    return cfg, jobj, params, batch_stats, views


def test_decar_converter_round_trips_strictly_and_exactly(jax_decar):
    cfg, _, params, batch_stats, _ = jax_decar
    sd = decar_from_flax(params, batch_stats)
    obj = init_objective("decar_v2", cfg, seed=0)
    obj.load_state_dict(sd, strict=True)
    got = obj.state_dict()
    assert sorted(got) == sorted(sd) and all(torch.equal(got[k], v) for k, v in sd.items())
    np.testing.assert_array_equal(got["net.prototypes1.weight"].numpy(), np.asarray(params["prototypes1"]["kernel"]).T)
    assert obj.labeled and obj.export_state_dict()["fc.3.weight"].shape == (D, D)


def test_decar_step_matches_jax(jax_decar):
    """On each of four batches, from the same weights: view 1's pass (no
    gradient) then view 2's, CE over both heads against targets with
    ignored entries, prototype gradients frozen (zeroed), one LARC step, and
    the bank refreshed from view 1's embeddings. The loss, BatchNorm
    statistics, bank and updated parameters hold in every batch; every
    gradient bound in at least half of them (routing flips at round-off,
    tests/test_torch_port_objectives.py:hold_steps)."""
    cfg, jobj, params, batch_stats, views = jax_decar
    lr, wd = 0.5, 1e-6
    tx = joptim.larc(lr, momentum=0.9, weight_decay=wd, trust_coefficient=0.001, clip=False)
    rng = np.random.default_rng(9)
    m = 3 * B
    mem = rng.standard_normal((m, 16)).astype(np.float32)
    mem_idx = np.arange(m, dtype=np.int32)

    @jax.jit
    def jax_step(v1, v2, targets, idxs):
        def loss_fn(p):
            (emb, _), mut = jobj.apply_net(p, batch_stats, v1, jax.random.key(0), True)
            (_, scores2), mut = jobj.net.apply({"params": p, "batch_stats": mut["batch_stats"]}, v2, True,
                                               rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
            loss = sum(jdecar.decar_ce(s, t, jobj.temperature) for s, t in zip(scores2, targets)) / len(scores2)
            return loss, (emb, mut["batch_stats"])

        (loss, (emb, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        frozen = jobj.freeze_prototype_grads(grads, jnp.zeros((), jnp.int32))
        updates, _ = tx.update(frozen, tx.init(params), params)
        e, i = jdecar.memory_update(jnp.asarray(mem), jnp.asarray(mem_idx), emb, idxs, 1)
        return loss, grads, new_bs, optax.apply_updates(params, updates), e, i

    passing = 0
    for n, (v1, v2, _) in enumerate(views):
        targets = rng.integers(0, 4, (2, B))
        targets[:, n % B] = -100  # an ignored clip in each batch
        idxs = rng.integers(0, 40, B)
        loss_j, grads_j, bs_j, params_j, mem_j, idx_j = jax_step(
            jnp.asarray(v1)[..., None], jnp.asarray(v2)[..., None], jnp.asarray(targets), jnp.asarray(idxs))
        obj = init_objective("decar_v2", cfg, seed=0).train()
        obj.load_state_dict(decar_from_flax(params, batch_stats), strict=True)
        opt, _ = optim.build_optimizer("larc", list(obj.parameters()), lr, momentum=0.9, weight_decay=wd,
                                       trust_coefficient=0.001, clip=False)
        loss, emb = obj.step_loss(torch.from_numpy(v1)[:, None], torch.from_numpy(v2)[:, None],
                                  torch.from_numpy(targets))
        loss.backward()
        assert rel(loss.item(), float(loss_j)) < TOL_LOSS
        grads = decar_from_flax(np_tree(grads_j), np_tree(bs_j))
        named = dict(obj.named_parameters())
        scale = max(float(grads[k].abs().max()) for k in named)
        passing += all(float((p.grad - grads[k]).abs().max()) <= TOL_GRAD * float(grads[k].abs().max())
                       + TOL_GRAD_FLOOR * scale for k, p in named.items())
        before = {k: p.detach().clone() for k, p in named.items()}
        obj.freeze_prototype_grads(0)
        assert all(float(p.weight.grad.abs().max()) == 0.0 for p in obj.net.prototypes())
        opt.step()
        after = decar_from_flax(np_tree(params_j), np_tree(bs_j))
        state = obj.state_dict()
        for k, v in after.items():
            if k in ROUNDOFF_GRADS:  # both moved by at most lr (trust |p| + wd |p|) in norm
                bound = lr * (0.001 + wd) * float(before[k].norm()) * 1.001
                assert float((state[k] - before[k]).norm()) <= bound and float((v - before[k]).norm()) <= bound, k
            elif v.is_floating_point():
                assert rel(state[k].numpy(), v.numpy()) <= (TOL_STATS if "running" in k else TOL_PARAM), k
        for i in range(len(PROTOTYPES)):  # frozen: the decay alone moved them, by -lr wd p (f32 round-off aside)
            k = f"net.prototypes{i}.weight"
            moved, decay = state[k].double() - before[k].double(), -lr * wd * before[k].double()
            assert float((moved - decay).norm()) <= 0.25 * float(decay.norm()), k
        mem_t, idx_t = torch.from_numpy(mem.copy()), torch.from_numpy(mem_idx.astype(np.int64))
        decar.memory_update(mem_t, idx_t, emb, torch.from_numpy(idxs), 1)
        assert rel(mem_t.numpy(), mem_j) <= TOL_BANK
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert passing >= len(views) / 2, f"{passing} of {len(views)} batches pass every gradient bound"


# ---------------------------------------------------------------- DeepCluster-v1


def test_deepcluster_steps_around_the_momentum_reset_match_jax():
    """Two SGD steps (lr 0.05, momentum 0.9, coupled decay 1e-5) of the
    frame-mean AudioNTT + top layer on CE, a fresh top layer with its
    momentum zeroed (the encoder's kept) between them, as each epoch starts:
    losses, the momentum after the reset, and the parameters after each
    step (the second from JAX's state after the first on both sides)."""
    rng = np.random.default_rng(11)
    k = 5
    enc = JaxAudioNTT(n_mels=64, d=D, compute_dtype=jnp.float32, dropout_rate=0.0)
    variables = enc.init({"params": jax.random.key(1)}, jnp.zeros((B, 64, 96, 1)), False)
    tops = [{"kernel": (rng.standard_normal((D, k)) / np.sqrt(D)).astype(np.float32), "bias": np.zeros(k, np.float32)}
            for _ in range(2)]
    params = {"encoder": np_tree(variables["params"]), "top_layer": tops[0]}
    batch_stats = np_tree(variables["batch_stats"])
    batches = [((1.5 * rng.standard_normal((B, 64, 96))).astype(np.float32), rng.integers(0, k, B)) for _ in range(2)]
    tx = optax.chain(optax.add_decayed_weights(1e-5), optax.sgd(0.05, momentum=0.9))

    @jax.jit
    def jax_step(p, bs, st, v, y):
        def loss_fn(q):
            emb, mut = enc.apply({"params": q["encoder"], "batch_stats": bs}, v[..., None], True,
                                 mutable=["batch_stats"])
            logits = jnp.mean(emb, axis=1) @ q["top_layer"]["kernel"] + q["top_layer"]["bias"]
            return jax_cross_entropy(logits, y), mut["batch_stats"]

        (loss, new_bs), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), new_bs, st, loss

    net = DeepClusterNet(64, D, k, compute_dtype=torch.float32, dropout_rate=0.0).train()
    net.load_state_dict(deepcluster_from_flax(params, {"encoder": batch_stats}), strict=True)
    opt = optim.sgd_torch(net.parameters(), 0.05, momentum=0.9, weight_decay=1e-5)
    p, bs, st = params, batch_stats, tx.init(params)
    for step, (v, y) in enumerate(batches):
        if step:  # an epoch starts: a fresh top layer, its momentum zeroed
            trace = deepcluster_from_flax(np_tree(st[1][0].trace), {"encoder": np_tree(bs)})
            reset_subtree_opt_state(opt, net.top_layer)
            bufs = {name: opt.state[q]["momentum_buffer"] for name, q in net.named_parameters()}
            assert all(float(bufs[name].abs().max()) == 0.0 for name in ("top_layer.weight", "top_layer.bias"))
            # the encoder's kept, not zeroed: all of it JAX's within the 1e-2 (in norm) that a routing
            # flip at round-off can move one batch's gradients
            enc = [name for name in bufs if name.startswith("encoder.")]
            got, ref = (torch.cat([t[name].flatten() for name in enc]) for t in (bufs, trace))
            assert float((got - ref).norm()) <= 1e-2 * float(ref.norm())
            # both sides go on from JAX's state after step 1, so step 2 holds to step 1's bounds
            net.load_state_dict(deepcluster_from_flax(np_tree(p), {"encoder": np_tree(bs)}), strict=True)
            st = jax_reset(st, "top_layer")
            trace = deepcluster_from_flax(np_tree(st[1][0].trace), {"encoder": np_tree(bs)})
            for name, q in net.named_parameters():
                opt.state[q]["momentum_buffer"].copy_(trace[name])
            p = dict(p) | {"top_layer": jax.tree_util.tree_map(jnp.asarray, tops[1])}
            net.reset_top_layer_(torch.from_numpy(tops[1]["kernel"].T.copy()))
        p, bs, st, loss_j = jax_step(p, bs, st, jnp.asarray(v), jnp.asarray(y))
        loss = cross_entropy(net(torch.from_numpy(v)[:, None])[1], torch.from_numpy(y))
        opt.zero_grad()
        loss.backward()
        opt.step()
        assert rel(loss.item(), float(loss_j)) < TOL_LOSS
        want = deepcluster_from_flax(np_tree(p), {"encoder": np_tree(bs)})
        state = net.state_dict()
        for name, v_ in want.items():
            if not v_.is_floating_point():
                continue
            # relative to max(1, max|ref|): the BatchNorm shifts and the biases start at 0, so their own
            # scale is the update's, which a routing flip at round-off moves by up to 1e-2
            err = float((state[name] - v_).abs().max())
            assert err <= (TOL_STATS if "running" in name else TOL_PARAM) * max(1.0, float(v_.abs().max())), name
            if name.startswith("top_layer."):
                assert rel(state[name].numpy(), v_.numpy()) <= TOL_PARAM, name


# ---------------------------------------------------------------- DINO


@pytest.mark.parametrize("simplified", [True, False])
def test_dino_loss_and_center_match_jax(simplified):
    rng = np.random.default_rng(12)
    s, t = (rng.standard_normal((6, 10)).astype(np.float32) for _ in range(2))
    center = 0.1 * rng.standard_normal((1, 10)).astype(np.float32)
    loss_j, st_j = jdino.dino_loss(jnp.asarray(s), jnp.asarray(t), jdino.DinoState(jnp.asarray(center)), 0.04,
                                   simplified=simplified)
    loss, st = dino.dino_loss(torch.from_numpy(s), torch.from_numpy(t), dino.DinoState(torch.from_numpy(center)),
                              0.04, simplified=simplified)
    assert rel(loss.item(), float(loss_j)) < TOL_LOSS
    assert rel(st.center.numpy(), st_j.center) < TOL_LOSS
    np.testing.assert_array_equal(dino.teacher_temp_schedule(0.04, 0.07, 3, 5),
                                  jdino.teacher_temp_schedule(0.04, 0.07, 3, 5))
    assert torch.equal(dino.dino_init(10).center, torch.zeros(1, 10))
