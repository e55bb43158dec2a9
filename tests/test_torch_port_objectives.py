"""The port's DeLoRes-M against the JAX package on the CPU: one step's loss,
gradients, BatchNorm statistics, key encoder, queue and pointer from the
same weights on each of four batches of views (carried by ``models.convert.delores_m_from_flax``),
an 8-step SGD trajectory, the converters, the losses SLICER and UnFuSeD
add, the 64-mel refusal of the objectives with tap heads and a SLICER
step at 128 mels. f32, dropout 0, d = 64, B = 8, views
[8, 64, 96], a 64-key queue; inputs are numpy from a seed.
tests/test_torch_port_objectives_slicer_unfused.py holds SLICER and
UnFuSeD the same way, with the helpers of this file."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from audiossl_tpu.objectives import slicer as jslicer
from audiossl_tpu.objectives import unfused as junfused
from audiossl_tpu.objectives.delores_m import DeloresM as JaxDeloresM
from audiossl_tpu.train import optim as joptim
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6
from audiossl_tpu_torch.models.convert import delores_m_from_flax, slicer_from_flax
from audiossl_tpu_torch.objectives import init_objective, objective_class
from audiossl_tpu_torch.objectives import slicer, unfused
from audiossl_tpu_torch.objectives.delores_m import parse_scale
from audiossl_tpu_torch.train import optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D, NEG = 8, 64, 64
TOL_LOSS = 1e-5  # relative
TOL_GRAD = 1e-3  # of each tensor's max|ref|, + TOL_GRAD_FLOOR of the largest gradient
TOL_GRAD_FLOOR = 1e-5
TOL_STATS = 1e-5  # BatchNorm running statistics, absolute and relative
TOL_EMA = 1e-6  # key encoder parameters after the EMA, absolute
TOL_KEYS = 1e-5  # the enqueued keys (unit vectors), absolute; the rest of the queue is equal
TRAJ_SPREAD = 4.0  # DeLoRes-M's 8-step trajectory: times the comparison's own sum-order spread
TRAJ_QUANTILE = 0.95  # ... on the median and on this quantile over tensors


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread, as the other port files run: with the
    suite's workers sharing the cores, a thread a core makes each small op
    wait for threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def config(name, d=D, **pretrain):
    """configs/<name>.yaml at test size: f32, dropout 0, d, a NEG-key queue."""
    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["pretrain"]["base_encoder"].update(output_dim=d, compute_dtype="float32", dropout=0.0)
    cfg["pretrain"].update(num_negatives=NEG, **pretrain)
    return cfg


def jax_state(jobj, seed, n_mels=64):
    """(params, batch_stats, ssl_state) of a JAX objective with its biases,
    BatchNorm affines and key encoder perturbed (each by its own noise), as
    numpy; and four batches of view pairs [B, n_mels, 96] with labels."""
    dummy = jnp.zeros((B, n_mels, 96, 1), jnp.float32)
    params, batch_stats, ssl = jobj.init(jax.random.key(seed), (dummy, dummy))
    rng = np.random.default_rng(seed + 1)

    def perturb(path, v):
        v = np.asarray(v)
        if "'kernel'" in jax.tree_util.keystr(path) or v.dtype != np.float32 or v.ndim == 2:
            return v  # kernels, the pointer and the queue as initialised
        return (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    batch_stats = jax.tree_util.tree_map(np.asarray, batch_stats)
    ssl = jax.tree_util.tree_map_with_path(perturb, ssl)
    views = [tuple((1.5 * rng.standard_normal((B, n_mels, 96))).astype(np.float32) for _ in range(2))
             + (rng.integers(0, 5, B),) for _ in range(4)]
    return params, batch_stats, ssl, views


def jax_views(views):
    """The port's view triple as the JAX loss takes it: [B, F, T, 1] views, int32 labels."""
    v1, v2, labels = views
    return jnp.asarray(v1)[..., None], jnp.asarray(v2)[..., None], jnp.asarray(labels, jnp.int32)


def port_views(views):
    v1, v2, labels = views
    return torch.from_numpy(v1)[:, None], torch.from_numpy(v2)[:, None], torch.from_numpy(labels)


def port_objective(name, cfg, sd):
    obj = init_objective(name, cfg, seed=0)
    obj.load_state_dict(sd, strict=True)
    return obj.train()


def check_step(obj, loss, loss_j, grads_j, aux, params, convert, queue_before=None, n_keys=0) -> bool:
    """One step of the port (its loss backpropagated) against JAX's: the
    loss, every running statistic, the key encoder and the queue and
    pointer (MoCo objectives, which enqueued ``n_keys`` keys) are asserted;
    returns whether every gradient is within its bound."""
    assert rel(loss.item(), float(loss_j)) < TOL_LOSS
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    after = convert(params, np_(aux.batch_stats), np_(aux.ssl_state))
    grads = convert(np_(grads_j), np_(aux.batch_stats), np_(aux.ssl_state))
    named = {n: p for n, p in obj.named_parameters() if p.requires_grad}
    assert named and all(p.grad is not None for p in named.values())
    state = obj.state_dict()
    for k, v in after.items():
        if "running" in k:
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=TOL_STATS, rtol=TOL_STATS, err_msg=k)
        elif k.startswith("encoder_k."):
            assert np.abs(state[k].numpy() - v.numpy()).max() <= TOL_EMA, k
    if "queue" in after:
        assert int(state["queue_ptr"]) == int(after["queue_ptr"])
        got, want = state["queue"].numpy(), after["queue"].numpy()
        moved = np.any(queue_before != want, axis=0)
        assert moved.sum() == n_keys
        np.testing.assert_array_equal(got[:, ~moved], want[:, ~moved])
        assert np.abs(got[:, moved] - want[:, moved]).max() <= TOL_KEYS
    # f32 both sides, through BatchNorms on the statistics of 8 clips, which
    # amplify summation-order differences, plus 1e-5 of the largest gradient
    # for the round-off of gradients that are exactly 0 (a conv bias before
    # batch-statistics BN); tests/test_torch_port_train.py's bound
    scale = max(float(np.abs(grads[n].numpy()).max()) for n in named)
    return all(np.abs(p.grad.numpy() - grads[n].numpy()).max()
               <= TOL_GRAD * float(np.abs(grads[n].numpy()).max()) + TOL_GRAD_FLOOR * scale
               for n, p in named.items())


def hold_steps(name, cfg, jobj, convert, params, batch_stats, ssl, views, n_keys=0):
    """One step from the same state on each batch of ``views``, JAX against
    the port (``check_step``). A ReLU, max-pool or temporal-max routing that
    flips at round-off moves AudioNTT's f32 gradients by up to 1e-2 in some
    batches (chip_smoke.py's step gate, ROADMAP.md Queue 3), so, as there,
    at least half the batches must pass every gradient bound at once (a
    fault shows in all of them, or in most) and every batch every other
    bound. Returns the port objective of the last batch."""
    vg = jax.jit(jax.value_and_grad(
        lambda p, v: jobj.loss(p, batch_stats, ssl, v, jax.random.key(1), True, None), has_aux=True))
    passing = 0
    for batch in views:
        (loss_j, aux), grads_j = vg(params, jax_views(batch))
        obj = port_objective(name, cfg, convert(params, batch_stats, ssl))
        v1, v2, labels = port_views(batch)
        loss = obj.loss(v1, v2, labels=labels)
        loss.backward()
        queue = np.asarray(ssl.queue) if n_keys else None
        passing += check_step(obj, loss, loss_j, grads_j, aux, params, convert, queue, n_keys)
    assert passing >= len(views) / 2, f"{passing} of {len(views)} batches pass every gradient bound"
    return obj


# ---------------------------------------------------------------- DeLoRes-M


@pytest.fixture(scope="module")
def jax_delores_m():
    cfg = config("delores_m", contrastive_dim=16)
    jobj = JaxDeloresM(cfg, axis_name=None)
    return (cfg, jobj, *jax_state(jobj, 0))


def test_converter_round_trips_strictly_and_exactly(jax_delores_m):
    cfg, _, params, batch_stats, ssl, _ = jax_delores_m
    sd = delores_m_from_flax(params, batch_stats, ssl)
    obj = port_objective("delores_m", cfg, sd)
    got = obj.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    np.testing.assert_array_equal(got["encoder.fc.weight"].numpy(), np.asarray(params["encoder"]["fc"]["kernel"]).T)
    np.testing.assert_array_equal(got["encoder_k.fc.bias"].numpy(), np.asarray(ssl.params_k["fc"]["bias"]))
    np.testing.assert_array_equal(got["queue"].numpy(), np.asarray(ssl.queue))
    assert not torch.equal(got["encoder.fc.bias"], got["encoder_k.fc.bias"])  # perturbed apart
    AudioNTT2020Task6(n_mels=64, d=D).load_state_dict(obj.export_state_dict(), strict=True)


def test_delores_m_step_matches_jax(jax_delores_m):
    cfg, jobj, params, batch_stats, ssl, views = jax_delores_m
    obj = hold_steps("delores_m", cfg, jobj, delores_m_from_flax, params, batch_stats, ssl, views, B)
    assert int(obj.queue_ptr) == B
    # the key encoder took no gradient and is not the optimizer's
    assert all(not p.requires_grad and p.grad is None for p in obj.encoder_k.parameters())


def sum_order_distance(run, ref, init):
    """How far a trajectory ``run`` = (losses, state after 3 steps, after 8)
    lies from ``ref``: for the weights, at 3 and at 8 steps, the median and
    the TRAJ_QUANTILE quantile over the floating tensors that moved (the
    queue among them) of max|run - ref| / max|ref - init|, each tensor
    against its own displacement, and the queue's own ratio; for the
    losses, the largest relative difference over the first 3 steps and over
    all 8. -> (array [2 snapshots, 3 measures], array [2]). A round-off
    routing flip (a ReLU or max-pool that turns) moves the few tensors behind
    it by up to their whole displacement, so the largest ratio is noise; the
    median sees a fault that moves most tensors (the SGD momentum), the
    quantile one that moves more than a twentieth of them (the key tower's
    EMA, weight decay on the BatchNorm affines)."""
    def weights(a, b):
        r = {k: float((a[k] - b[k]).abs().max()) / float((b[k] - init[k]).abs().max()) for k in b
             if b[k].is_floating_point() and (b[k] - init[k]).abs().max() > 0}
        v = np.array(list(r.values()))
        return [np.median(v), np.quantile(v, TRAJ_QUANTILE), r["queue"]]

    rel_loss = np.abs(np.asarray(run[0]) - ref[0]) / np.abs(ref[0])
    return np.array([weights(run[1], ref[1]), weights(run[2], ref[2])]), np.array([rel_loss[:3].max(), rel_loss.max()])


def test_eight_step_sgd_trajectory_matches_optax(jax_delores_m):
    """8 SGD steps (lr 0.03, momentum 0.9, wd 1e-4) from the same weights
    and MoCo state on the same views; the weights, the queue and the pointer
    held after 3 and after 8 steps, the losses of all 8 steps. This
    objective at B = 8 amplifies round-off (its 2048-wide Barlow heads
    standardise over 8 clips, and a ReLU or max-pool routing that flips at
    round-off moves the gradients behind it), so the bound is the
    comparison's own noise, measured here: how far JAX moves when only the
    order of its batch sums changes (the batch's rows permuted, six
    permutations; the keys they enqueue put back in the batch's order), on
    each measure of ``sum_order_distance``; the port must land within
    TRAJ_SPREAD times the largest, at whatever thread count it runs (the
    sums' order with it): at 1, 2, 4 and 8 threads within 1.4 times it.
    Momentum 0.8 for 0.9 lands 94 times it on the median after 3 steps, the
    key tower's EMA at 0.998 for 0.999 146 times, no weight decay on the
    BatchNorm affines 7 times on the quantile."""
    cfg, jobj, params, batch_stats, ssl, views = jax_delores_m
    tx = joptim.sgd_torch(0.03)

    @jax.jit
    def step(p, bs, s, opt_state, v1, v2):
        def loss_fn(q):
            return jobj.loss(q, bs, s, (v1, v2), jax.random.key(1), True, None)

        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), aux.batch_stats, aux.ssl_state, opt_state, loss

    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)

    def jax_run(perm=None):
        """-> (losses, the state after 3 steps, after 8), as the port's
        state_dicts, the keys of permuted batches put back in batch order."""
        p, bs, s, opt_state, losses, snaps = params, batch_stats, ssl, tx.init(params), [], []
        for i in range(8):
            v = views[i % len(views)]
            v1, v2, _ = jax_views(v if perm is None else tuple(x[perm] for x in v))
            p, bs, s, opt_state, loss = step(p, bs, s, opt_state, v1, v2)
            losses.append(float(loss))
            if i + 1 in (3, 8):
                snap = delores_m_from_flax(np_(p), np_(bs), np_(s))
                if perm is not None:  # step j enqueued its keys at columns jB .. (j + 1)B, row i at jB + i
                    order = np.concatenate([j * B + np.argsort(perm) for j in range(i + 1)])
                    snap["queue"][:, :(i + 1) * B] = snap["queue"][:, order]
                snaps.append(snap)
        return losses, *snaps

    obj = port_objective("delores_m", cfg, delores_m_from_flax(params, batch_stats, ssl))
    opt, _ = optim.build_optimizer("sgd", [p for p in obj.parameters() if p.requires_grad], 0.03)
    losses, snaps = [], []
    for i in range(8):
        v1, v2, _ = port_views(views[i % len(views)])
        loss = obj.loss(v1, v2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i + 1 in (3, 8):
            snaps.append({k: v.clone() for k, v in obj.state_dict().items()})

    init = delores_m_from_flax(params, batch_stats, ssl)
    ref = jax_run()
    spreads = [sum_order_distance(jax_run(np.random.default_rng(seed).permutation(B)), ref, init)
               for seed in range(1, 7)]
    spread_w = np.max([w for w, _ in spreads], axis=0)
    spread_loss = np.maximum(np.max([loss for _, loss in spreads], axis=0), TOL_LOSS)
    worst_w, worst_loss = sum_order_distance((losses, *snaps), ref, init)
    assert 1e-6 < spread_w[0, 0] < 1e-3 and 1e-5 < spread_w[1, 0] < 1e-1, spread_w  # the amplification this test rests on
    assert (worst_w <= TRAJ_SPREAD * spread_w).all(), (worst_w, spread_w)
    assert (worst_loss <= TRAJ_SPREAD * spread_loss).all(), (worst_loss, spread_loss)
    for snap, want in zip(snaps, ref[1:]):
        assert int(snap["queue_ptr"]) == int(want["queue_ptr"])
    assert int(obj.queue_ptr) == 0  # 8 x 8 keys around a 64-key queue
    assert np.allclose(np.linalg.norm(snaps[1]["queue"].numpy(), axis=0), 1.0, atol=1e-5)  # unit keys in every column


# ---------------------------------------------------------------- losses and guards


def test_slicer_and_unfused_losses_match_jax():
    rng = np.random.default_rng(3)
    z1, z2 = (rng.standard_normal((6, 10)).astype(np.float32) for _ in range(2))
    c1, c2 = (np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal((6, 5)).astype(np.float32)), axis=1))
              for _ in range(2))
    t = lambda a: torch.from_numpy(np.array(a))
    for temp in (0.5, 1.0):
        assert rel(float(slicer.instance_loss(t(z1), t(z2), temp)), jslicer.instance_loss(z1, z2, temp)) < TOL_LOSS
        assert rel(float(slicer.cluster_loss(t(c1), t(c2), temp)), jslicer.cluster_loss(c1, c2, temp)) < TOL_LOSS
    # gradients of the cluster loss, through the masked logits and the column norms
    a, b = t(c1).requires_grad_(), t(c2).requires_grad_()
    slicer.cluster_loss(a, b).backward()
    ga, gb = jax.grad(jslicer.cluster_loss, argnums=(0, 1))(jnp.asarray(c1), jnp.asarray(c2))
    assert rel(a.grad.numpy(), ga) < TOL_LOSS and rel(b.grad.numpy(), gb) < TOL_LOSS
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    probs = c1.copy()
    probs[0, 1] = 0.0  # an exact zero takes the t > 0 branch's 0
    log_pred = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=1))
    assert rel(float(unfused.kl_batchmean(t(log_pred), t(probs))), junfused.kl_batchmean(log_pred, probs)) < TOL_LOSS
    assert rel(float(unfused.cosine_mse(t(z1), t(z2))), junfused.cosine_mse(z1, z2)) < TOL_LOSS
    tiny = np.zeros_like(z1)
    tiny[0] = 1e-9  # a collapsed row: eps 1e-6 keeps it finite on both sides
    assert rel(float(unfused.cosine_mse(t(tiny), t(z2))), junfused.cosine_mse(tiny, z2)) < TOL_LOSS


@pytest.mark.parametrize("name", ["delores_m", "slicer", "unfused"])
def test_objectives_refuse_other_mel_counts_and_register(name):
    """DeLoRes-M and UnFuSeD, whose tap heads JAX sizes for 64 mels, refuse
    128; SLICER, which JAX sizes from n_mels, takes one step at 128 mels
    that holds against JAX's (two batches, ``hold_steps``'s bounds)."""
    if name == "slicer":
        cfg = config(name, instance_contrastive_dim=16, cluster_contrastive_dim=12)
        cfg["pretrain"]["input"]["n_mels"] = 128
        jobj = jslicer.Slicer(cfg, axis_name=None)
        params, batch_stats, ssl, views = jax_state(jobj, 5, n_mels=128)
        obj = hold_steps(name, cfg, jobj, slicer_from_flax, params, batch_stats, ssl, views[:2], 2 * B)
        assert obj.encoder.encoder.fc[0].in_features == 64 * 128 // 8
    else:
        cfg = config(name)
        cfg["pretrain"]["input"]["n_mels"] = 128
        with pytest.raises(ValueError, match="n_mels = 64"):
            init_objective(name, cfg, seed=0)
    assert objective_class(name).labeled == (name == "unfused")
    assert not objective_class("delores_s").labeled
    with pytest.raises(NotImplementedError, match="not ported"):
        objective_class("no_such_objective")


def test_loss_scale_parses_fractions():
    assert parse_scale("1/32") == 1 / 32 and parse_scale(0.5) == 0.5 and parse_scale(" 3/4 ") == 0.75
    with pytest.raises(ValueError, match="loss_scale"):
        parse_scale("1/0")
