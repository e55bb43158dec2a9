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
TOL_TRAJ = 1e-4  # relative
TRAJ_SPREAD = 4.0  # DeLoRes-M after 8 steps: times JAX's own distance from a 1e-7 nudge


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


@pytest.fixture
def fixed_sum_order():
    """The summation order this trajectory is held in: 8 intra-op threads
    and MKL's thread count fixed (``MKL_Set_Dynamic(0)``; by default MKL
    may take fewer threads under load, which splits a GEMM's sums another
    way). The objective amplifies round-off, so a run with another order
    (one thread, or MKL shedding threads while the suite's workers share the
    cores) lands ~2e-3 from JAX after 3 steps; this order lands under 1e-4.
    Both settings are restored after the test; a torch built without MKL
    linked in has no ``MKL_Set_Dynamic``, and then only the threads are set."""
    import ctypes

    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so"))
    set_dynamic = getattr(lib, "MKL_Set_Dynamic", None)
    threads = torch.get_num_threads()
    dynamic = int(os.environ.get("MKL_DYNAMIC", "TRUE").upper() not in ("FALSE", "0"))  # MKL's default: on
    if set_dynamic is not None:
        set_dynamic(0)
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(threads)
    if set_dynamic is not None:
        set_dynamic(dynamic)


def test_eight_step_sgd_trajectory_matches_optax(jax_delores_m, fixed_sum_order):
    """8 SGD steps (lr 0.03, momentum 0.9, wd 1e-4) from the same weights
    and MoCo state on the same views. The losses hold within 1e-4 at every
    step and the weights within 1e-4 after 3 steps. After 8 the weights are
    held to JAX's own spread: this objective at B = 8 amplifies round-off
    (its 2048-wide Barlow heads standardise over 8 clips), so JAX from
    weights nudged by 1e-7 (relative) lands ~3e-3 from JAX after 8 steps;
    the port must land within TRAJ_SPREAD times that distance."""
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

    def jax_run(p):
        """-> (losses, the state after 3 steps, after 8), as the port's state_dicts."""
        bs, s, opt_state, losses, snaps = batch_stats, ssl, tx.init(p), [], []
        for i in range(8):
            v1, v2, _ = jax_views(views[i % len(views)])
            p, bs, s, opt_state, loss = step(p, bs, s, opt_state, v1, v2)
            losses.append(float(loss))
            if i + 1 in (3, 8):
                snaps.append(delores_m_from_flax(np_(p), np_(bs), np_(s)))
        return losses, *snaps

    ref, ref3, ref8 = jax_run(params)
    nudge = np.random.default_rng(9)
    nudged = jax.tree_util.tree_map(
        lambda v: (v * (1.0 + 1e-7 * nudge.standard_normal(v.shape))).astype(np.float32), params)
    spread = max(rel(v.numpy(), ref8[k].numpy()) for k, v in jax_run(nudged)[2].items() if v.is_floating_point())

    obj = port_objective("delores_m", cfg, delores_m_from_flax(params, batch_stats, ssl))
    opt, _ = optim.build_optimizer("sgd", [p for p in obj.parameters() if p.requires_grad], 0.03)
    ours = []
    for i in range(8):
        v1, v2, _ = port_views(views[i % len(views)])
        loss = obj.loss(v1, v2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        ours.append(loss.item())
        if i + 1 == 3:
            for name, q in obj.state_dict().items():
                if q.is_floating_point():
                    assert rel(q.numpy(), ref3[name].numpy()) < TOL_TRAJ, name
    assert (np.abs(np.asarray(ours) - ref) / np.abs(ref)).max() < TOL_TRAJ, (ours, ref)
    worst = max(rel(q.numpy(), ref8[k].numpy()) for k, q in obj.state_dict().items() if q.is_floating_point())
    assert 1e-5 < spread < 1e-2, spread  # the amplification this test rests on
    assert worst <= TRAJ_SPREAD * spread, (worst, spread)
    assert int(obj.queue_ptr) == int(ref8["queue_ptr"]) == 0  # 8 x 8 keys around a 64-key queue


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
