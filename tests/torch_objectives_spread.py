"""JAX's own spread of the DeLoRes-M SGD trajectory that
``test_torch_port_objectives.py::test_eight_step_sgd_trajectory_matches_optax``
holds after 3 steps, beside the port's distance from JAX at 1, 2, 4 and 8
torch threads: how far round-off-sized changes (weights nudged by 1e-7, the
batch's rows permuted, XLA's CPU thread pool off) move JAX's own weights.

    JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false" \\
        python tests/torch_objectives_spread.py dump /tmp/one_thread.pkl
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_objectives_spread.py compare /tmp/one_thread.pkl

Each line is the largest relative distance of a floating state tensor from
JAX's run (the queue is left out where the rows are permuted: its columns
then come in another order).
"""
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import test_torch_port_objectives as T  # noqa: E402
from audiossl_tpu.train import optim as joptim  # noqa: E402
from audiossl_tpu_torch.train import optim  # noqa: E402

STEPS = 3


def main(mode: str, other: str | None = None) -> None:
    cfg = T.config("delores_m", contrastive_dim=16)
    jobj = T.JaxDeloresM(cfg, axis_name=None)
    params, batch_stats, ssl, views = T.jax_state(jobj, 0)
    tx = joptim.sgd_torch(0.03)

    @jax.jit
    def step(p, bs, s, opt_state, v1, v2):
        def loss_fn(q):
            return jobj.loss(q, bs, s, (v1, v2), jax.random.key(1), True, None)

        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), aux.batch_stats, aux.ssl_state, opt_state, loss

    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def jax_run(p, perm=None):
        bs, s, opt_state = batch_stats, ssl, tx.init(p)
        for i in range(STEPS):
            v = views[i % len(views)]
            v1, v2, _ = T.jax_views(v if perm is None else tuple(x[perm] for x in v))
            p, bs, s, opt_state, _ = step(p, bs, s, opt_state, v1, v2)
        return T.delores_m_from_flax(np_(p), np_(bs), np_(s))

    def distance(a, b, skip_queue=False):
        return max(T.rel(v.numpy(), b[k].numpy()) for k, v in a.items()
                   if v.is_floating_point() and not (skip_queue and k.startswith("queue")))

    if mode == "dump":
        with open(other, "wb") as f:
            pickle.dump({k: v.numpy() for k, v in jax_run(params).items()}, f)
        return
    ref = jax_run(params)
    out = {}
    for seed in (9, 10, 11):
        nudge = np.random.default_rng(seed)
        nudged = jax.tree_util.tree_map(
            lambda v: (v * (1.0 + 1e-7 * nudge.standard_normal(v.shape))).astype(np.float32), params)
        out[f"JAX, weights nudged by 1e-7 (seed {seed})"] = distance(jax_run(nudged), ref)
    for seed in (1, 2):
        perm = np.random.default_rng(seed).permutation(T.B)
        out[f"JAX, the batch's rows permuted (seed {seed}), queue left out"] = distance(jax_run(params, perm), ref, True)
    if other:
        with open(other, "rb") as f:
            out["JAX from the dumped run (its own XLA_FLAGS)"] = distance(
                {k: torch.from_numpy(v) for k, v in pickle.load(f).items()}, ref)
    for threads in (1, 2, 4, 8):
        torch.set_num_threads(threads)
        obj = T.port_objective("delores_m", cfg, T.delores_m_from_flax(params, batch_stats, ssl))
        opt, _ = optim.build_optimizer("sgd", [p for p in obj.parameters() if p.requires_grad], 0.03)
        for i in range(STEPS):
            v1, v2, _ = T.port_views(views[i % len(views)])
            loss = obj.loss(v1, v2)
            opt.zero_grad()
            loss.backward()
            opt.step()
        out[f"the port at {threads} torch threads"] = distance(obj.state_dict(), ref)
    for k, v in out.items():
        print(f"{k}: {v:.3e}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None)
