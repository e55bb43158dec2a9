"""Gradient accumulation in the port (train/accum.py, and SS-MAST's
``grad_accum_steps``) against A = 1 and against the JAX package on the CPU,
f32, on numpy inputs from a seed:

* the helper: the fine-tune's step at A = 2 against A = 1 with the
  augmentations and drop path off, on the port alone (1e-6); the helper
  against JAX's ``microbatched_value_and_grad`` on a small BCE model (1e-6),
  and its two ValueErrors;
* SS-MAST at ``grad_accum_steps: 2`` in both view modes against JAX's
  ``SSMast.value_and_grad`` at A = 2 from the same weights and MoCo state:
  the loss, every gradient, the queue, its pointer, the step and the EMA key
  tower (tests/test_ssmast_accum.py holds JAX's A = 2 to its A = 1). MAST
  tiny cut to 4 blocks on both sides, 64 mels x 96 frames, B = 4, a 64-key
  queue, drop path 0."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiossl_tpu.models import mast as jmast
from audiossl_tpu.models import mvit as jmvit
from audiossl_tpu.objectives.ssmast import SSMast as JaxSSMast
from audiossl_tpu.train.accum import microbatched_value_and_grad as jax_microbatched
from audiossl_tpu_torch.models import mast as pmast
from audiossl_tpu_torch.models.convert import mast_with_head_from_flax
from audiossl_tpu_torch.models.mvit import MViTConfig
from audiossl_tpu_torch.objectives import init_objective
from audiossl_tpu_torch.train import accum
from tests.test_torch_port_ssmast import _config

B, F_, T_ = 4, 64, 96
TOL = 1e-6
TOL_LOSS = 1e-5  # SS-MAST: relative, as tests/test_torch_port_ssmast.py
TOL_GRAD = 1e-3  # SS-MAST: of each tensor's max|ref|, + 1e-5 of the largest, as there


@pytest.fixture(scope="module", autouse=True)
def one_thread_short_tiny():
    """One torch intra-op thread; MAST tiny with 4 blocks on both sides."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmast.VARIANTS, "tiny", lambda **kw: jmvit.MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
        mp.setitem(pmast.VARIANTS, "tiny", lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw))
        yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the helper


def test_finetune_step_accumulating_two_equals_one():
    """The fine-tune's step (train/finetune_mast.py) at A = 2 and A = 1 from
    the same weights, augmentations and drop path off: the same loss and
    gradients up to summation order."""
    from audiossl_tpu_torch.train import finetune_mast as ft
    from tests.test_torch_port_finetune import FT, _targets, _waves

    cfg = copy.deepcopy(FT)
    cfg.update(freqm=0, timem=0, droppath_rate=0.0)
    cfg["input"].update(mixup=0.0, noise=False)
    waves, targets = torch.from_numpy(_waves(31)), torch.from_numpy(_targets(31))
    init = ft.init_classifier(cfg, targets.shape[1], seed=0, device=torch.device("cpu")).train()
    out = []
    for a in (1, 2):
        model = copy.deepcopy(init)
        step = ft.FinetuneStep(model, torch.optim.SGD(model.parameters(), lr=0.0), cfg, torch.Generator(), a)
        loss = step.loss_and_grads(waves, targets)
        out.append((float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l1, g1), (l2, g2) = out
    assert abs(l1 - l2) <= TOL * abs(l1)
    for n, g in g1.items():
        assert float((g2[n] - g).abs().max()) <= TOL * max(1.0, float(g.abs().max())), n


def _bce_model(seed):
    r = np.random.default_rng(seed)
    w = r.standard_normal((6, 3)).astype(np.float32)
    b = r.standard_normal(3).astype(np.float32)
    x = r.standard_normal((8, 6)).astype(np.float32)
    t = (r.uniform(size=(8, 3)) < 0.5).astype(np.float32)
    return w, b, x, t


def _bce(z, t, lib):
    return lib.mean(lib.maximum(z, 0 * z) - z * t + lib.log1p(lib.exp(-lib.abs(z))))


@pytest.mark.parametrize("a", [1, 2, 4])
def test_helper_matches_jax(a):
    """A mean BCE of tanh(x W + b): loss and gradients of W and b against
    JAX's microbatched_value_and_grad (f32 accumulation, each g / A)."""
    w, b, x, t = _bce_model(a)

    def jloss(p, batch, key):
        xb, tb = batch
        return _bce(jnp.tanh(xb @ p["w"] + p["b"]), tb, jnp)

    loss_j, g_j = jax_microbatched(jloss, a)({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                             (jnp.asarray(x), jnp.asarray(t)), jax.random.key(0))
    params = [torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()]
    seen = []

    def loss_fn(batch, j):
        seen.append(j)
        xb, tb = batch
        return _bce(torch.tanh(xb @ params[0] + params[1]), tb, torch)

    loss, grads = accum.microbatched_value_and_grad(loss_fn, a)(params, (torch.from_numpy(x), torch.from_numpy(t)))
    assert seen == list(range(a)) and not loss.requires_grad
    assert abs(float(loss) - float(loss_j)) <= TOL * abs(float(loss_j))
    for got, want in zip(grads, (g_j["w"], g_j["b"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL * float(np.abs(want).max()))


def test_helper_raises_jax_value_errors():
    with pytest.raises(ValueError, match="grad_accum_steps must be >= 1"):
        accum.microbatched_value_and_grad(lambda b, j: b.sum(), 0)
    p = torch.ones(3, requires_grad=True)
    fn = accum.microbatched_value_and_grad(lambda b, j: (b * p).sum(), 2)
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps 2"):
        fn([p], torch.ones(5, 3))
    # a dict batch splits leaf by leaf; a parameter the loss misses gets zeros
    q = torch.ones(2, requires_grad=True)
    loss, (gp, gq) = accum.microbatched_value_and_grad(lambda b, j: (b["x"] * p).sum(), 2)([p, q], {"x": torch.ones(4, 3)})
    assert float(loss) == 6.0 and torch.equal(gp, torch.full((3,), 2.0)) and torch.equal(gq, torch.zeros(2))


# ---------------------------------------------------------------- SS-MAST


def _ssmast_config(batched):
    cfg = _config(batched)
    cfg["pretrain"]["grad_accum_steps"] = 2
    return cfg


def _views(seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, 1, F_, T_)).astype(np.float32) for _ in range(2)]


@functools.lru_cache(maxsize=2)
def _jax_side(batched: bool):
    jcfg = _ssmast_config(batched)
    jcfg["pretrain"]["fused_attention"] = "off"
    jobj = JaxSSMast(jcfg, axis_name=None)
    nhwc = lambda v: jnp.asarray(v.transpose(0, 2, 3, 1))  # noqa: E731
    views = tuple(nhwc(v) for v in _views(0))
    params, bs, ssl = jax.jit(jobj.init)(jax.random.key(0), views)
    v1, v2 = _views(5)
    out = jax.jit(lambda p, s: jobj.value_and_grad(p, bs, s, (nhwc(v1), nhwc(v2)), jax.random.key(1), True, None))(
        params, ssl)
    return params, ssl, out, (v1, v2)


@pytest.mark.parametrize("batched", [True, False])
def test_ssmast_accumulation_matches_jax(batched):
    params, ssl, ((loss_j, aux), g_j), (v1, v2) = _jax_side(batched)
    obj = init_objective("ssmast", _ssmast_config(batched), seed=0).train()
    assert obj.grad_accum == 2
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    obj.encoder.load_state_dict(mast_with_head_from_flax(to_np(params["encoder"])))
    obj.encoder_k.load_state_dict(mast_with_head_from_flax(to_np(ssl.params_k)))
    obj.queue.copy_(torch.from_numpy(np.array(ssl.queue)))
    loss = obj.loss_and_backward(torch.from_numpy(v1), torch.from_numpy(v2))
    assert abs(float(loss) - float(loss_j)) <= TOL_LOSS * abs(float(loss_j))
    ref = mast_with_head_from_flax(to_np(g_j["encoder"]))
    largest = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for n, p in obj.encoder.named_parameters():
        want = ref[n].numpy()
        assert np.abs(p.grad.numpy() - want).max() <= TOL_GRAD * np.abs(want).max() + 1e-5 * largest, n
    assert all(p.grad is None for p in obj.encoder_k.parameters())
    new = aux.ssl_state
    ref_k = mast_with_head_from_flax(to_np(new.params_k))
    for n, p in obj.encoder_k.state_dict().items():
        want = ref_k[n].numpy()
        assert np.abs(p.numpy() - want).max() <= 1e-5 * max(1.0, np.abs(want).max()), n
    assert np.abs(obj.queue.numpy() - np.asarray(new.queue)).max() <= 1e-5
    assert int(obj.queue_ptr) == int(new.queue_ptr) == 2 * B and int(obj.step) == int(new.step) == 1


def test_ssmast_accumulation_refusals():
    """A batch the accumulation does not divide raises JAX's ValueError; so
    does accumulation with shuffle_bn (objectives/ssmast.py:66-70)."""
    obj = init_objective("ssmast", _ssmast_config(True), seed=0)
    with pytest.raises(ValueError, match="not divisible by pretrain.grad_accum_steps 2"):
        obj.loss_and_backward(torch.zeros(3, 1, F_, T_), torch.zeros(3, 1, F_, T_))
    bad = _ssmast_config(False)
    bad["pretrain"]["shuffle_bn"] = True
    with pytest.raises(ValueError, match="incompatible with shuffle_bn"):
        init_objective("ssmast", bad, seed=0)
    with pytest.raises(ValueError, match="incompatible with shuffle_bn"):
        JaxSSMast(bad, axis_name=None)
