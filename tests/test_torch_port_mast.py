"""The port's MViTv2 and MAST (audiossl_tpu_torch.models.{mvit,mast}) against
the JAX modules on the CPU, f32, drop path 0: outputs and parameter
gradients against the JAX XLA path ("off") and fused-attention path ("on",
the Pallas kernel in interpret mode). The port takes the same key but always
runs the autograd Function over the kernels (their plain versions on the
CPU). The bounds are the JAX fused-MViT test's
(tests/test_mvit_fused.py:31,47). Also the weight converters against
``mast_to_torch``; the MAST-B attention geometry. Inputs are numpy from a
seed; weights are the JAX module's init, carried over by ``mast_from_flax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiossl_tpu.models.mast import MASTEncoder as JaxMAST
from audiossl_tpu.models.mvit import MViT as JaxMViT
from audiossl_tpu.models.mvit import MViTConfig as JaxMViTConfig
from audiossl_tpu.models.torch_export import mast_to_torch
from audiossl_tpu_torch.models import convert
from audiossl_tpu_torch.models.mast import MASTEncoder
from audiossl_tpu_torch.models.mvit import MViT, MViTConfig

TOL_OUT = 1e-4  # relative to max(1, max|ref|)
TOL_GRAD = 1e-4  # relative to the largest gradient


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread for these tiny models: with the suite's
    workers sharing the cores, torch's default of a thread a core makes each
    small op wait for threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cotangent(shape):
    return np.random.default_rng(9).standard_normal(shape).astype(np.float32)


def _jax_run(jm, x, seed):
    """(output, parameter gradients of sum(out * cotangent), variables); jitted:
    the JAX modules take tens of seconds op by op on the CPU."""
    xj = jnp.asarray(x)
    variables = jax.jit(lambda k: jm.init(k, xj, False))(jax.random.key(seed))
    out = jax.jit(lambda v: jm.apply(v, xj, False))(variables)
    cot = jnp.asarray(_cotangent(out.shape))
    grads = jax.jit(jax.grad(lambda v: jnp.sum(jm.apply(v, xj, False) * cot)))(variables)
    return np.asarray(out), grads, variables


def _port_grads(model, jax_grads, wrap):
    """(port gradients, JAX gradients) as flat vectors in the port's parameter order."""
    ref = convert.mvit_reference_layout(convert.mast_from_flax(wrap(jax.tree.map(np.asarray, jax_grads))))
    names = [n for n, _ in model.named_parameters() if n in ref]
    got = torch.cat([dict(model.named_parameters())[n].grad.flatten() for n in names]).numpy()
    want = torch.cat([ref[n].flatten() for n in names]).numpy()
    return got, want, names


def _check(out_p, out_j, got, want):
    assert out_p.shape == out_j.shape
    assert np.abs(out_p - out_j).max() <= TOL_OUT * max(1.0, np.abs(out_j).max())
    assert np.abs(got - want).max() <= TOL_GRAD * np.abs(want).max()


@pytest.mark.parametrize("fused", ["off", "on"])
def test_mvit_tiny_matches_jax(fused):
    kw = dict(droppath_rate=0.0, compute_dtype=None, fused_attention=fused)
    jm = JaxMViT(JaxMViTConfig.tiny(**kw), input_hw=(32, 64), in_chans=1, final_norm=True)
    x = np.random.default_rng(0).standard_normal((2, 32, 64, 1)).astype(np.float32)
    out_j, g_j, variables = _jax_run(jm, x, seed=0)

    pm = MViT(MViTConfig.tiny(**kw), input_hw=(32, 64), in_chans=1, final_norm=True).eval()
    sd = convert.mvit_reference_layout(convert.mast_from_flax({"params": {"mvit": jax.tree.map(np.asarray, variables["params"])}}))
    sd["norm.weight"] = torch.from_numpy(np.array(variables["params"]["norm"]["scale"]))
    sd["norm.bias"] = torch.from_numpy(np.array(variables["params"]["norm"]["bias"]))
    pm.load_state_dict(sd, strict=True)
    out = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    out.backward(torch.from_numpy(_cotangent(out_j.shape)))
    got, want, names = _port_grads(pm, g_j["params"], lambda g: {"params": {"mvit": g}})
    assert len(names) == len(list(pm.parameters())) - 2  # all but the final norm's
    got = np.concatenate([got, pm.norm.weight.grad.numpy(), pm.norm.bias.grad.numpy()])
    want = np.concatenate([want, np.asarray(g_j["params"]["norm"]["scale"]), np.asarray(g_j["params"]["norm"]["bias"])])
    _check(out.detach().numpy(), out_j, got, want)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_mast_tiny_matches_jax(fused):
    kw = dict(input_fdim=64, input_tdim=96, model_size="tiny", compute_dtype=None, droppath_rate=0.0, fused_attention=fused)
    jm = JaxMAST(**kw)
    x = np.random.default_rng(1).standard_normal((2, 64, 96, 1)).astype(np.float32)
    out_j, g_j, variables = _jax_run(jm, x, seed=1)

    pm = MASTEncoder(**kw).eval()
    pm.load_state_dict(convert.mvit_reference_layout(convert.mast_from_flax(jax.tree.map(np.asarray, variables))))
    out = pm(torch.from_numpy(x).permute(0, 3, 1, 2))  # [B, 1, F, T]
    assert out.shape == (2, 768)
    out.backward(torch.from_numpy(_cotangent(out_j.shape)))
    got, want, names = _port_grads(pm, g_j["params"], lambda g: {"params": g})
    assert len(names) == len(list(pm.parameters()))
    _check(out.detach().numpy(), out_j, got, want)


def test_mast_from_flax_is_mast_to_torch_and_layout_round_trips():
    jm = JaxMAST(input_fdim=64, input_tdim=96, model_size="tiny", compute_dtype=None)
    variables = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 64, 96, 1)), False))(jax.random.key(2))
    variables = jax.tree.map(np.asarray, variables)
    want = mast_to_torch(variables)
    got = convert.mast_from_flax(variables)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    there_and_back = convert.mvit_reference_layout(convert.mvit_reference_layout(got))
    assert all(torch.equal(there_and_back[k], got[k]) for k in got)
    # a port model's state_dict in the reference layout has the reference's keys and shapes
    pm = MASTEncoder(64, 96, "tiny", compute_dtype=None)
    ref = convert.mvit_reference_layout(pm.state_dict())
    assert {k: tuple(v.shape) for k, v in ref.items()} == {k: v.shape for k, v in want.items()}


def test_mast_base_attention_geometry():
    """MAST-B at 128 bins x 1024 frames: a 101x12 token grid, heads 1->8,
    dims 96->768; the attention shapes (Lq, Lk) the kernels take, block by block."""
    with torch.device("meta"):
        m = MASTEncoder(128, 1024, "base")
    assert m.grid_hw == (101, 12) and len(m.blocks) == 24 and m.embed_dim == 768
    shapes = [(a.num_heads, a.head_dim, a.q_hw[0] * a.q_hw[1], a.k_hw[0] * a.k_hw[1]) for a in (b.attn for b in m.blocks)]
    want = [(1, 1212, 78)] * 2 + [(2, 306, 306)] + [(2, 306, 78)] * 2 + [(4, 78, 306)] + [(4, 78, 78)] * 15
    want += [(8, 26, 78)] + [(8, 26, 26)] * 2
    assert shapes == [(h, 96, lq, lk) for h, lq, lk in want]
    assert max(lq * lk for _, _, lq, lk in shapes) < 1 << 18  # the JAX package's TPU "auto" gate would not engage


def test_remat_and_drop_path_draws():
    """remat (per-block activation checkpointing) gives the same output and
    gradients as the plain forward, drop path included: its masks are drawn
    from the generator before each block runs, so a recomputed block sees
    the same ones; training with drop path needs a generator."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 1, 64, 96)).astype(np.float32))
    outs = []
    for remat in (False, True):
        torch.manual_seed(0)
        m = MASTEncoder(64, 96, "tiny", remat=remat, compute_dtype=None, droppath_rate=0.3, fused_attention="on").train()
        out = m(x, torch.Generator().manual_seed(5))
        out.square().sum().backward()
        outs.append((out.detach(), [p.grad for p in m.parameters()]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="generator"):
        m(x)
    m.eval()
    assert torch.isfinite(m(x)).all()  # no drop path, no generator needed
