"""The port's AST (audiossl_tpu_torch.models.ast) against the JAX package's
on the CPU: AST-tiny at depth 2, eval and training forward and every
parameter gradient, against the JAX encoder with its fused attention "on"
(the Pallas kernel in interpret mode) and "off" (flax's attention); PatchDrop
on the indices JAX draws; the weight conversions against ``ast_to_torch``.
f32; inputs are numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiossl_tpu.models.ast import ASTConfig as JaxASTConfig
from audiossl_tpu.models.ast import ASTEncoder as JaxASTEncoder
from audiossl_tpu.models.torch_export import ast_to_torch
from audiossl_tpu.ops import tokens as jtokens
from audiossl_tpu_torch.models.ast import ASTConfig, ASTEncoder, patch_grid
from audiossl_tpu_torch.models.convert import ast_from_flax, ast_reference_layout
from audiossl_tpu_torch.ops.tokens import gather_tokens, keep_count, patch_drop

F_DIM, T_DIM, B = 32, 58, 3  # a 5 x 2 patch grid: 12 tokens
TOL_FWD, TOL_GRAD = 1e-5, 1e-4


def _jax_model(fused: str, patch_drop_ratio: float = 0.0):
    cfg = dataclasses.replace(JaxASTConfig.tiny(), depth=2, fused_attention=fused)
    return JaxASTEncoder(input_fdim=F_DIM, input_tdim=T_DIM, cfg=cfg, patch_drop=patch_drop_ratio)


@pytest.fixture(scope="module")
def variables():
    """AST-tiny (depth 2) variables with every bias and LayerNorm affine
    randomised, so that the conversion of each is exercised."""
    v = _jax_model("off").init(jax.random.key(0), jnp.zeros((1, F_DIM, T_DIM, 1)), False)
    leaves, tree = jax.tree.flatten(v)
    rng = np.random.default_rng(5)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    return jax.tree.unflatten(tree, leaves)


def _port(variables, patch_drop_ratio=0.0):
    model = ASTEncoder(F_DIM, T_DIM, ASTConfig.tiny(depth=2), patch_drop=patch_drop_ratio)
    model.load_state_dict(ast_from_flax(jax.tree.map(np.asarray, variables)), strict=True)
    return model


def _input(seed=1):
    return np.random.default_rng(seed).standard_normal((B, F_DIM, T_DIM)).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / max(1.0, float(np.abs(want).max())))


def test_patch_grid_matches_ast_base():
    """AST-base at 128 x 1024 has a 101 x 12 grid: 1214 tokens."""
    t, f = patch_grid(128, 1024, ASTConfig.base())
    assert (t, f) == (101, 12) and t * f + 2 == 1214
    assert patch_grid(128, 1025, ASTConfig.base()) == (101, 12)  # the probe's 10.24 s clips: 1025 frames


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_and_gradients_match_jax(variables, fused, train):
    x = _input()
    cot = np.random.default_rng(2).standard_normal((B, 192)).astype(np.float32)
    jm = _jax_model(fused)
    loss = lambda p, x: jnp.sum(jm.apply({"params": p}, x, train) * cot)
    xj = jnp.asarray(x)[..., None]
    ref = np.asarray(jm.apply(variables, xj, train))
    gj = jax.grad(loss)(variables["params"], xj)

    model = _port(variables).train(train)
    out = model(torch.from_numpy(x)[:, None])
    assert out.shape == ref.shape == (B, 192) and out.dtype == torch.float32
    assert _rel(out.detach().numpy(), ref) <= TOL_FWD
    (out * torch.from_numpy(cot)).sum().backward()
    want = ast_from_flax(jax.tree.map(np.asarray, {"params": gj}))
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for name, g in want.items():
        got = grads[name].grad.numpy()
        err = float(np.abs(got - g.numpy()).max() / max(float(g.abs().max()), 1e-30))
        assert err <= TOL_GRAD, (name, err)


def test_patch_drop_on_jax_indices(variables, monkeypatch):
    """PatchDrop's deterministic core on the indices JAX's threefry draw
    keeps: the op alone, and the encoder's training forward through it."""
    x = np.random.default_rng(3).standard_normal((B, 10, 8)).astype(np.float32)
    key = jax.random.key(4)
    n_keep = keep_count(10, 0.3)
    idx = np.stack([np.asarray(jax.random.permutation(k, 10))[:n_keep] for k in jax.random.split(key, B)])
    ref = np.asarray(jtokens.patch_drop(jnp.asarray(x), key, 0.3))
    np.testing.assert_array_equal(gather_tokens(torch.from_numpy(x), torch.from_numpy(idx)).numpy(), ref)
    drawn = patch_drop(torch.from_numpy(x), 0.3, torch.Generator().manual_seed(0))
    assert drawn.shape == (B, n_keep, 8)

    keys = []
    original = jtokens.patch_drop

    def recording(x, key, ratio):
        keys.append(key)
        return original(x, key, ratio)

    monkeypatch.setattr(jtokens, "patch_drop", recording)
    x = _input(6)
    ref = np.asarray(_jax_model("off", 0.4).apply(variables, jnp.asarray(x)[..., None], True,
                                                  rngs={"patch_drop": jax.random.key(9)}))
    n = 10
    kept = np.stack([np.asarray(jax.random.permutation(k, n))[:keep_count(n, 0.4)] for k in jax.random.split(keys[0], B)])
    model = _port(variables, 0.4).train()
    with torch.no_grad():
        out = model(torch.from_numpy(x)[:, None], keep=torch.from_numpy(kept))
    assert _rel(out.numpy(), ref) <= TOL_FWD


def test_conversions_round_trip_against_ast_to_torch(variables):
    """ast_from_flax then ast_reference_layout gives exactly what
    ast_to_torch writes (the reference's freq-major layout), and the port's
    state_dict loads strictly."""
    t, f = patch_grid(F_DIM, T_DIM, ASTConfig.tiny())
    want = ast_to_torch(jax.tree.map(np.asarray, variables), dst_grid_ft=(f, t))
    port = ast_from_flax(jax.tree.map(np.asarray, variables))
    got = ast_reference_layout(port, (f, t))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert port["patch_embed.proj.weight"].shape == (192, 1, 16, 16)
    ASTEncoder(F_DIM, T_DIM, ASTConfig.tiny(depth=2)).load_state_dict(port, strict=True)
    with pytest.raises(ValueError, match="grid"):
        ast_reference_layout(port, (f, t + 1))


def test_attention_dropout_takes_the_plain_path(monkeypatch):
    """Attention dropout > 0 runs flax's plain attention with its dropout (the
    kernels have none), drawing from an explicit generator; in eval mode it
    equals the kernel path. The downstream options check their encoder."""
    from audiossl_tpu_torch.downstream.model import DownstreamModel
    from audiossl_tpu_torch.models import ast as past

    x = torch.from_numpy(_input())[:, None]
    model = ASTEncoder(F_DIM, T_DIM, ASTConfig.tiny(depth=1, dropout=0.2))
    plain = ASTEncoder(F_DIM, T_DIM, ASTConfig.tiny(depth=1))
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = plain.eval()(x)

    def refuse(*args):
        raise AssertionError("attention dropout must not reach the kernels")

    monkeypatch.setattr(past, "fused_rel_attention", refuse)
    with torch.no_grad():
        assert _rel(model.eval()(x).numpy(), want.numpy()) <= TOL_FWD
        with pytest.raises(ValueError, match="Generator"):
            model.train()(x)
        dropped = model(x, torch.Generator().manual_seed(0))
    assert dropped.shape == (B, 192) and torch.isfinite(dropped).all() and not torch.allclose(dropped, want)
    with pytest.raises(ValueError, match="AudioNTT"):
        DownstreamModel(F_DIM, 64, 3, encoder_type="AST", input_tdim=T_DIM, model_size="tiny", dropout_rate=0.1)
    with pytest.raises(ValueError, match="AST-only"):
        DownstreamModel(F_DIM, 64, 3, patch_drop=0.1)
