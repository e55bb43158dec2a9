"""The port's side of tests/test_torch_port_pipeline.py and
tests/test_torch_port_moe_sp.py: each check runs this rank's part of a
pipeline-, expert- or sequence-parallel computation over the groups
``dist.inner_grid`` lays out, and returns numpy results (this rank's
part; the tests join the parts in rank order). ``run`` is what each gloo
rank executes under ``torch.multiprocessing.spawn``; with no process group
(the test's own process) a check is the one-process run. Imports torch and
the port only, so a spawned rank starts in seconds."""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from audiossl_tpu_torch.frontend import sp
from audiossl_tpu_torch.frontend.stft import LogMelConfig
from audiossl_tpu_torch.models.ast import ASTConfig, ASTEncoder
from audiossl_tpu_torch.models.convert import long_ast_from_jax, moe_from_jax, vit_block_from_jax
from audiossl_tpu_torch.parallel import dist, moe, pipeline, ring
from audiossl_tpu_torch.parallel.pipeline_ast import pipelined_ast_forward


def _np(t):
    return t.detach().cpu().numpy().copy()


def _t(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a).copy())


def _part(a, n: int, i: int, dim: int = 0) -> torch.Tensor:
    """Part i of n equal parts of ``a`` along ``dim``, as a tensor."""
    return _t(a).chunk(n, dim=dim)[i].contiguous()


# ---------------------------------------------------------------- JAX-layout weights drawn in numpy


def jax_vit_blocks(depth: int, d: int, rng: np.random.Generator) -> list[dict]:
    """``depth`` blocks of JAX's ``vit_block`` parameters (the keys of
    ``audiossl_tpu.parallel.ring.init_long_ast_params``: ln1, qkv, proj, ln2,
    fc1, fc2; Dense kernels [in, out]), drawn in numpy."""
    w = lambda *s: (0.02 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    ln = lambda: {"scale": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32), "bias": w(d)}  # noqa: E731
    return [{"ln1": ln(), "qkv": {"kernel": w(d, 3 * d), "bias": w(3 * d)}, "proj": {"kernel": w(d, d), "bias": w(d)},
             "ln2": ln(), "fc1": {"kernel": w(d, 4 * d), "bias": w(4 * d)}, "fc2": {"kernel": w(4 * d, d), "bias": w(d)}}
            for _ in range(depth)]


def jax_long_ast_params(cfg: dict, rng: np.random.Generator) -> dict:
    """``init_long_ast_params``'s tree for a ``LongASTConfig`` given as a
    dict (mlp_ratio 4), drawn in numpy."""
    d = cfg["embed_dim"]
    w = lambda *s: (0.02 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    params = {"patch": {"kernel": w(cfg["n_mels"] * cfg["time_patch"], d), "bias": w(d)},
              "pos": w(1, cfg["tokens_global"], d), "blocks": jax_vit_blocks(cfg["depth"], d, rng),
              "norm": {"scale": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32), "bias": w(d)}}
    if cfg.get("num_classes"):
        params["head"] = {"kernel": w(d, cfg["num_classes"]), "bias": w(cfg["num_classes"])}
    return params


# ---------------------------------------------------------------- faults the checks must catch


def _summed_output_backward(buffer, group):
    """The pipeline's output collective with a summed backward (the fault:
    every stage gets the group's size times its gradient)."""
    return dist.all_reduce_sum(buffer, "pp_output", group)


class _LocalAllToAll(torch.autograd.Function):
    """An all-to-all whose backward is a local re-layout with no exchange
    (the fault: each rank's cotangents stay on it)."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, kind):
        ctx.dims, ctx.n = (split_dim, concat_dim), dist.world(group)
        return dist._all_to_all(x.detach(), split_dim, concat_dim, group, kind)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        parts = g.chunk(ctx.n, dim=concat_dim)
        return torch.cat(parts, dim=split_dim), None, None, None, None


@contextlib.contextmanager
def planted(fault: str | None):
    saved = pipeline.output_sum, dist.all_to_all, sp.halo_pairs
    if fault == "summed_output_backward":
        pipeline.output_sum = _summed_output_backward
    elif fault == "local_all_to_all_backward":
        dist.all_to_all = lambda x, s, c, group=None, kind="all_to_all": _LocalAllToAll.apply(x, s, c, group, kind)
    elif fault == "halo_to_right_neighbour":
        sp.halo_pairs = lambda w: [(i, i + 1) for i in range(w - 1)]
    try:
        yield
    finally:
        pipeline.output_sum, dist.all_to_all, sp.halo_pairs = saved


# ---------------------------------------------------------------- the collectives


def prims_check(d):
    """``ppermute`` and ``all_to_all`` over the whole world on this rank's
    rows of ``d``, forward and the gradient of a sum against a cotangent."""
    _, group = dist.inner_grid(dist.world())
    r = dist.rank(group)
    x, a = _t(d["x"][r]).requires_grad_(), _t(d["a"][r]).requires_grad_()
    y = dist.ppermute(x, d["perm"], group, "test_ppermute")
    b = dist.all_to_all(a, 0, 2, group, "test_all_to_all")
    ((y * _t(d["cot_y"][r])).sum() + (b * _t(d["cot_b"][r])).sum()).backward()
    return {"y": _np(y), "dx": _np(x.grad), "b": _np(b), "da": _np(a.grad)}


# ---------------------------------------------------------------- pipeline


def vit_blocks(d, which, device="cpu"):
    """Blocks ``which`` of JAX's ``vit_block`` stack (``d["blocks"]``: the
    blocks' JAX parameters); with ``d["attention_f32"]`` f32 attention
    operands on the card (the f32 gate)."""
    dt = torch.float32 if d.get("attention_f32") else None
    out = []
    for i in which:
        sd = vit_block_from_jax(d["blocks"][i])
        dim = sd["attn.qkv.weight"].shape[1]
        blk = pipeline.vit_block(dim, d["heads"], sd["mlp.fc1.weight"].shape[0] / dim, attention_dtype=dt)
        blk.load_state_dict(sd)
        out.append(blk.to(device))
    return out


def _vit_stage(d, group, device):
    def make_block(i):
        return vit_blocks(d, [i], device)[0]

    return pipeline.stack_stage_params(make_block, len(d["blocks"]), group)


def pp_check(d):
    """JAX's tests/test_pipeline.py cases over ``d["stages"]`` stages (and
    ``d["data"]`` data rows): the output, and with a target the loss, this
    stage's block gradients and the input's gradient (summed over the pipe
    group; this data row's). With ``frozen`` (a list of stages), those
    stages' blocks and the input take no gradient."""
    n_data = d.get("data", 1)
    data_group, group = dist.inner_grid(d["stages"])
    dev = torch.device(d.get("device", "cpu"))
    stage = _vit_stage(d, group, dev)
    stage.requires_grad_(dist.rank(group) not in d.get("frozen", ()))
    x = _part(d["x"], n_data, dist.rank(data_group), dim=1).to(dev)  # the microbatches' rows of this data index
    params = list(stage.parameters())
    stage_fn = (lambda a: checkpoint(stage, a, use_reentrant=False)) if d.get("remat") else stage
    out = {"stage_blocks": list(pipeline.stage_range(len(d["blocks"]), d["stages"], dist.rank(group)))}
    with planted(d.get("fault")):
        if "tgt" not in d:
            with torch.no_grad():
                out["out"] = _np(pipeline.pipeline_forward(stage_fn, params, x, group))
            return out
        x.requires_grad_("frozen" not in d)
        y = pipeline.pipeline_forward(stage_fn, params, x, group)
        tgt = _part(d["tgt"], n_data, dist.rank(data_group), dim=1).to(dev)
        loss = ((y - tgt) ** 2).sum() / d["tgt"].size  # this data row's share of the global mean
        loss.backward()
    # the stages are replicated over the data rows: their gradients and the loss's shares sum
    grads = {k: dist.all_reduce_sum(p.grad, "test", data_group) for k, p in stage.named_parameters()
             if p.grad is not None}
    out.update(out=_np(y), loss=float(dist.all_reduce_sum(loss.detach(), "test", data_group)),
               grads={k: _np(g) for k, g in grads.items()},
               dx=None if x.grad is None else _np(dist.all_reduce_sum(x.grad, "test", group)))
    return out


def pp_ast_check(d):
    """``pipelined_ast_forward`` of the port's AST (eval) over the pipe group;
    with ``launches`` (on the card) the attention kernels' launches too."""
    _, group = dist.inner_grid(d["stages"])
    enc = ASTEncoder(d["f"], d["t"], ASTConfig(**d["cfg"])).eval()
    enc.load_state_dict({k: _t(v) for k, v in d["state"].items()})
    with torch.no_grad():
        z = pipelined_ast_forward(enc, _t(d["x"]), d["n_micro"], group)
    return {"out": _np(z)}


# ---------------------------------------------------------------- experts


def moe_check(d):
    """JAX's tests/test_moe.py cases over ``d["ep"]`` expert ranks (and
    ``d["data"]`` data rows): this rank's tokens' output and the aux loss
    (the data rows' mean); with ``grad`` the router's gradient summed over
    the expert group and w1's, whole, summed over it (each rank fills its
    own experts' rows)."""
    n_data = d.get("data", 1)
    data_group, group = dist.inner_grid(d["ep"])
    params = {k: v.requires_grad_(bool(d.get("grad"))) for k, v in moe_from_jax(d["params"]).items()}
    x = _part(d["x"], dist.world(), dist.rank())  # the rank's block of tokens, data-major as JAX's P(("data", "expert"))
    with planted(d.get("fault")):
        y, aux = moe.moe_apply(params, x, d["capacity"], group)
        out = {"out": _np(y)}
        if n_data > 1:
            aux = dist.all_reduce_sum(aux.detach(), "test", data_group) / n_data
        out["aux"] = float(aux)
        if d.get("grad"):
            n_global = d["x"].shape[0]
            loss = (y ** 2).sum() / (n_global * y.shape[1]) + 0.01 * aux
            loss.backward()
            moe.sum_router_grad_(params["router"], group)
            out["router"] = _np(params["router"].grad)
            out["w1"] = _np(dist.all_reduce_sum(params["w1"].grad, "test", group))
    return out


# ---------------------------------------------------------------- sequence


def ring_attention_check(d):
    _, group = dist.inner_grid(dist.world())
    w, r = dist.world(group), dist.rank(group)
    q, k, v = (_part(d[n], w, r, dim=2) for n in ("q", "k", "v"))
    return {"out": _np(ring.ring_attention(q, k, v, group))}


def _long_ast(d):
    model = ring.LongAST(ring.LongASTConfig(**d["cfg"]))
    model.load_state_dict(long_ast_from_jax(d["params"]))
    return model


def long_audio_check(d):
    """``long_audio_forward`` on this rank's slice; with ``grad`` the
    gradients of sum(emb^2), the ranks' mean."""
    _, group = dist.inner_grid(dist.world())
    w, r = dist.world(group), dist.rank(group)
    model = _long_ast(d)
    wave = _part(d["wave"], w, r, dim=1)
    mel = LogMelConfig(center=False)
    with planted(d.get("fault")):
        if not d.get("grad"):
            with torch.no_grad():
                return {"out": _np(ring.long_audio_forward(model, wave, mel, group))}
        emb = ring.long_audio_forward(model, wave, mel, group)
        (emb * emb).sum().backward()
    return {"out": _np(emb), "grads": {k: _np(dist.all_reduce_sum(p.grad, "test", group) / w)
                                       for k, p in model.named_parameters()}}


def sp_check(d):
    """``sp_log_mel_local`` on this rank's slice of the padded clips."""
    _, group = dist.inner_grid(dist.world())
    w, r = dist.world(group), dist.rank(group)
    cfg = LogMelConfig()
    padded = sp.pad_for_sp(_t(d["wave"]).to(d.get("device", "cpu")), cfg, w)
    with planted(d.get("fault")):
        return {"out": _np(sp.sp_log_mel_local(_part(padded, w, r, dim=1), cfg, group))}


CHECKS = {"prims": prims_check, "pp": pp_check, "pp_ast": pp_ast_check, "moe": moe_check, "ring_attention": ring_attention_check,
          "long_audio": long_audio_check, "sp": sp_check}


def run(rank: int, world: int, init: str, in_path: str, out_dir: str) -> None:
    """One gloo rank, meeting the others at ``init`` (a ``file://``
    rendezvous: no port to race for beside the other test files' ranks):
    every check in the inputs (each named "<check>" or "<check> <case>"),
    its results and collective counts to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        out = {}
        for name, d in torch.load(in_path, weights_only=False).items():
            dist.calls.clear()
            out[name] = CHECKS[name.split()[0]](d)
            out[name]["calls"] = dict(dist.calls)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run_on_card(rank: int, world: int, init: str, in_path: str, out_dir: str) -> None:
    """A gloo rank on the one card (NCCL refuses two ranks on one GPU): the
    checks in the inputs on CUDA tensors, TF32 off, with the kernels'
    launches (attention forward, dq, dk/dv; log-mel) of each."""
    from audiossl_tpu_torch.frontend.fused_stft import log_mel_fused
    from audiossl_tpu_torch.ops import attention as A

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        out = {}
        kernels = (A.rel_attention_fwd, A.rel_attention_bwd_dq, A.rel_attention_bwd_dkv, log_mel_fused)
        for name, d in torch.load(in_path, weights_only=False).items():
            dist.calls.clear()
            before = [k.launches for k in kernels]
            out[name] = CHECKS[name.split()[0]]({**d, "device": "cuda"})
            torch.cuda.synchronize()
            out[name]["launches"] = [k.launches - b for k, b in zip(kernels, before)]
            out[name]["calls"] = dict(dist.calls)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
