"""The port's side of tests/test_torch_port_tp.py: each check runs this
rank's part of a tensor-parallel computation (its share of the batch over
the data axis, its shards over the model axis) and returns numpy results,
whole tensors gathered over the model axis where the test compares them
with a dense reference. With no process group (the test's own process) the
same code is the one-process reference. ``run`` is what each gloo rank
executes under ``torch.multiprocessing.spawn``. Imports torch and the port
only, so a spawned rank starts in seconds."""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel import tp as tpar


def _np(t):
    return t.detach().cpu().numpy().copy()


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def share(x):
    """This rank's rows of a global batch over the data axis, as a tensor."""
    return dist.share(_t(x)).contiguous()


def cut_tiny():
    """MAST tiny with 4 blocks and AST tiny's width with 4 heads at depth 2
    (its 3 heads do not divide by 2), as the test cuts both sides."""
    from audiossl_tpu_torch.models import ast as past
    from audiossl_tpu_torch.models import mast as pmast
    from audiossl_tpu_torch.models.mvit import MViTConfig

    pmast.VARIANTS["tiny"] = lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw)
    past.VARIANTS["tiny"] = lambda **kw: past.ASTConfig(embed_dim=192, num_heads=4, depth=2, **kw)


# ---------------------------------------------------------------- faults the checks must catch


class _SumBackwardReduce(torch.autograd.Function):
    """The all-reduce after a row-parallel layer with a summed backward (the
    fault: every replicated gradient upstream scales by tp)."""

    @staticmethod
    def forward(ctx, x):
        out = x.detach().clone().contiguous()
        torch.distributed.all_reduce(out, group=dist.model_group())
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.detach().clone().contiguous()
        torch.distributed.all_reduce(out, group=dist.model_group())
        return out


def _world_mean_grads_(params) -> None:
    """The gradients' mean over the whole world (the fault: shards of one
    weight from different model ranks averaged together)."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        p.grad = torch.zeros_like(p) if p.grad is None else p.grad
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    torch.distributed.all_reduce(flat)
    flat /= dist.world()
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p.grad).clone()
        off += p.numel()


@contextlib.contextmanager
def planted(fault: str | None):
    saved = tpar.reduce_from_model, dist.all_reduce_grads_
    if fault == "sum_backward_reduce":
        tpar.reduce_from_model = lambda x: _SumBackwardReduce.apply(x) if dist.tp_world() > 1 else x
    elif fault == "world_grad_mean":
        dist.all_reduce_grads_ = _world_mean_grads_
    try:
        yield
    finally:
        tpar.reduce_from_model, dist.all_reduce_grads_ = saved


# ---------------------------------------------------------------- checks


def prims_check(d):
    """JAX's tests/test_tp.py cases: tp_mlp forward, and the gradients of
    sum(y^2) summed over the data axis; then the gather / scatter pair of
    MViT's attention (a column-parallel layer gathered, sliced, row-parallel)
    against its dense chain. The weights come in the JAX layout [in, out]
    and go to the primitives in torch's [out, in]; their gradients come back
    in the JAX layout."""
    r, n = dist.tp_rank(), dist.tp_world()
    column = lambda w: tpar.piece(_t(w).T, (0, 1), r, n).requires_grad_()  # noqa: E731
    row = lambda w: tpar.piece(_t(w).T, (1, 1), r, n).requires_grad_()  # noqa: E731
    x = share(d["x"])
    w1, w2 = column(d["w1"]), row(d["w2"])
    y = tpar.tp_mlp(x, w1, w2)
    y.square().sum().backward()
    dist.all_reduce_grads_([w1, w2])  # the mean over the data axis; times its size for JAX's psum
    wa, wb = column(d["wa"]), row(d["wb"])
    xa = share(d["x"]).requires_grad_()
    h = tpar.gather_from_model(tpar.column_parallel(xa, wa))  # [B, K] whole on every rank
    y2 = tpar.row_parallel(tpar.scatter_to_model(torch.tanh(h)), wb)
    (y2 * share(d["cot"])).sum().backward()
    dist.all_reduce_grads_([wa, wb])
    s = dist.dp_world()
    whole = lambda w, dim: _np(tpar.gather_from_ranks(w.grad * s, (dim, 1)).T)  # noqa: E731
    return {"y": _np(dist.all_gather(y.detach())), "dw1": whole(w1, 0), "dw2": whole(w2, 1),
            "y2": _np(dist.all_gather(y2.detach())), "dxa": _np(dist.all_gather(xa.grad)), "dwa": whole(wa, 0),
            "dwb": whole(wb, 1)}


def _encoder(d):
    from audiossl_tpu_torch.models.ast import ASTEncoder
    from audiossl_tpu_torch.models.mast import MASTEncoder
    from audiossl_tpu_torch.parallel.tp_ast import ast_spec, shard_ast_
    from audiossl_tpu_torch.parallel.tp_mvit import mvit_spec, shard_mvit_

    if d["kind"] == "mast":
        model = MASTEncoder(d["f"], d["t"], "tiny", compute_dtype=None)
        shard, spec_of = shard_mvit_, mvit_spec
    else:
        model = ASTEncoder(d["f"], d["t"], "tiny", attention_dtype=torch.float32)
        shard, spec_of = shard_ast_, ast_spec
    model.load_state_dict({k: _t(v) for k, v in d["state"].items()}, strict=True)
    shard(model)
    return model.to(d.get("device", "cpu")).eval(), spec_of  # eval: no drop-path draws; the gradients flow all the same


def encoder_check(d):
    """MAST-tiny or AST (tiny's width, 4 heads) at tp = world: the forward
    on this rank's clips, the gradients of sum(y * cot) gathered whole, and
    this rank's shards."""
    from audiossl_tpu_torch import no_tf32

    model, spec_of = _encoder(d)
    dev = torch.device(d.get("device", "cpu"))
    shards = {k: _np(v) for k, v in model.state_dict().items()}
    with no_tf32():
        y = model(share(d["x"]).to(dev))
        (y * share(d["cot"]).to(dev)).sum().backward()
    dist.all_reduce_grads_(model.parameters())
    grads = {n: _np(tpar.gather_from_ranks(p.grad * dist.dp_world(), spec_of(n)))
             for n, p in model.named_parameters()}
    return {"y": _np(dist.all_gather(y.detach())), "grads": grads, "shards": shards}


def ssmast_check(d):
    """One SS-MAST step (MAST-tiny, f32, AdamW at eps 1e-4) through
    TrainStep's gradient and loss all-reduce, on this rank's share of the
    views and its shards; the loss, the whole gradients and the whole state
    after the step (parameters, key tower, queue, pointer), with one planted
    fault or none."""
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.parallel.tp_mvit import mvit_spec, shard_mvit_
    from audiossl_tpu_torch.train.step import TrainStep

    obj = init_objective("ssmast", d["config"], seed=0)
    obj.load_state_dict({k: _t(v) for k, v in d["state"].items()}, strict=True)
    shard_mvit_(obj)
    obj.train()
    params = [p for p in obj.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-4, weight_decay=0.0)
    out = {}
    with planted(d.get("fault")):
        step = TrainStep(obj, None, None, opt, torch.Generator().manual_seed(dist.rank_seed(0)))
        loss = step.loss_and_grads(share(d["v1"]), share(d["v2"]))
        out["grads"] = {n: _np(tpar.gather_from_ranks(p.grad, mvit_spec(n))) for n, p in obj.named_parameters()
                        if p.requires_grad}
        step.update()
    out["qkv_rows"] = int(obj.encoder.mast.blocks[0].attn.qkv.weight.shape[0])
    out["moment_rows"] = int(opt.state[obj.encoder.mast.blocks[0].attn.qkv.weight]["exp_avg"].shape[0])
    out["state"] = {k: _np(v) for k, v in tpar.dense_state_dict(obj.state_dict(), mvit_spec).items()}
    out["loss"] = _np(loss)
    return out


def probe_check(d):
    """One probe step (AST, tiny's width with 4 heads, log-mel, Adam) on this
    rank's share of the batch, fine-tuned or frozen; the loss, the whole
    gradients and the whole state after the step."""
    from audiossl_tpu_torch.downstream.model import DownstreamModel
    from audiossl_tpu_torch.downstream.probe import probe_step
    from audiossl_tpu_torch.frontend.stft import LogMelConfig
    from audiossl_tpu_torch.parallel.tp_ast import ast_spec, shard_ast_

    out = {}
    for mode in ("finetune", "freeze"):
        model = DownstreamModel(n_mels=64, d=192, num_classes=3, encoder_type="AST", input_tdim=d["frames"],
                                model_size="tiny")
        model.load_state_dict({k: _t(v) for k, v in d["state"].items()}, strict=True)
        shard_ast_(model.encoder)
        model.train()
        if mode == "freeze":
            model.encoder.requires_grad_(False)
        opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=1e-3)
        loss = probe_step(model, opt, LogMelConfig(sample_rate=16000, n_mels=64), share(d["waves"]),
                          share(d["labels"]))
        out[mode] = {"loss": _np(loss),
                     "grads": {n: _np(tpar.gather_from_ranks(p.grad, ast_spec(n))) for n, p in model.named_parameters()
                               if p.grad is not None},
                     "state": {k: _np(v) for k, v in tpar.dense_state_dict(model.state_dict(), ast_spec).items()},
                     "qkv_rows": int(model.encoder.blocks[0].attn.qkv.weight.shape[0])}
    return out


def cli_check(d):
    """SS-MAST at ``pretrain.tp``: 2 steps straight through the CLI, and 1
    step then a resume to 2 through ``train_upstream``; the shapes each
    rank held."""
    from audiossl_tpu_torch.config import load_config
    from audiossl_tpu_torch.train.loop import train_upstream
    from audiossl_tpu_torch.train_upstream import main as train_main

    train_main(["--upstream", "ssmast", "--input", d["csv"], "-c", d["config"], "--device", "cpu", "--max_steps", "2",
                "--save_path", os.path.join(d["dir"], "straight")])
    cfg = load_config(d["config"])
    cfg["run"]["save_path"] = os.path.join(d["dir"], "half")
    obj, _, ckpt_dir = train_upstream(cfg, d["csv"], "ssmast", max_steps=1, device="cpu")
    _, step, _ = train_upstream(cfg, d["csv"], "ssmast", load_checkpoint=ckpt_dir, max_steps=2, device="cpu")
    blk = obj.encoder.mast.blocks[0]
    return {"qkv_rows": int(blk.attn.qkv.weight.shape[0]), "fc1_rows": int(blk.mlp.fc1.weight.shape[0]),
            "key_qkv_rows": int(obj.encoder_k.mast.blocks[0].attn.qkv.weight.shape[0]),
            "step": step, "config": {k: cfg["pretrain"].get(k) for k in ("pool_impl", "fused_attention")}}


CHECKS = {"prims": prims_check, "mast": encoder_check, "ast": encoder_check, "ssmast": ssmast_check,
          "ssmast_accum": ssmast_check,
          "ssmast_sum_backward_reduce": ssmast_check, "ssmast_world_grad_mean": ssmast_check,
          "probe": probe_check, "cli": cli_check}


def run_on_card(rank: int, world: int, port: int, in_path: str, out_dir: str) -> None:
    """A gloo rank on the one card (NCCL refuses two ranks on one GPU) at
    tp = world: the encoder checks on CUDA tensors, through the attention
    kernels, with their launches; results to ``out_dir/rank<r>.pt``."""
    from audiossl_tpu_torch.ops import attention as A

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cut_tiny()
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        dist.set_tp(world)
        out = {}
        for name, d in torch.load(in_path, weights_only=False).items():
            kernels = (A.rel_attention_fwd, A.rel_attention_bwd_dq, A.rel_attention_bwd_dkv)
            before = [k.launches for k in kernels]
            out[name] = encoder_check({**d, "device": "cuda"})
            out[name]["launches"] = [k.launches - b for k, b in zip(kernels, before)]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run(rank: int, world: int, tp: int, init: str, in_path: str, out_dir: str) -> None:
    """One gloo rank of a (world // tp) x tp grid: every check in the inputs,
    its results and collective counts to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    cut_tiny()
    torch.distributed.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        inputs = torch.load(in_path, weights_only=False)
        dist.set_tp(tp)
        out = {"grid": (dist.dp_rank(), dist.tp_rank(), dist.dp_world(), dist.tp_world())}
        for name, fn in CHECKS.items():
            if name in inputs:
                dist.set_tp(tp)
                dist.calls.clear()
                out[name] = fn(inputs[name])
                out[name]["calls"] = dict(dist.calls)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
