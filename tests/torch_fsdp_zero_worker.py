"""The port's side of tests/test_torch_port_fsdp_zero.py: each check runs this
rank's part of a step under ``run.fsdp`` (parallel/fsdp.py) or
``run.zero_optimizer`` (train/zero.py), its share of the batch over the data
axis, and returns numpy results: whole tensors gathered where the test
compares them with a dense reference, this rank's pieces or slices where it
compares them with JAX's addressable shards or rows. With no process group
(the test's own process) the same code is the one-process reference.
``run`` is what each gloo rank executes under
``torch.multiprocessing.spawn``. Imports torch and the port only, so a
spawned rank starts in seconds."""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from audiossl_tpu_torch.parallel import dist
from audiossl_tpu_torch.parallel import fsdp
from audiossl_tpu_torch.train import zero


def _np(t):
    return t.detach().cpu().numpy().copy()


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def share(x, device="cpu"):
    """This rank's rows of a global batch over the data axis, as a tensor on ``device``."""
    return dist.share(_t(x)).contiguous().to(device)


def cut_tiny():
    """MAST tiny cut to 2 blocks, as the test cuts both sides."""
    from audiossl_tpu_torch.models import mast as pmast
    from audiossl_tpu_torch.models.mvit import MViTConfig

    pmast.VARIANTS["tiny"] = lambda **kw: MViTConfig._variant(2, 0.1, (1,), kw)


# ---------------------------------------------------------------- faults the checks must catch


def _sum_reduce_scatter(flat, kind="reduce_scatter"):
    """The gradients' reduce-scatter as a sum over the data axis (the fault:
    every piece's gradient scaled by n)."""
    n = dist.dp_world()
    out = torch.empty(flat.numel() // n, dtype=flat.dtype, device=flat.device)
    torch.distributed.reduce_scatter_tensor(out, flat.contiguous())
    return out


def _replicated_n_times(sharded, whole):
    """The clip's squared norm with the whole leaves summed over the data axis
    too (the fault: each counted n times)."""
    sq = torch.cat([t.float().flatten() for t in list(sharded) + list(whole)]).square().sum()
    return dist.all_reduce_sum(sq, "fsdp_norm")


def _offset_slice(a, n, rank):
    """Rank r's ZeRO slice taken from row r + 1 (the fault)."""
    return zero.shard_rows(a, n)[(rank + 1) % n]


@contextlib.contextmanager
def planted(fault: str | None):
    saved = dist.reduce_scatter_mean, fsdp.global_sq_norm, zero.local_slice
    if fault == "sum_reduce_scatter":
        dist.reduce_scatter_mean = _sum_reduce_scatter
    elif fault == "replicated_n_times":
        fsdp.global_sq_norm = _replicated_n_times
    elif fault == "zero_row_offset":
        zero.local_slice = _offset_slice
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        dist.reduce_scatter_mean, fsdp.global_sq_norm, zero.local_slice = saved


# ---------------------------------------------------------------- checks


def _ssmast(d):
    from audiossl_tpu_torch.objectives import init_objective

    obj = init_objective("ssmast", d["config"], seed=0)
    obj.load_state_dict({k: _t(v) for k, v in d["state"].items()}, strict=True)
    return obj.to(d.get("device", "cpu")).train()


def _adamw(params):
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-4, weight_decay=0.0)


def ssmast_fsdp_check(d):
    """One SS-MAST step (MAST tiny, f32, AdamW at eps 1e-4) under fsdp
    through TrainStep: this rank's pieces before the step, the loss, the
    whole gradients, the whole state and moments after it, every piece's
    shape after it; with one planted fault or none."""
    from audiossl_tpu_torch.train.loop import shard_objective_
    from audiossl_tpu_torch.train.step import TrainStep

    dev = d.get("device", "cpu")
    obj = _ssmast(d)
    shards = shard_objective_(obj)
    out = {"pieces": {k: _np(v) for k, v in obj.state_dict().items()}, "dims": dict(shards.dims)}
    names = [n for n, p in obj.named_parameters() if p.requires_grad]
    params = [p for p in obj.parameters() if p.requires_grad]
    opt = _adamw(params)
    with planted(d.get("fault")):
        step = TrainStep(obj, None, None, opt, torch.Generator(dev).manual_seed(dist.rank_seed(0)), layout=shards)
        loss = step.loss_and_grads(share(d["v1"], dev), share(d["v2"], dev))
        step.update()
    out["step_calls"] = dict(dist.calls)
    out["grads"] = {n: _np(g) for n, g in shards.dense_state_dict({n: p.grad for n, p in zip(names, params)}).items()}
    out["loss"] = _np(loss)
    out["after"] = {k: _np(v) for k, v in shards.dense_state_dict(obj.state_dict()).items()}
    out["piece_shapes"] = {k: tuple(v.shape) for k, v in obj.state_dict().items()}
    dense_opt = shards.dense_optimizer_state(opt.state_dict(), names)
    out["moments"] = {names[i]: {k: _np(v) for k, v in st.items() if k != "step"} for i, st in dense_opt["state"].items()}
    out["moment_shapes"] = {names[i]: tuple(st["exp_avg"].shape) for i, st in opt.state_dict()["state"].items()}
    return out


def zero_check(d):
    """One step of ``d["name"]`` (DeLoRes-S with SGD, SS-MAST with AdamW at
    eps 1e-4) under ZeRO through TrainStep: the loss, the state after the
    step, and this rank's slice of every moment, by parameter name; with one
    planted fault or none."""
    from audiossl_tpu_torch.objectives import init_objective
    from audiossl_tpu_torch.train.optim import sgd_torch
    from audiossl_tpu_torch.train.step import TrainStep

    dev = d.get("device", "cpu")
    obj = init_objective(d["name"], d["config"], seed=0)
    obj.load_state_dict({k: _t(v) for k, v in d["state"].items()}, strict=True)
    obj.to(dev).train()
    names = [n for n, p in obj.named_parameters() if p.requires_grad]
    inner = (lambda s: sgd_torch(s, 0.03)) if d["name"] == "delores_s" else _adamw
    with planted(d.get("fault")):
        opt = zero.ZeroOptimizer([p for p in obj.parameters() if p.requires_grad], inner)
        step = TrainStep(obj, None, None, opt, torch.Generator(dev).manual_seed(dist.rank_seed(0)), layout=opt)
        loss = step.loss_and_grads(share(d["v1"], dev), share(d["v2"], dev))
        step.update()
    step_calls = dict(dist.calls)
    state = opt.inner.state_dict()["state"]
    return {"loss": _np(loss), "step_calls": step_calls, "after": {k: _np(v) for k, v in obj.state_dict().items()},
            "slices": {names[i]: {k: _np(v) for k, v in st.items() if torch.is_tensor(v) and v.dim() > 0}
                       for i, st in state.items()},
            "saved_rows": {names[i]: tuple(st[k].shape) for i, st in opt.state_dict()["state"].items()
                           for k in st if k != "step"}}


def finetune_fsdp_check(d):
    """One MAST-tiny fine-tune step under fsdp with the augmentations off and
    the clip engaged: the loss, the global norm the clip reads, the whole
    gradients before the clip, the whole parameters after the step; with one
    planted fault or none."""
    from audiossl_tpu_torch.train import finetune_mast as ft
    from audiossl_tpu_torch.train.layer_decay import adamw_layer_decay

    dev = d.get("device", "cpu")
    model = ft.build_classifier(d["ft"], d["n_classes"])
    model.load_state_dict({k: _t(v) for k, v in d["state"].items()}, strict=True)
    model.to(dev).train()
    shards = fsdp.shard_(model, ft.FSDP_UNITS)
    opt = adamw_layer_decay(model.named_parameters(), 5e-4, depth=4, layer_decay=0.75, clip_grad_norm=d["clip"],
                            shards=shards)
    with planted(d.get("fault")):
        step = ft.FinetuneStep(model, opt, d["ft"], torch.Generator(dev).manual_seed(dist.rank_seed(0)), layout=shards)
        loss = step.loss_and_grads(share(d["waves"], dev), share(d["targets"], dev))
        norm = shards.grad_norm(step.params)
        grads = {k: _np(v) for k, v in shards.dense_state_dict({n: p.grad for n, p in model.named_parameters()}).items()}
        opt.step()
    return {"loss": _np(loss), "norm": float(norm), "grads": grads,
            "after": {k: _np(v) for k, v in shards.dense_state_dict(model.state_dict()).items()},
            "calls": dict(dist.calls)}


def cli_check(d):
    """SS-MAST under fsdp through train_upstream: 2 steps straight through the
    CLI, and 1 step then a resume to 2; the pieces the objective held; one
    ZeRO step to a checkpoint."""
    from audiossl_tpu_torch.config import load_config
    from audiossl_tpu_torch.train.loop import train_upstream
    from audiossl_tpu_torch.train_upstream import main as train_main

    train_main(["--upstream", "ssmast", "--input", d["csv"], "-c", d["fsdp_config"], "--device", "cpu",
                "--max_steps", "2", "--save_path", os.path.join(d["dir"], "straight")])
    cfg = load_config(d["fsdp_config"])
    cfg["run"]["save_path"] = os.path.join(d["dir"], "half")
    obj, _, ckpt_dir = train_upstream(cfg, d["csv"], "ssmast", max_steps=1, device="cpu")
    pieces = {k: tuple(v.shape) for k, v in obj.state_dict().items()}
    _, step, _ = train_upstream(cfg, d["csv"], "ssmast", load_checkpoint=ckpt_dir, max_steps=2, device="cpu")
    zcfg = load_config(d["zero_config"])
    zcfg["run"]["save_path"] = os.path.join(d["dir"], "zero")
    train_upstream(zcfg, d["csv"], "ssmast", max_steps=1, device="cpu")
    return {"pieces": pieces, "step": step}


def finetune_cli_check(d):
    """The fine-tune CLI with ``--fsdp`` from the classifier state given, 2
    steps, to ``d["save_path"]``; with one planted fault or none; with
    ``d["resume"]`` also 1 step to ``<save_path>_half`` and a resume from it
    to 2."""
    from audiossl_tpu_torch.train import finetune_mast as ft

    state = {k: _t(v) for k, v in d["ft_state"].items()}

    def from_state(ft_cfg, n_classes, seed, device):
        model = ft.build_classifier(ft_cfg, n_classes)
        model.load_state_dict(state)
        return model.to(device)

    ft.init_classifier = from_state
    args = ["--train_json", d["ft_train"], "--label_csv", d["ft_labels"], "-c", d["ft_config"], "--fsdp", "--device", "cpu"]
    with planted(d.get("fault")):
        ft.main(args + ["--max_steps", "2", "--save_path", d["save_path"]])
    if d.get("resume"):
        half = d["save_path"] + "_half"
        ft.main(args + ["--max_steps", "1", "--save_path", half])
        ft.main(args + ["--max_steps", "2", "--save_path", half, "--load_checkpoint", half + "_chkp"])
    return {}


CHECKS = {"ssmast_fsdp": ssmast_fsdp_check, "ssmast_fsdp_accum": ssmast_fsdp_check,
          "ssmast_fsdp_sum_reduce_scatter": ssmast_fsdp_check, "zero_delores_s": zero_check,
          "zero_ssmast": zero_check, "zero_ssmast_zero_row_offset": zero_check, "finetune_fsdp": finetune_fsdp_check,
          "finetune_fsdp_replicated_n_times": finetune_fsdp_check, "cli": cli_check,
          "finetune_cli": finetune_cli_check, "finetune_cli_replicated_n_times": finetune_cli_check}


def run_on_card(rank: int, world: int, port: int, in_path: str, out_dir: str) -> None:
    """A gloo rank on the one card (NCCL refuses two ranks on one GPU): the
    checks in the inputs on CUDA tensors, through the kernels, with their
    launches; results to ``out_dir/rank<r>.pt``."""
    from audiossl_tpu_torch.frontend import fused_stft
    from audiossl_tpu_torch.ops import attention as A

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cut_tiny()
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        out = {}
        for name, d in torch.load(in_path, weights_only=False).items():
            kernels = (A.rel_attention_fwd, A.rel_attention_bwd_dq, A.rel_attention_bwd_dkv)
            before = [k.launches for k in kernels] + [fused_stft.fused_rows.launches["kaldi"]]
            dist.calls.clear()
            out[name] = CHECKS[name]({**d, "device": "cuda"})
            after = [k.launches for k in kernels] + [fused_stft.fused_rows.launches["kaldi"]]
            out[name]["launches"] = [a - b for a, b in zip(after, before)]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run(rank: int, world: int, init: str, in_path: str, out_dir: str) -> None:
    """One gloo rank: every check in the inputs, its results and collective
    counts to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    cut_tiny()
    torch.distributed.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        inputs = torch.load(in_path, weights_only=False)
        out = {}
        for name, fn in CHECKS.items():
            if name in inputs:
                dist.calls.clear()
                out[name] = fn(inputs[name])
                out[name]["calls"] = dict(dist.calls)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
