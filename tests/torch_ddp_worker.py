"""The port's side of tests/test_torch_port_ddp.py: each check runs this
process's share of a global batch through the port and returns numpy
results. With no process group (the test's own process) the same code is
the one-process reference at the whole batch; ``run`` is what each of the
two gloo ranks executes under ``torch.multiprocessing.spawn``. Imports torch
and the port only, so a spawned rank starts in seconds."""
from __future__ import annotations

import os

import numpy as np
import torch

from audiossl_tpu_torch.parallel import dist


def share(x):
    """This rank's contiguous rows of a global batch, as a tensor."""
    return dist.share(torch.as_tensor(np.asarray(x))).contiguous()


def _np(t):
    return t.detach().cpu().numpy().copy()


def _grads(params):
    return {n: _np(p.grad) for n, p in params}


def block1_check(d):
    """Block 1 on this rank's clips, on ``d["device"]`` (the CPU by default:
    the plain versions; on a CUDA device the kernels, whose launches are
    returned)."""
    from audiossl_tpu_torch.ops import block1

    dev = torch.device(d.get("device", "cpu"))
    x, cot = share(d["x"])[:, None].to(dev), share(d["cot"]).to(dev)
    ps = [torch.from_numpy(d[k]).to(dev).requires_grad_() for k in ("w", "bias", "gamma", "beta")]
    fns = (block1.block1_fwd, block1.block1_bwd_sums, block1.block1_bwd_weight)
    before = [f.launches for f in fns]
    pooled, mean, var = block1.fused_block1(x, *ps)
    ((pooled * cot).sum() / x.shape[0]).backward()
    dist.all_reduce_grads_(ps)
    return {"pooled": _np(pooled), "mean": _np(mean), "var": _np(var),
            "launches": [f.launches - b for f, b in zip(fns, before)],
            **{f"d{k}": _np(p.grad) for k, p in zip(("w", "bias", "gamma", "beta"), ps)}}


def barlow_check(d):
    from audiossl_tpu_torch.models.heads import barlow_loss

    w = torch.from_numpy(d["w"]).requires_grad_()
    loss = barlow_loss(share(d["h1"]) @ w, share(d["h2"]) @ w)
    loss.backward()
    dist.all_reduce_grads_([w])
    return {"loss": _np(loss), "dw": _np(w.grad)}


def _objective(d):
    from audiossl_tpu_torch.objectives import init_objective

    obj = init_objective(d["name"], d["config"], seed=0)
    obj.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in d["state"].items()}, strict=True)
    return obj.train()


def delores_s_check(d):
    """One SGD step (lr 0.03, momentum 0.9, wd 1e-4) through TrainStep's
    gradient and loss all-reduce."""
    from audiossl_tpu_torch.train.optim import sgd_torch
    from audiossl_tpu_torch.train.step import TrainStep

    obj = _objective(d)
    params = [p for p in obj.parameters() if p.requires_grad]
    step = TrainStep(obj, None, None, sgd_torch(params, 0.03), torch.Generator().manual_seed(dist.rank_seed(0)))
    loss = step.loss_and_grads(share(d["v1"]), share(d["v2"]))
    grads = _grads(obj.named_parameters())
    step.update()
    return {"loss": _np(loss), "grads": grads, "state": {k: _np(v) for k, v in obj.state_dict().items()}}


def moco_check(d):
    """One forward of a MoCo objective (DeLoRes-M or SS-MAST): the queue, its
    pointer and the key encoder's state after the step."""
    obj = _objective(d)
    g = torch.Generator().manual_seed(dist.rank_seed(0))
    with torch.no_grad():
        loss = obj.loss(share(d["v1"]), share(d["v2"]), g)
    keys = {k: _np(v) for k, v in obj.state_dict().items() if k.startswith("encoder_k.")}
    return {"loss": _np(dist.all_reduce_mean(loss)), "queue": _np(obj.queue), "ptr": int(obj.queue_ptr), "key_state": keys}


def finetune_check(d):
    """One MAST-tiny fine-tune step with the augmentations off: the loss, the
    all-reduced gradients and the parameters after layer-decay AdamW."""
    from audiossl_tpu_torch.train import finetune_mast as ft
    from audiossl_tpu_torch.train.layer_decay import adamw_layer_decay

    model = ft.build_classifier(d["ft"], d["n_classes"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in d["state"].items()}, strict=True)
    model.train()
    opt = adamw_layer_decay(model.named_parameters(), 5e-4, depth=4, layer_decay=0.75)
    step = ft.FinetuneStep(model, opt, d["ft"], torch.Generator().manual_seed(dist.rank_seed(0)))
    loss = step.loss_and_grads(share(d["waves"]), share(d["targets"]))
    grads = _grads(model.named_parameters())
    opt.step()
    return {"loss": _np(loss), "grads": grads, "state": {k: _np(v) for k, v in model.state_dict().items()}}


def probe_check(d):
    """One probe step (AudioNTT, SyncBN, fused block 1, Adam) on this rank's
    share of the batch."""
    from audiossl_tpu_torch.downstream.model import DownstreamModel
    from audiossl_tpu_torch.downstream.probe import probe_step
    from audiossl_tpu_torch.frontend.stft import LogMelConfig

    model = DownstreamModel(n_mels=64, d=32, num_classes=3, dropout_rate=0.0, compute_dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in d["state"].items()}, strict=True)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = probe_step(model, opt, LogMelConfig(sample_rate=16000, n_mels=64), share(d["waves"]),
                      share(d["labels"]))
    grads = _grads(model.named_parameters())
    return {"loss": _np(loss), "grads": grads, "state": {k: _np(v) for k, v in model.state_dict().items()}}


def kmeans_check(d):
    """DECAR's k-means with this rank's shard of the bank (``kmeans_on_mesh``'s
    collectives: rank 0's initial centroids, the summed counts and sums, the
    gathered assignments)."""
    from audiossl_tpu_torch.objectives.decar import kmeans_on_mesh

    cents, assign = kmeans_on_mesh(share(d["emb"]), share(d["idx"]), d["n_total"], d["k"], torch.from_numpy(d["pick"]),
                                   d["iters"])
    return {"cents": _np(cents), "assign": _np(assign)}


def trainers_check(d):
    """Each CLI in ``d["runs"]`` ((name, module, argv)) at world 2: whether
    it returned."""
    import importlib

    out = {}
    for name, module, argv in d["runs"]:
        importlib.import_module(module).main(argv)
        out[name] = True
    return out


def eval_check(d):
    """The fine-tune's eval scores (a rank-strided share of the datafile a
    rank, gathered back into its order) and the probe's test accuracy (every
    rank's share of each batch, the counts summed), for fixed weights."""
    from audiossl_tpu_torch.data.multilabel import multilabel_loader
    from audiossl_tpu_torch.data.pipeline import ManifestLoader
    from audiossl_tpu_torch.downstream.model import DownstreamModel
    from audiossl_tpu_torch.downstream.probe import evaluate
    from audiossl_tpu_torch.frontend.stft import LogMelConfig
    from audiossl_tpu_torch.train import finetune_mast as ft

    model = ft.build_classifier(d["ft"], d["n_classes"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in d["ft_state"].items()}, strict=True)
    shard = (dist.rank(), dist.world()) if dist.active() else None
    loader, _ = multilabel_loader(d["json"], d["label_csv"], 2, 8000, 16000, shuffle=False, drop_last=False,
                                  num_workers=1, host_shard=shard)
    scores, targets = ft.eval_scores(ft.FinetuneStep(model, None, d["ft"], torch.Generator()), loader, "cpu")
    probe = DownstreamModel(n_mels=64, d=32, num_classes=3, dropout_rate=0.0, compute_dtype=torch.float32)
    probe.load_state_dict({k: torch.from_numpy(v) for k, v in d["probe_state"].items()}, strict=True)
    test = ManifestLoader(d["probe_csv"], 3, 15200, 16000, labeled=True, file_col="wav", shuffle=False, drop_last=False,
                          num_workers=1)
    return {"scores": scores, "targets": targets,
            "accuracy": evaluate(probe, test, LogMelConfig(sample_rate=16000, n_mels=64), torch.device("cpu"))}


def aug_check(d):
    """This rank's views through RunningNorm, started from its row of a
    world-sized augmentation state, and the state after, gathered."""
    from audiossl_tpu_torch.data.augment import AugmentConfig, AugmentPipeline
    from audiossl_tpu_torch.train.loop import aug_state_from_world, world_aug_state

    pipe = AugmentPipeline(AugmentConfig(mixup_ratio=None, rrc=False), epoch_samples=d["epoch_samples"])
    state = aug_state_from_world(d["augment"], torch.device("cpu"))
    x = share(d["lms"])
    state, v1, v2 = pipe(state, x, pipe.sample_draws(state, x.shape[0], x.shape[2], x.shape[3], torch.Generator()))
    return {"v1": _np(v1), "v2": _np(v2), "augment": world_aug_state(state)}


def state_check(d):
    """The preemption flag's OR across ranks (rank 1 signalled), and the
    world-sized augmentation state: gathered in rank order, each rank's row
    read back."""
    from audiossl_tpu_torch.data.augment import AugmentState, MixupBankState
    from audiossl_tpu_torch.ops.stats import RunningNormState
    from audiossl_tpu_torch.train.loop import aug_state_from_world, world_aug_state
    from audiossl_tpu_torch.train.preemption import PreemptionGuard

    guard = PreemptionGuard()
    guard._flag = dist.rank() == 1
    r = dist.rank()
    state = AugmentState(MixupBankState(torch.full((3, 2, 2), float(r), dtype=torch.bfloat16), 2 + r, 1 + r),
                         RunningNormState(10 + r, torch.tensor(0.5 + r), torch.tensor(2.0 + r), 99))
    world = world_aug_state(state)
    back = aug_state_from_world(world, torch.device("cpu"))
    same = (torch.equal(back.mixup.bank, state.mixup.bank) and back.mixup.fill == state.mixup.fill
            and back.running_norm.n == state.running_norm.n and float(back.running_norm.var) == 2.0 + r)
    return {"stop": guard.should_stop(), "world_layout": world, "row_back": same}


CHECKS = {"block1": block1_check, "barlow": barlow_check, "delores_s": delores_s_check,
          "delores_m": moco_check, "delores_m_shuffle": moco_check, "ssmast_shuffle": moco_check,
          "finetune": finetune_check, "probe": probe_check, "kmeans": kmeans_check, "eval": eval_check, "aug": aug_check, "state": state_check,
          "trainers": trainers_check}


def run_on_card(rank: int, world: int, port: int, in_path: str, out_dir: str) -> None:
    """A gloo rank on the one card (NCCL refuses two ranks on one GPU): the
    block-1 check on CUDA tensors, its result to ``out_dir/rank<r>.pt``."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        out = block1_check({**torch.load(in_path, weights_only=False), "device": "cuda"})
        out["calls"] = dict(dist.calls)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run(rank: int, world: int, init: str, in_path: str, out_dir: str) -> None:
    """One gloo rank: every check on its share, the results and the
    collective counts of each check to ``out_dir/rank<r>.pt``."""
    from audiossl_tpu_torch.models import mast as pmast
    from audiossl_tpu_torch.models.mvit import MViTConfig

    torch.set_num_threads(1)
    pmast.VARIANTS["tiny"] = lambda **kw: MViTConfig._variant(4, 0.1, (1, 2, 3), kw)  # MAST tiny cut to 4 blocks
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
