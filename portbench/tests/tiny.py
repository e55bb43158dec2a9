"""The benchmark's cells cut to sizes a CPU test holds: the MAST and AST
tiny variants, short clips, a few clips a step, a short queue. The programs
run their plain versions on the CPU; the MAST training cell runs its trunk
in f32, and AST's attention is f32 on the CPU, so the program and the
reference agree to round-off and the limits are this size's own."""
from __future__ import annotations

import copy

from portbench.harness import spec

TINY_MAST = dict(depth=10, stage_blocks=[1, 3, 8], droppath_rate=0.1)
TINY_AST = dict(embed_dim=192, num_heads=3)


def cell(name: str) -> spec.Cell:
    c = spec.load_cell(name)
    cfg = copy.deepcopy(c.config)
    cfg["model_size"] = "tiny"
    cfg["arch"].update(TINY_MAST if cfg["encoder"] == "MAST" else TINY_AST)
    pc = cfg["program_config"]
    if c.loop == "ssmast_train":
        pc["pretrain"].update(model_size="tiny", num_negatives=64, compute_dtype="f32")
        pc["pretrain"]["input"].update(n_mels=64, target_length=256)
        traffic = dict(batch=4, clip_seconds=2.56, pool_batches=4, reference_block=3)
        # f32 trunk: the fbank's round-off
        c.limits = {"loss1_gap": 2e-3, "grad_gap": 1e-2, "change_gap": 2e-2, "queue_gap": 1e-2, "key_gap": 2e-2,
                    "mlp_gap": 1e-5, "norm_gap": 1e-3}
        cfg["precision"]["stage"] = {"gemm": "f32"}  # the trunk's products run in f32 here
    elif c.loop == "probe_train":
        pc["downstream"]["base_encoder"]["model_size"] = "tiny"
        pc["downstream"]["input"]["n_mels"] = 64
        traffic = dict(batch=4, clip_seconds=1.0, pool_batches=4, reference_block=3)
        c.limits = {"loss1_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3, "mlp_gap": 1e-5}  # f32 attention on the CPU
    elif c.loop == "serve_open":
        cfg["serve_input"].update(n_mels=64, target_length=256)
        c.limits = {"emb_gap": 1e-3, "mlp_gap": 1e-5}  # AST's attention runs in f32 on the CPU: the program reads about 1e-6
        traffic = dict(clip_seconds=2.56, sizes=[1, 2, 4], pool_clips=8, rate_per_s=4.0, back_to_back_rounds=1)
    else:
        cfg["serve_input"].update(n_mels=64, target_length=256)
        traffic = dict(clip_seconds=2.56, fixed_batch=4, call_stride=2, pool_clips=8, checked_clips=6)
        c.limits = {"emb_gap": 0.05, "mlp_gap": 5e-3, "norm_gap": 1e-3}  # bf16 products on the CPU too
    for st in cfg["stages"]:  # block 5 of the tiny trunks
        for key in ("input_of", "output_of", "output_to", "weights"):
            if key in st:
                st[key] = ".".join(["blocks", "5", *st[key].split(".")[2:]])
    c.config = cfg
    c.traffic = dict(c.traffic, **traffic)
    return c
