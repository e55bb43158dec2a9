"""Upstream SSL pretraining CLI of the port (the flags and defaults of the
JAX package's ``train_upstream.py``, plus ``--device``):

    python -m audiossl_tpu_torch.train_upstream --upstream delores_s --input pre_train.csv \\
        [-c config.yaml] [--load_checkpoint DIR] [--max_steps N] [--epochs N] \\
        [--batch_size N] [--save_path PATH] [--device cuda|cpu]

Seed 31. ``--device cpu`` runs the plain PyTorch path; the default ``cuda``
raises without a CUDA device. ``decar_v2`` and ``decar_v1`` (DeepCluster-v1)
have trainers of their own, as in the JAX package (its
train_upstream.py:59-76). Data parallel over N processes, one card each,
started by torchrun or with the ``AUDIOSSL_*`` environment
(parallel/launch.py), e.g.

    torchrun --nproc_per_node 4 -m audiossl_tpu_torch.train_upstream --upstream delores_s --input pre_train.csv

``run.batch_size`` is the global batch; each process reads its share.
"""
from __future__ import annotations

import argparse
import logging


def get_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(allow_abbrev=False, description=__doc__.split("\n")[0])
    parser.add_argument("--input", type=str, required=True, help="pretraining manifest CSV (column `files`)")
    parser.add_argument("--load_checkpoint", type=str, default=None, help="checkpoint dir to resume from")
    parser.add_argument("-c", "--config", metavar="CONFIG_PATH", default=None,
                        help="experiment YAML (defaults to configs/<upstream>.yaml)")
    parser.add_argument("--upstream", type=str, default="delores_m", help="upstream objective name")
    parser.add_argument("--max_steps", type=int, default=None, help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--epochs", type=int, default=None, help="override config run.epochs")
    parser.add_argument("--batch_size", type=int, default=None, help="override config run.batch_size")
    parser.add_argument("--save_path", type=str, default=None, help="override config run.save_path")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    from audiossl_tpu_torch.config import load_config

    config = load_config(args.config, args.upstream)
    for key in ("epochs", "batch_size", "save_path"):
        if getattr(args, key) is not None:
            config["run"][key] = getattr(args, key)
    print(config)
    kw = dict(load_checkpoint=args.load_checkpoint, max_steps=args.max_steps, device=args.device)
    if args.upstream == "decar_v2":  # the per-epoch k-means over the memory bank
        from audiossl_tpu_torch.train.decar_loop import train_decar

        _, step, ckpt_dir = train_decar(config, args.input, **kw)
    elif args.upstream == "decar_v1":  # DeepCluster-v1's epoch mode
        from audiossl_tpu_torch.train.deepcluster_loop import train_deepcluster_v1

        _, step, ckpt_dir, _ = train_deepcluster_v1(config, args.input, **kw)
    else:
        from audiossl_tpu_torch.train.loop import train_upstream

        _, step, ckpt_dir = train_upstream(config, args.input, args.upstream, **kw)
    print(f"checkpoints written to {ckpt_dir} (final step {step})")


if __name__ == "__main__":
    main()
