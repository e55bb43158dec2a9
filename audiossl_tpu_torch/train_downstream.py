"""Downstream linear-probe / fine-tune CLI of the port (the flags of the JAX
package's ``train_downstream.py``, plus ``--device``):

    python -m audiossl_tpu_torch.train_downstream --task speech_commands_v2 \\
        --train_csv t.csv --test_csv e.csv [--valid_csv v.csv] \\
        [--checkpoint <port pretraining checkpoint dir>] [--freeze] [-c downstream.yaml] \\
        [--epochs N] [--batch_size N] [--lr LR] [--exp_dir DIR] [--device cuda|cpu]

CSVs have columns ``wav`` and ``label``; a LAPE registry task
(``downstream/tasks.py``) reads its own CSV layout under ``--data_root``.
``--freeze`` is a store_true flag (the reference's ``type=bool`` footgun is
not copied). ``--device cpu`` runs the plain PyTorch path, the default
``cuda`` raises without a CUDA device. Under torchrun (or the ``AUDIOSSL_*``
environment) each process takes its share of every batch
(downstream/probe.py).
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path


def get_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(allow_abbrev=False, description=__doc__.split("\n")[0])
    parser.add_argument("--task", type=str, default="test_task")
    parser.add_argument("--train_csv", type=str, default=None, help="CSV with columns wav,label")
    parser.add_argument("--valid_csv", type=str, default=None)
    parser.add_argument("--test_csv", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None, help="port pretraining checkpoint dir (<save_path>_chkp)")
    parser.add_argument("--encoder", type=str, default="AudioNTT2020Task6")
    parser.add_argument("--freeze", action="store_true", help="freeze the encoder (linear probe)")
    parser.add_argument("--exp_dir", default="./exp", type=Path, help="experiment root directory")
    parser.add_argument("--data_root", type=str, default=None, help="LAPE task data root (AUDIOSSL_DATA_ROOT)")
    parser.add_argument("--upstream", type=str, default="delores_m")
    parser.add_argument("-c", "--config", metavar="CONFIG_PATH", default=None)
    parser.add_argument("--epochs", type=int, default=None, help="override config run.epochs")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    import os

    from audiossl_tpu_torch.config import CONFIG_DIR, load_config
    from audiossl_tpu_torch.downstream.probe import run_downstream

    config = load_config(args.config or os.path.join(CONFIG_DIR, "downstream.yaml"))
    if args.encoder is not None:
        config["downstream"]["base_encoder"]["type"] = args.encoder
    for key in ("epochs", "batch_size", "lr"):
        if getattr(args, key) is not None:
            config["run"][key] = getattr(args, key)
    print(config)
    result = run_downstream(config, vars(args), device=args.device)
    print(f"max test accuracy : {result['best_test_acc']}")
    return result


if __name__ == "__main__":
    main()
