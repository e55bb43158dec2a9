"""Multi-process start-up (port of ``audiossl_tpu.parallel.launch``).

The reference spawns one process per GPU and meets over NCCL with a TCP or
file rendezvous, or the SLURM environment (SURVEY.md §2.3); the JAX package
meets its hosts through ``jax.distributed.initialize``. The port runs one
process per card and calls ``torch.distributed.init_process_group`` once,
before any model is built. ``maybe_init_distributed()`` reads, in order:

* ``AUDIOSSL_COORDINATOR`` (host:port), ``AUDIOSSL_NUM_PROCESSES``,
  ``AUDIOSSL_PROCESS_ID`` (and ``AUDIOSSL_LOCAL_RANK``, default: the process
  id), as the JAX package does;
* SLURM's ``SLURM_NTASKS`` > 1, ``SLURM_PROCID``, ``SLURM_LOCALID`` and the
  first node of ``SLURM_JOB_NODELIST`` at ``AUDIOSSL_PORT`` (12357);
* torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``, which take the place of the TPU pod metadata.

Each process takes the card ``cuda:<local rank>``. The backend is an
argument: NCCL for CUDA, gloo for the CPU, chosen from the device the caller
asked for. The JAX module's ``setup_compilation_cache`` has no counterpart:
the port's compiled artefacts are its kernel libraries, which
``kernels.py`` already caches under ``.torch_build/`` by a hash of their
sources.
"""
from __future__ import annotations

import logging
import os
from typing import Mapping

import torch
import torch.distributed as tdist

from audiossl_tpu_torch.parallel import dist

log = logging.getLogger("audiossl_tpu_torch.launch")


def launch_env(env: Mapping[str, str] | None = None) -> dict | None:
    """The rendezvous a launcher left in ``env`` (``os.environ`` by
    default): {"init_method", "world_size", "rank", "local_rank", "source"},
    or None for a single-process run."""
    env = os.environ if env is None else env
    if env.get("AUDIOSSL_COORDINATOR"):
        rank = int(env["AUDIOSSL_PROCESS_ID"])
        return {"init_method": f"tcp://{env['AUDIOSSL_COORDINATOR']}",
                "world_size": int(env["AUDIOSSL_NUM_PROCESSES"]), "rank": rank,
                "local_rank": int(env.get("AUDIOSSL_LOCAL_RANK", rank)), "source": "AUDIOSSL_* env"}
    if env.get("SLURM_NTASKS") and int(env["SLURM_NTASKS"]) > 1:
        nodelist = env.get("SLURM_JOB_NODELIST", "")
        first = nodelist.split(",")[0].replace("[", "").split("-")[0] if nodelist else "localhost"
        port = int(env.get("AUDIOSSL_PORT", 12357))
        return {"init_method": f"tcp://{first}:{port}", "world_size": int(env["SLURM_NTASKS"]),
                "rank": int(env["SLURM_PROCID"]), "local_rank": int(env.get("SLURM_LOCALID", 0)),
                "source": "SLURM env"}
    if env.get("WORLD_SIZE") and env.get("RANK") is not None and env.get("MASTER_ADDR"):
        return {"init_method": f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
                "world_size": int(env["WORLD_SIZE"]), "rank": int(env["RANK"]),
                "local_rank": int(env.get("LOCAL_RANK", 0)), "source": "torchrun env"}
    return None


def backend_for(device: str | torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_init_distributed(device: str | torch.device = "cuda", backend: str | None = None,
                           env: Mapping[str, str] | None = None) -> bool:
    """Join the process group a launcher describes in the environment; True
    if this process is now in one. On CUDA it first takes ``cuda:<local
    rank>`` as its device. A group that is already up is kept."""
    if tdist.is_initialized():
        return True
    spec = launch_env(env)
    if spec is None:
        return False
    backend = backend or backend_for(device)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(spec["local_rank"])
    tdist.init_process_group(backend, init_method=spec["init_method"], world_size=spec["world_size"],
                             rank=spec["rank"])
    log.info("torch.distributed (%s) initialized from %s: rank %d of %d", backend, spec["source"],
             spec["rank"], spec["world_size"])
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) with no process group."""
    return dist.rank(), dist.world()
