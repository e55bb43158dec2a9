"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, which ctypes loads; wrappers pass tensor pointers
and PyTorch's current stream as integers. Libraries go to ``.torch_build/``
at the repo root, named by a hash of the source and flags, and are built at
first use (``load``). Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess

log = logging.getLogger(__name__)

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".torch_build")
SOURCES = {"log_mel": "log_mel.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, else PATH, else /usr/local/cuda/bin."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] if os.environ.get("CUDA_HOME") else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, compiled first if it is not
    built yet (the compiler's output, ptxas's register and spill report
    included, is logged at INFO). Raises RuntimeError with that output if
    nvcc fails."""
    if name not in _loaded:
        path = library_path(name)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"CUDA kernel build of {SOURCES[name]} failed (nvcc exit {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, path)
            log.info("built %s:\n%s", SOURCES[name], proc.stdout.strip())
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
