"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, which ctypes loads; wrappers pass tensor pointers
and PyTorch's current stream as integers. Libraries go to ``.torch_build/``
at the repo root, named by a hash of the source, the local headers it
includes (``#include "..."``, followed recursively) and the flags, and are built at
first use (``load``), or all at once with one nvcc per source started
together (``load_all``). Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import time

log = logging.getLogger(__name__)

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".torch_build")
SOURCES = {
    "log_mel": "log_mel.cu", "block1": "block1.cu", "fused_rows": "fused_rows.cu", "attention": "attention.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}

_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, else PATH, else /usr/local/cuda/bin."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] if os.environ.get("CUDA_HOME") else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels cannot be built")


def _source_files(src: str) -> list[str]:
    """``src`` and every local header it includes, recursively, each once,
    in the order first met (a quoted include resolves beside its includer)."""
    files, todo = [], [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        with open(path) as f:
            todo += [os.path.abspath(os.path.join(os.path.dirname(path), inc)) for inc in _INCLUDE.findall(f.read())]
    return files


def library_path(name: str) -> str:
    """Where kernel ``name``'s library is built: named by a hash of its
    source, its local headers and the nvcc flags, so that an edit to any of
    them builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_files(os.path.join(CSRC, SOURCES[name])):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str) -> tuple[subprocess.Popen, str, str]:
    path = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, path


def _finish_build(name: str, proc: subprocess.Popen, tmp: str, path: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build of {SOURCES[name]} failed (nvcc exit {proc.returncode}):\n{out}")
    os.replace(tmp, path)
    with open(f"{path}.log", "w") as f:
        f.write(out)
    log.info("built %s:\n%s", SOURCES[name], out.strip())


def build_log(name: str) -> str:
    """nvcc's output (ptxas's register and spill report) of the build of
    kernel ``name``'s current library, kept beside it; empty if not built."""
    path = f"{library_path(name)}.log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def ptxas_report(out: str) -> dict[str, dict[str, int]]:
    """{kernel (mangled name): {registers, stack, spill_stores, spill_loads}}
    from nvcc's ``-Xptxas -v`` output."""
    report: dict[str, dict[str, int]] = {}
    name = None
    for line in out.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            name = m.group(1)
            report[name] = {}
        elif name and (m := _PTXAS_FRAME.search(line)):
            report[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif name and (m := _PTXAS_REGS.search(line)):
            report[name]["registers"] = int(m.group(1))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, compiled first if it is not
    built yet (the compiler's output, ptxas's register and spill report
    included, is logged at INFO). Raises RuntimeError with that output if
    nvcc fails."""
    if name not in _loaded:
        path = library_path(name)
        if not os.path.exists(path):
            _finish_build(name, *_start_build(name))
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]


def load_all() -> dict[str, float]:
    """Build every source not built yet, one nvcc each, all started together,
    then load them all. Returns the seconds from the start until each
    source's library was ready (0 for one already built)."""
    t0 = time.perf_counter()
    builds = {name: _start_build(name) for name in SOURCES if not os.path.exists(library_path(name))}
    seconds = {name: 0.0 for name in SOURCES}
    failed = []
    for name, build in builds.items():  # wait for every nvcc before raising for any
        try:
            _finish_build(name, *build)
        except RuntimeError as e:
            failed.append(str(e))
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in SOURCES:
        load(name)
    return seconds
