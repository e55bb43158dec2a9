"""ctypes binding of the native batch WAV loader (port of ``audiossl_tpu.data.native``).

The source is the port's own copy, ``csrc/wavloader.cpp``. At first use it
is compiled with ``g++`` into ``.torch_build/`` at the repo root (the kernel
libraries' directory), as ``libwavloader-<hash of the source and flags>.so``.
One process builds it: the build holds an exclusive ``flock`` on the build
directory, and a process that waits for the lock finds the library built
when it gets it. The library is written to a temporary name and
renamed, so a ``.so`` on disk is always whole. When ``g++`` is not installed,
``available()`` is False and the loaders decode with NumPy, as the JAX package
falls back: every process of the host then does the same, and a warning says
so. A build or a load that fails where ``g++`` is installed raises: the
NumPy path draws other windows than the native one, so a process that fell
back alone would read other clips than its peers (``native=False`` asks every
loader for NumPy).

``load_batch`` decodes, resamples and windows a batch on a C++ thread pool;
its window starts come from a per-batch seed, so its batches equal the JAX
native path's for that seed, not the NumPy path's draws.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading

import numpy as np

log = logging.getLogger("audiossl_tpu_torch.native")

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "wavloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".torch_build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the build puts (and looks for) the library of this source."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libwavloader-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """Compile the library to ``so`` under the build lock; a process that
    waited for the lock finds it built and returns."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd = os.open(BUILD_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if os.path.exists(so):
            return
        tmp = f"{so}.tmp{os.getpid()}"
        try:
            r = subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp], capture_output=True, text=True, timeout=600)
            if r.returncode:
                raise RuntimeError(f"g++ failed building {_SRC}:\n{r.stderr[-4000:]}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    finally:
        os.close(fd)  # releases the lock


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        if shutil.which("g++") is None:
            _tried = True
            log.warning("g++ is not installed: the native wavloader is unavailable and the loaders decode with NumPy")
            return None
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)  # an OSError here is a broken library, not a missing toolchain: it raises
        lib.avl_decode.restype = ctypes.c_int
        lib.avl_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.avl_load_batch2.restype = ctypes.c_int
        lib.avl_load_batch2.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def load_batch(
    paths: list[str], clip_samples: int, target_sr: int = 16000, seed: int = 0,
    n_threads: int = 8, on_error: str = "raise",
    offsets: list[int] | None = None, lengths: list[int] | None = None,
) -> np.ndarray | None:
    """Decode + window a batch natively -> [n, clip_samples] f32, or None
    without the library. ``offsets`` / ``lengths`` select byte ranges
    (tar-shard members, data/tar.py; length -1: to the end of the file).
    ``on_error='zeros'``: a failed clip stays silence (the C++ loader
    zero-fills it) and a warning names one failing file instead of raising."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, clip_samples), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    offs = (ctypes.c_longlong * n)(*offsets) if offsets is not None else None
    lens = (ctypes.c_longlong * n)(*lengths) if lengths is not None else None
    rc = lib.avl_load_batch2(
        arr, offs, lens, n, clip_samples, target_sr, ctypes.c_ulonglong(seed & (2**64 - 1)), n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        if on_error != "zeros":
            raise IOError(f"native loader failed on file index {-rc - 1}: {paths[-rc - 1]}")
        log.warning("bad audio file(s), substituting silence (e.g. %s)", paths[-rc - 1])
    return out


def decode(path: str, target_sr: int = 16000, max_seconds: float = 600.0) -> np.ndarray | None:
    """One whole file, decoded and resampled, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    cap = int(max_seconds * target_sr)
    out = np.empty(cap, np.float32)
    n = lib.avl_decode(path.encode(), target_sr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
    if n < 0:
        raise IOError(f"native decode failed ({n}) for {path}")
    return out[:n].copy()
