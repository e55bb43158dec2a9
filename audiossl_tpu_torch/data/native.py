"""ctypes binding of the native batch WAV loader (port of ``audiossl_tpu.data.native``).

The source is the port's own copy, ``csrc/wavloader.cpp``. At first use it
is compiled with ``g++`` into ``.torch_build/`` at the repo root (the kernel
libraries' directory), as ``libwavloader-<hash of the source and flags>.so``,
written to a temporary name and renamed, so that processes building at once
never load a half-written file. When ``g++`` is missing or the build or the
load fails, ``available()`` is False and the loaders decode with NumPy, as the
JAX package falls back; the reason is logged once.

``load_batch`` decodes, resamples and windows a batch on a C++ thread pool;
its window starts come from a per-batch seed, so its batches equal the JAX
native path's for that seed, not the NumPy path's draws.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
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


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp], check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except Exception as e:  # no toolchain, a read-only tree
        log.info("native wavloader build failed (%s); the loaders decode with NumPy", e)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            log.info("native wavloader load failed (%s); the loaders decode with NumPy", e)
            return None
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
