"""The port stands alone and never falls back silently: no file of
audiossl_tpu_torch/ (nor chip_smoke.py) imports jax, flax or the JAX
package, importing it loads none of them, and without a CUDA device every
entry point that asks for the card raises instead of running on the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "audiossl_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "audiossl_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [
        (os.path.relpath(p, ROOT), m)
        for p in files
        for m in _imports(p)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = [
        "audiossl_tpu_torch." + os.path.relpath(p, os.path.join(ROOT, "audiossl_tpu_torch"))[:-3].replace(os.sep, ".")
        for p in _port_files()
        if p.endswith(".py") and "audiossl_tpu_torch" in p and not p.endswith("__init__.py")
    ]
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")


def test_entry_points_raise_without_cuda(no_cuda):
    from audiossl_tpu_torch import resolve_device
    from audiossl_tpu_torch.frontend import FrontendSpec
    from audiossl_tpu_torch.models.audiontt import random_state_dict
    from audiossl_tpu_torch.serve.export import ServingEncoder, build_embedder

    sd = random_state_dict(64, 32, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_embedder(sd, FrontendSpec("logmel", 64, 16000), 6400)  # device defaults to cuda
    artifact = build_embedder(sd, FrontendSpec("logmel", 64, 16000), 6400, device="cpu").artifact()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEncoder(artifact)  # device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEncoder(artifact, device="cuda:0")


def test_kernel_requests_raise_without_the_card(no_cuda, tmp_path, monkeypatch):
    from audiossl_tpu_torch import kernels
    from audiossl_tpu_torch.frontend import fused_stft

    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_stft.log_mel_fused(torch.empty((2, 6400), device="meta"))
    # the CUDA path builds its library first; with no nvcc that raises
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load("log_mel")
