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


def _code_strings(path):
    """The string constants of a file's code, its docstrings left out."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and node.body
            and isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_package_file_names_a_path_under_the_jax_package():
    """The port reads nothing under audiossl_tpu/: no string its code builds
    a path from is, or runs through, that directory (the native loader
    builds its own csrc/wavloader.cpp into .torch_build/, never beside the
    JAX package's copy); nor does the code import anything of it
    (test_no_file_imports_jax_or_the_jax_package). The scan sees
    every package file."""
    files = [p for p in _port_files() if os.sep + "audiossl_tpu_torch" + os.sep in p]
    assert os.path.join(ROOT, "audiossl_tpu_torch", "data", "native.py") in files
    bad = [(os.path.relpath(p, ROOT), v) for p in files for v in _code_strings(p)
           if v.strip("/") == "audiossl_tpu" or "audiossl_tpu/" in v or "audiossl_tpu\\" in v or "_native" in v]
    assert not bad, bad


def test_clustering_family_is_scanned_and_needs_no_sklearn():
    """The clustering family's modules are among the scanned files, and
    none of them (nor the metrics) imports sklearn, which the card's machine
    need not have: ``utils.metrics.nmi`` is numpy."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    family = [os.path.join("audiossl_tpu_torch", m) for m in (
        "objectives/clustering.py", "objectives/decar.py", "objectives/dino.py", "objectives/make_pseudo_labels.py",
        "train/decar_loop.py", "train/deepcluster_loop.py", "utils/metrics.py")]
    assert set(family) <= files, set(family) - files
    bad = [(p, m) for p in family for m in _imports(os.path.join(ROOT, p)) if m.split(".")[0] == "sklearn"]
    assert not bad, bad


def test_parallelism_library_modules_are_scanned():
    """The pipeline, pipelined AST, MoE, ring and sequence-parallel modules
    are among the scanned files (so none of them imports JAX), and each
    port file of the slice names its JAX counterpart, which exists."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    family = ["parallel/pipeline.py", "parallel/pipeline_ast.py", "parallel/moe.py", "parallel/ring.py",
              "frontend/sp.py"]
    assert {os.path.join("audiossl_tpu_torch", m) for m in family} <= files
    for m in family:
        assert os.path.exists(os.path.join(ROOT, "audiossl_tpu", m)), m
        with open(os.path.join(ROOT, "audiossl_tpu_torch", m)) as f:
            assert "audiossl_tpu." + m[:-3].replace("/", ".") in f.read(), m


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


def test_fbank_serving_and_feature_extraction_raise_without_cuda(no_cuda, tmp_path):
    """The fbank serving path and the feature-extraction CLI ask for the
    card by default too."""
    from audiossl_tpu_torch.downstream.extract_features import main as extract_main
    from audiossl_tpu_torch.frontend import FrontendSpec
    from audiossl_tpu_torch.serve.export import build_embedder, seeded_state_dict

    spec = FrontendSpec("fbank", 64, 16000, target_length=96)
    sd = seeded_state_dict("MAST", "tiny", 64, 96, 0, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_embedder(sd, spec, 16000, encoder_type="MAST", model_size="tiny")
    assert build_embedder(sd, spec, 16000, device="cpu", encoder_type="MAST", model_size="tiny").n_frames == 96
    csv = tmp_path / "m.csv"
    csv.write_text("AudioPath\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_main(["--csv", str(csv), "--out", str(tmp_path / "out")])


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


def test_trainer_raises_without_cuda_unless_given_cpu(no_cuda, tmp_path):
    from audiossl_tpu_torch.config import load_config
    from audiossl_tpu_torch.train.loop import train_upstream
    from audiossl_tpu_torch.train_upstream import main

    csv = tmp_path / "m.csv"
    csv.write_text("files\n")
    config = load_config(os.path.join(ROOT, "configs", "delores_s.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_upstream(config, str(csv), "delores_s")  # device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--upstream", "delores_s", "--input", str(csv)])
    config["run"].update(save_path=str(tmp_path / "run"), epochs=1)
    config["pretrain"]["base_encoder"]["output_dim"] = config["pretrain"]["projection_dim"] = 32
    _, step, _ = train_upstream(config, str(csv), "delores_s", device="cpu")  # an empty manifest: no step
    assert step == 0


def test_ssmast_trainer_raises_without_cuda_unless_given_cpu(no_cuda, tmp_path):
    from audiossl_tpu_torch.config import load_config
    from audiossl_tpu_torch.train.loop import train_upstream
    from audiossl_tpu_torch.train_upstream import main

    csv = tmp_path / "m.csv"
    csv.write_text("files\n")
    config = load_config(os.path.join(ROOT, "configs", "ssmast.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_upstream(config, str(csv), "ssmast")  # device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--upstream", "ssmast", "--input", str(csv)])
    config["run"].update(save_path=str(tmp_path / "run"), epochs=1)
    config["pretrain"].update(model_size="tiny", num_negatives=64)
    config["pretrain"]["input"].update(n_mels=64, target_length=96)
    _, step, _ = train_upstream(config, str(csv), "ssmast", device="cpu")  # an empty manifest: no step
    assert step == 0 and config["pretrain"]["steps_per_epoch"] == 1000  # the caller's config is not changed


@pytest.mark.parametrize("name", ["delores_m", "slicer", "unfused"])
def test_audiontt_objective_trainers_raise_without_cuda_unless_given_cpu(no_cuda, tmp_path, name):
    """DeLoRes-M (the CLI's default upstream), SLICER and UnFuSeD ask for the card too."""
    from audiossl_tpu_torch.config import load_config
    from audiossl_tpu_torch.train.loop import train_upstream
    from audiossl_tpu_torch.train_upstream import main

    csv = tmp_path / "m.csv"
    csv.write_text("files,label\n")
    config = load_config(os.path.join(ROOT, "configs", f"{name}.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_upstream(config, str(csv), name)  # device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--input", str(csv)] + ([] if name == "delores_m" else ["--upstream", name]))
    config["run"].update(save_path=str(tmp_path / "run"), epochs=1)
    config["pretrain"]["base_encoder"]["output_dim"] = 32
    config["pretrain"].update(num_negatives=64, task_label=3)
    _, step, _ = train_upstream(config, str(csv), name, device="cpu")  # an empty manifest: no step
    assert step == 0


def test_finetune_modules_are_scanned_and_need_no_sklearn():
    """The supervised fine-tune's modules are among the scanned files and
    import no sklearn (mAP, AUC and d' are numpy and scipy)."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    family = [os.path.join("audiossl_tpu_torch", m) for m in (
        "data/multilabel.py", "data/norm_stats.py", "train/accum.py", "train/finetune_mast.py",
        "train/layer_decay.py", "train/preemption.py", "utils/metrics.py")]
    assert set(family) <= files, set(family) - files
    bad = [(p, m) for p in family for m in _imports(os.path.join(ROOT, p)) if m.split(".")[0] == "sklearn"]
    assert not bad, bad


def test_finetune_and_norm_stats_raise_without_cuda_unless_given_cpu(no_cuda, tmp_path):
    from audiossl_tpu_torch.config import load_config
    from audiossl_tpu_torch.data.norm_stats import main as norm_stats_main
    from audiossl_tpu_torch.train.finetune_mast import main as finetune_main
    from audiossl_tpu_torch.train.finetune_mast import train_finetune_mast

    (tmp_path / "labels.csv").write_text("index,mid,display_name\n0,/m/0,a\n")
    (tmp_path / "d.json").write_text('{"data": []}')
    csv = tmp_path / "m.csv"
    csv.write_text("files\n")
    args = (str(tmp_path / "d.json"), str(tmp_path / "labels.csv"))
    config = load_config(os.path.join(ROOT, "configs", "mast_ft.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_finetune_mast(config, *args)  # device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune_main(["--train_json", args[0], "--label_csv", args[1]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        norm_stats_main(["--csv", str(csv), "--fbank"])
    config["run"].update(save_path=str(tmp_path / "ft"), epochs=1)
    config["finetune"]["model_size"] = "tiny"
    config["finetune"]["input"].update(n_mels=64, target_length=48)
    _, stats, _ = train_finetune_mast(config, *args, device="cpu")  # an empty datafile: no step
    assert stats["epoch"] == 0 and config["run"]["epochs"] == 1
