"""The harness's process loads neither JAX nor the JAX package, compared by
whole top-level names (``audiossl_tpu_torch`` begins with
``audiossl_tpu``), and a run without a card gives no result."""
import os
import subprocess
import sys

from portbench.harness import report, spec

CHECK = """
import importlib, pkgutil, sys
import portbench
from portbench.harness import report
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from portbench.harness import spec
for w in spec.load_benchmark()["workloads"]:
    run = importlib.import_module("portbench.loops." + spec.load_cell(w["name"]).loop)
import audiossl_tpu_torch.serve.export, audiossl_tpu_torch.downstream.probe, audiossl_tpu_torch.train.step
import audiossl_tpu_torch.objectives, audiossl_tpu_torch.data.augment
print(report.forbidden_modules())
"""


def test_no_jax_in_the_harness_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=spec.ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_whole_names_are_compared():
    sys.modules.setdefault("audiossl_tpu_torch_like", sys)  # a name that only begins with the package's
    try:
        assert "audiossl_tpu_torch_like" not in report.forbidden_modules()
    finally:
        del sys.modules["audiossl_tpu_torch_like"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mast_b.ssmast_b256", "--seed", "1",
                          "--seconds", "1"], cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
