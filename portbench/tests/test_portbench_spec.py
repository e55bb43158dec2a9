"""Every cell of BENCHMARK.json resolves to its files by name, and the
metrics it reports keep the benchmark's rules."""
import importlib
import os

import pytest

from portbench.harness import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.load_cell(name, bench=BENCH)
    assert importlib.import_module(f"portbench.loops.{cell.loop}").Loop
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {name} does not report"
        assert importlib.import_module(f"portbench.metrics.{m['name'].split('.', 1)[0]}").read
    # the configuration's encoder, its count and its stages, found by name
    kind = cell.config["encoder"].lower()
    assert importlib.import_module(f"portbench.reference.encoders.{kind}").forward
    assert importlib.import_module(f"portbench.counts.{kind}").clip_flops
    for st in cell.config["stages"]:
        assert importlib.import_module(f"portbench.reference.stages.{st['stage']}").output
        assert st["name"] in cell.limits, f"{name} has no limit for its stage {st['name']}"
    assert set(cell.config["precision"]) >= {"reference", "stage", "controls"} and cell.config["precision"]["controls"]


def test_files_are_named_from_names():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(spec.PKG, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(spec.PKG, "limits", f"{w['name']}.json"))


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".", 1)[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
