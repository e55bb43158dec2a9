"""A cell of ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix. Its configuration is
``configs/<config>.json``, its mix ``traffic/<mix>.json`` (whose ``loop``
is a module of ``loops/``), the limits of its output check
``limits/<cell>.json``; its metrics are those of ``BENCHMARK.json`` whose
``workloads`` list it, or that have no such list.
"""
from __future__ import annotations

import dataclasses
import json
import os

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def loop(self) -> str:
        return self.traffic["loop"]


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: str = ROOT) -> dict:
    return _read(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read(os.path.join(PKG, "traffic", f"{w['traffic']}.json"))
    limits = _read(os.path.join(PKG, "limits", f"{name}.json"))
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])
