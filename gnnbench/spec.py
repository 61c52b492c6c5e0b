"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); its traffic's ``mode`` names its driver
(``drivers/<mode>.py``) and its configuration's ``model`` the reference's
equations (``reference/<model>.py``); each metric that applies to the
cell has, if per-layer, its reader (``metrics/<name>.py``, or that of the
quantity before the name's first dot); the cell's
correctness limits are ``limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    def driver(self):
        return importlib.import_module(
            f"gnnbench.drivers.{self.traffic['mode']}")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json("configs", w["config"]),
                traffic=load_json("traffic", w["traffic"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def reader(metric: str):
    """The ``read(record)`` of a per-layer metric's file: ``metrics/
    <metric>.py``, or else that of the quantity it names before its first
    dot (``mfu_pct.<cells>`` is ``mfu_pct`` in the cells it names)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "gnnbench_metric_" + path.stem.replace(".", "_"), path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for {metric} in {path.parent}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
