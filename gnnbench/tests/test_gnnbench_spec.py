"""Every configuration, traffic mix, per-layer metric and cell of
``BENCHMARK.json`` loads and resolves by name."""

from __future__ import annotations

import json
import re

import pytest

from gnnbench import check, spec
from gnnbench.tests.conftest import workloads

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = spec.load_benchmark()


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_resolves(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = spec.load_json("configs", config)
    from gnnbench import models

    assert models.load(data).param_shapes(data)
    assert entry["file"] == f"gnnbench/configs/{config}.json"
    assert data["name"] == config and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert config in used


@pytest.mark.parametrize("workload", workloads())
def test_cell_resolves(workload):
    cell = spec.cell(workload)
    assert cell.driver().Program is not None
    assert cell.config["model"] in ("sage", "gat")
    limits = check.load_limits(workload)
    assert set(limits) <= set(check.NUMBERS)
    assert {"loss1_gap", "grad1_out_gap", "change_gap", "sample_violations",
            "count_gap"} <= set(limits)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_returns_none_without_data(metric):
    from gnnbench.trace import Trace

    empty = {"trace": Trace(1.0, 0.0, {}, {}), "window_s": 1.0,
             "steps": 0, "seeds": 0, "intervals_ms": [], "launch_s": [],
             "sample_wait_s": [], "flops": 0.0, "kernel_bound_s": {},
             "kernels": {"gat_attention": ("x",),
                         "dense_gather_sum": ("x",),
                         "device_sample": ("x",)},
             "peak_flops": 1.0, "stats": {}}
    assert spec.reader(metric)(empty) is None


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_states_the_form_the_port_builds(config):
    from gnnbench import models

    data = spec.load_json("configs", config)
    model = models.load(data)
    assert set(model.FORM) <= set(data["reduced"])
    key = sorted(model.FORM)[0]
    with pytest.raises(ValueError):
        models.load({**data, key: data["source_values"][key]})
