"""A cell of several processes: rank 0 starts the others, gathers their
results and merges them into one; and the traced run counts its set-up's
steps, not the window's."""

from __future__ import annotations

import json
import math
import sys

import pytest
import torch

from gnnbench import check, run
from gnnbench.tests.conftest import tiny_cell


def _out(rank, correct=True, peak=100, busy=None, metrics=None, gap=0.0):
    out = {"correct": correct, "attempted": 5, "failed": 0,
           "metrics": metrics or {},
           "device": {"platform": "gpu", "kind": "card", "count": 4,
                      "memory_peak_bytes": peak},
           "rank_mark": rank}
    if busy is not None:
        out["device"].update(busy_s=busy, window_s=10.0)
        out["breakdown"] = {"device_ops": [], "idle_gaps": []}
    out["checks"] = {"loss1_gap": [gap, 1e-3], "count_gap": [0.0, 0.0]}
    return out


def test_merge_of_one_is_itself():
    one = _out(0)
    assert run.merge([one]) is one


def test_merge_untraced_takes_the_fullest_card_and_the_worst_check():
    m = {"train_seeds_per_s": {"value": 10.0, "unit": "seeds/s"},
         "peak_mem_gib": {"value": 1.0, "unit": "GiB"}}
    m2 = {"train_seeds_per_s": {"value": 99.0, "unit": "seeds/s"},
          "peak_mem_gib": {"value": 3.0, "unit": "GiB"}}
    out = run.merge([_out(0, peak=100, metrics=m, gap=1e-4),
                     _out(1, peak=300, metrics=m2, gap=2e-3)])
    assert out["rank_mark"] == 0
    assert out["device"]["memory_peak_bytes"] == 300
    assert out["metrics"]["peak_mem_gib"]["value"] == 3.0
    assert out["metrics"]["train_seeds_per_s"]["value"] == 10.0
    assert out["checks"]["loss1_gap"] == [2e-3, 1e-3]
    assert out["correct"]
    assert list(out)[-1] == "checks"


def test_merge_traced_averages_and_any_rank_fails_it():
    a = {"device_idle_pct": {"value": 10.0, "unit": "%"}}
    b = {"device_idle_pct": {"value": 30.0, "unit": "%"}}
    out = run.merge([_out(0, busy=8.0, metrics=a),
                     _out(1, correct=False, busy=6.0, metrics=b)])
    assert out["metrics"]["device_idle_pct"]["value"] == 20.0
    assert out["device"]["busy_s"] == 7.0
    assert not out["correct"]


def test_merge_counts_a_missing_check_as_failed():
    a, b = _out(0), _out(1)
    del b["checks"]["loss1_gap"]
    out = run.merge([a, b])
    assert math.isinf(out["checks"]["loss1_gap"][0])


def _child(obj, code=0, noise="a line of output"):
    return [sys.executable, "-c",
            f"import sys; print({noise!r}); print({noise!r}, "
            f"file=sys.stderr); print({json.dumps(json.dumps(obj))}); "
            f"sys.exit({code})"]


def test_gather_reads_each_rank_last_line(capsys):
    kids = run.spawn({1: _child({"rank": 1}), 2: _child({"rank": 2})})
    outs = run.gather(kids, timeout=60)
    assert [o["rank"] for o in outs] == [1, 2]
    assert all(k.proc.returncode == 0 for k in kids)
    assert "[rank 2] a line of output" in capsys.readouterr().err


def test_gather_fails_on_a_failed_rank_and_stops_the_rest():
    slow = [sys.executable, "-c", "import time; time.sleep(60)"]
    kids = run.spawn({1: _child({}, code=1), 2: slow})
    with pytest.raises(RuntimeError):
        run.gather(kids, timeout=0.5)
    run.stop(kids)
    assert all(k.proc.poll() is not None for k in kids)


def test_traced_run_counts_the_set_up_steps_not_the_window():
    cell = tiny_cell("sage-quiver-b4096")
    out = run.run_cell(cell, 2**31 + 11, 0.3, True, torch.device("cpu"),
                       check.load_limits(cell.name))
    assert out["correct"], out["checks"]
    assert out["counted"]["steps"] == int(cell.traffic["warmup_steps"])
    ranges = {name for name, _ in out["breakdown"]["idle_gaps"]}
    assert "gnnbench.launch" in ranges
    assert "gnnbench.count" not in ranges
