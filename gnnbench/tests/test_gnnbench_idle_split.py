"""The device's idle time split by layer (``idle``; the metrics
``step_idle_ms``, ``feed_idle_ms`` and ``loop_idle_ms``) on a fixed
trace: each reads its own ranges' gaps, the three sum to the idle time
per step, and a trace with the harness's ranges alone reads all its idle
as the loop's."""

from __future__ import annotations

import pytest

from gnnbench import spec
from gnnbench.trace import OUTSIDE, Trace

METRICS = ("step_idle_ms", "feed_idle_ms", "loop_idle_ms")


def _record(gaps: dict, steps: int = 4, window_s: float = 2.0) -> dict:
    busy = window_s - sum(gaps.values())
    return {"trace": Trace(window_s, busy, {}, gaps), "steps": steps}


def _read(record) -> dict:
    return {m: spec.reader(m)(record) for m in METRICS}


def _idle_per_step_ms(record) -> float:
    tr = record["trace"]
    return 1e3 * (tr.window_s - tr.busy_s) / record["steps"]


def test_each_layer_reads_its_own_ranges():
    record = _record({"occ.step": 0.01, "occ.step.backward": 0.02,
                      "quiver_draw": 0.004, "Optimizer.step#Adam.step": 0.002,
                      "occ.feed.wait": 0.03, "occ.feed.copy": 0.005,
                      "occ.feed.submit": 0.001, "gnnbench.launch": 0.006,
                      "gnnbench.sample_wait": 0.002, OUTSIDE: 0.008})
    got = _read(record)
    assert got["step_idle_ms"] == pytest.approx(1e3 * 0.036 / 4)
    assert got["feed_idle_ms"] == pytest.approx(1e3 * 0.036 / 4)
    assert got["loop_idle_ms"] == pytest.approx(1e3 * 0.016 / 4)
    assert sum(got.values()) == pytest.approx(_idle_per_step_ms(record))


def test_harness_ranges_alone_are_all_loop():
    record = _record({"gnnbench.launch": 0.5, "gnnbench.sample_wait": 0.25,
                      OUTSIDE: 0.125}, steps=10)
    got = _read(record)
    assert got["step_idle_ms"] == 0.0 and got["feed_idle_ms"] == 0.0
    assert got["loop_idle_ms"] == pytest.approx(_idle_per_step_ms(record))


def test_a_name_is_matched_by_its_prefix_not_a_substring():
    record = _record({"my.occ.feed.wait": 0.01, "occ.feedback": 0.02,
                      "xgnnbench.launch": 0.04}, steps=1)
    got = _read(record)
    assert got == pytest.approx({"step_idle_ms": 70.0, "feed_idle_ms": 0.0,
                                 "loop_idle_ms": 0.0})


@pytest.mark.parametrize("metric", METRICS)
def test_no_trace_or_no_step_reads_none(metric):
    read = spec.reader(metric)
    assert read({"trace": None, "steps": 3}) is None
    assert read(_record({"occ.step": 0.1}, steps=0)) is None
