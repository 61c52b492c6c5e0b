"""The percentile and rate arithmetic, and the trace's union and idle
attribution."""

from __future__ import annotations

import pytest

from gnnbench import stats, trace


def test_stalled_step_sets_the_tail():
    done = [10.0 * (i + 1) for i in range(40)]
    done[30:] = [t + 500.0 for t in done[30:]]   # step 31 stalls 500 ms
    iv = stats.intervals_ms(0.0, done)
    assert len(iv) == 40 and max(iv) == pytest.approx(510.0)
    assert stats.percentile(iv, 95) == pytest.approx(10.0)
    # three stalls of 40 intervals reach the 95th percentile's rank, 38
    done[35:] = [t + 300.0 for t in done[35:]]
    done[38:] = [t + 400.0 for t in done[38:]]
    iv = stats.intervals_ms(0.0, done)
    assert stats.percentile(iv, 95) == pytest.approx(310.0)
    assert stats.percentile(iv, 100) == pytest.approx(510.0)


def test_rate_counts_all_steps_and_time():
    assert stats.rate(10 * 4096, 2.0) == 20480.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_trace_union_and_gaps():
    host = [(trace.WINDOW, 1, 0, 100), ("a", 1, 10, 40), ("b", 1, 20, 30),
            ("c", 1, 50, 90), ("other thread", 2, 0, 100)]
    device = [("k1", 0, 5), ("k2", 25, 28), ("k1", 60, 95), ("k1", 90, 120)]
    t = trace.summarize(device, host)
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx(48e-9)
    assert t.ops["k1"][1] == 3 and t.op_seconds("k")[1] == 4
    gaps = {k: v * 1e9 for k, v in t.gaps.items()}
    assert gaps == pytest.approx({trace.OUTSIDE: 15.0, "a": 20.0, "b": 7.0,
                                  "c": 10.0})
    assert sum(gaps.values()) == pytest.approx(52.0)
