"""The profile reader's attribution of device kernels to named ranges
(``utils/profile.attribute_kernels``), on made-up intervals: each kernel
goes to the innermost range on its launch's thread whose host interval
holds the launch, and counts for the ranges holding that one. A kernel
launched through ctypes is a launch like any other here, so the ranges
of the on-device samplers count their kernels."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from occ_gnn_tpu_torch.utils.profile import (
    NAMED_RANGES,
    attribute_kernels,
    summarize_step,
)

MAIN, AUTOGRAD = 1, 2


def test_nested_ranges_count_their_own_and_inner_kernels():
    ranges = [("train_step", MAIN, 0, 100),
              ("synthesize_device_innermost", MAIN, 10, 20),
              ("local_aggregate_dense", MAIN, 30, 60),
              ("quiver_gather", MAIN, 40, 50)]
    launches = {1: (MAIN, 12), 2: (MAIN, 45), 3: (MAIN, 35), 4: (MAIN, 80)}
    kernels = [(1, 3.0), (2, 5.0), (3, 7.0), (4, 11.0)]
    got = attribute_kernels(ranges, launches, kernels)
    assert got == {"train_step": 26.0, "synthesize_device_innermost": 3.0,
                   "local_aggregate_dense": 12.0, "quiver_gather": 5.0}


@pytest.mark.parametrize("at, want", [
    (10, {"outer": 2.0, "inner": 2.0}),   # the inner range's start
    (20, {"outer": 2.0, "inner": 2.0}),   # its end
    (21, {"outer": 2.0}),                 # just past it
    (0, {"outer": 2.0}),                  # the outer range's start
    (100, {"outer": 2.0}),                # its end
    (101, {}),                            # outside every range
])
def test_a_launch_at_a_range_edge(at, want):
    ranges = [("outer", MAIN, 0, 100), ("inner", MAIN, 10, 20)]
    assert attribute_kernels(ranges, {7: (MAIN, at)}, [(7, 2.0)]) == want


def test_kernels_without_a_range_or_a_launch_count_for_none():
    ranges = [("train_step", MAIN, 0, 10)]
    launches = {1: (MAIN, 50), 3: (MAIN, 5)}
    kernels = [(1, 4.0), (2, 8.0), (3, 1.0)]  # 2 has no launch event
    assert attribute_kernels(ranges, launches, kernels) == {"train_step": 1.0}


def test_the_launching_thread_decides():
    """A backward range on the autograd thread, while the main thread's
    step range is open: each launch goes to its own thread's range."""
    ranges = [("train_step", MAIN, 0, 100),
              ("_DenseAggregateBackward", AUTOGRAD, 40, 60)]
    launches = {1: (AUTOGRAD, 50), 2: (MAIN, 50), 3: (3, 50)}
    kernels = [(1, 2.0), (2, 3.0), (3, 4.0)]
    assert attribute_kernels(ranges, launches, kernels) == {
        "train_step": 3.0, "_DenseAggregateBackward": 2.0}


def test_summary_of_a_cpu_step_keeps_its_keys():
    """On the CPU no kernel runs: every named range that ran reads 0 ms of
    device time, with its calls counted."""
    out = {}
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: out.update(summarize_step(p))
                 ) as prof:
        for _ in range(2):
            with record_function("train_step"):
                with record_function("quiver_gather"):
                    torch.ones(8, 8).sum()
            prof.step()
    assert {"train_step", "quiver_gather"} <= set(NAMED_RANGES)
    assert out["named_ms"] == {"train_step": {"device_ms": 0.0, "calls": 1},
                               "quiver_gather": {"device_ms": 0.0,
                                                 "calls": 1}}
    assert out["ops_ms"] == {} and out["device_busy_ms"] == 0.0
