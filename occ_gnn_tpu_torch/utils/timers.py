"""Spans and accumulating phase timers.

``span(name)`` marks a stretch of the port's host code as a named range
of a ``torch.profiler`` trace: a ``record_function`` range, stamped on the
profiler's clock (unix-epoch nanoseconds, the clock of the device
activity it records), so a span lies on one time line with the kernels
and copies it launched. With no profiler running a span costs one check
of the profiler's state and opens nothing. A span never stays open across
a generator's ``yield``: the trace's readers rely on properly nested
ranges on each thread.

Named phases accumulate wall-clock across an epoch and print a one-line
summary (the reference's enum-indexed timers). Each phase is also a span.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_NOTHING = nullcontext()


def span(name: str):
    """A context manager: a ``record_function(name)`` range while a
    profiler runs, else nothing."""
    if _profiler_enabled():
        return record_function(name)
    return _NOTHING


class PhaseTimers:
    def __init__(self):
        self.totals = defaultdict(float)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with span(name):
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0

    def clear(self):
        self.totals.clear()

    def summary(self) -> str:
        return " ".join(f"{k}={v:.3f}s" for k, v in sorted(self.totals.items()))

    def as_dict(self) -> dict:
        return dict(self.totals)
