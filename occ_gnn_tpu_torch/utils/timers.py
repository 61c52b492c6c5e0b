"""Accumulating phase timers.

Named phases accumulate wall-clock across an epoch and print a one-line
summary (the reference's enum-indexed timers). Each phase is also a
``torch.profiler.record_function`` range, so a profiler trace carries the
phase labels.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

from torch.profiler import record_function


class PhaseTimers:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with record_function(name):
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def clear(self):
        self.totals.clear()
        self.counts.clear()

    def summary(self) -> str:
        return " ".join(f"{k}={v:.3f}s" for k, v in sorted(self.totals.items()))

    def as_dict(self) -> dict:
        return dict(self.totals)
