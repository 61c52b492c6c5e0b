"""The arithmetic of the end-to-end metrics and of the bounds."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile: the smallest value with at least
    ``q`` % of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(math.ceil(q / 100.0 * len(xs)), 1)
    return xs[rank - 1]


def intervals_ms(start_ms: float, done_ms) -> list[float]:
    """The intervals between consecutive step completions, the first from
    the window's start: ``done_ms`` are the completion times, in order."""
    out, last = [], start_ms
    for t in done_ms:
        out.append(t - last)
        last = t
    return out


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and the third quartile as a share
    of the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)
