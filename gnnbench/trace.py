"""Reading a profiler trace of the whole measured window.

The arithmetic of the port's ``utils/profile.summarize_step`` (the union
of the device's kernel, copy and set intervals), applied to the whole
traced window, which the harness marks with the range ``WINDOW``, rather
than to one step. Besides the busy time it gives each device operation's
time and calls, and the device's idle time by what the host was doing
meanwhile: each idle stretch is split by the innermost named range the
host's main thread was in (the harness's own ranges and the port's
``record_function`` ranges).
"""

from __future__ import annotations

import dataclasses

WINDOW = "gnnbench.window"
OUTSIDE = "outside any range"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: dict          # device op name -> [seconds, calls]
    gaps: dict         # host range name -> idle seconds

    def op_seconds(self, *needles: str) -> tuple[float, int]:
        """Seconds and calls of the device ops whose name holds any of
        ``needles``."""
        s = n = 0
        for name, (sec, calls) in self.ops.items():
            if any(k in name for k in needles):
                s += sec
                n += calls
        return s, n

    def top_ops(self, k: int = 10) -> list:
        return [[n, v[0]] for n, v in sorted(self.ops.items(),
                                              key=lambda kv: -kv[1][0])[:k]]

    def top_gaps(self, k: int = 10) -> list:
        return [[n, v] for n, v in sorted(self.gaps.items(),
                                           key=lambda kv: -kv[1])[:k]]


def union_ns(intervals) -> tuple[int, list]:
    """Total length of the union of ``(start, end)`` intervals, and the
    merged intervals in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def segments(ranges, w0: int, w1: int) -> list:
    """The window cut into ``(start, end, name)`` pieces, each named by the
    innermost of the properly nested ``ranges`` ``(start, end, name)``
    that holds it, or ``OUTSIDE``."""
    events = []
    for a, b, name in ranges:
        events.append((a, 1, -b, name))
        events.append((b, 0, 0, name))
    events.sort()
    out, stack, at = [], [], w0
    for t, opening, _, name in events:
        t = min(max(t, w0), w1)
        if t > at:
            out.append((at, t, stack[-1] if stack else OUTSIDE))
            at = t
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if w1 > at:
        out.append((at, w1, stack[-1] if stack else OUTSIDE))
    return out


def overlaps(idle, pieces) -> list:
    """The parts of the sorted, disjoint ``idle`` intervals that each of
    the sorted, disjoint named ``pieces`` covers: ``(start, end, name)``."""
    out, j = [], 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out.append((lo, hi, pieces[k][2]))
            k += 1
    return out


def summarize(device_events, host_ranges) -> Trace:
    """``device_events``: ``(name, start_ns, end_ns)`` of every kernel,
    copy and set; ``host_ranges``: ``(name, thread, start_ns, end_ns)`` of
    the host's named ranges, among them one ``WINDOW``."""
    wins = [r for r in host_ranges if r[0] == WINDOW]
    if len(wins) != 1:
        raise RuntimeError(f"the trace holds {len(wins)} windows, not one")
    _, main_thread, w0, w1 = wins[0]
    clipped = [(n, max(a, w0), min(b, w1)) for n, a, b in device_events]
    clipped = [c for c in clipped if c[2] > c[1]]
    busy, merged = union_ns((a, b) for _, a, b in clipped)
    ops: dict = {}
    for name, a, b in clipped:
        entry = ops.setdefault(name, [0.0, 0])
        entry[0] += (b - a) / 1e9
        entry[1] += 1
    mine = [(a, b, name) for name, thread, a, b in host_ranges
            if thread == main_thread and name != WINDOW]
    gaps: dict = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    for a, b, name in overlaps(idle, segments(mine, w0, w1)):
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    return Trace((w1 - w0) / 1e9, busy / 1e9, ops, gaps)


def from_profiler(prof) -> Trace:
    """The ``Trace`` of a ``torch.profiler.profile`` run that recorded the
    CPU and CUDA activities, read from its raw events."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), start, end))
        elif e.is_user_annotation():
            host.append((e.name(), e.start_thread_id(), start, end))
    return summarize(device, host)
