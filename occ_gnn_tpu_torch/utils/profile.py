"""Device-time summary of one profiled training step.

``train_split --profile-dir`` records one steady step with
``torch.profiler`` (the window runs from the launch of that step to the
launch of the next, by which time the lag-1 pipeline has waited for the
step to finish); ``chip_smoke.py`` records one quiver step the same way.
``summarize_step`` reads the recorded window: its wall time, the union of
the device's kernel and copy intervals inside it (so the device's idle
share), the top device kernels by time, and the device time under each
named range (``record_function``) that the split and quiver paths and
the phase timers mark.
"""

from __future__ import annotations

from torch.autograd import DeviceType

NAMED_RANGES = ("sample", "train_step", "local_aggregate_dense",
                "_DenseAggregateBackward", "synthesize_device_innermost",
                "local_aggregate", "slice_owned", "shuffle_merge",
                "_ShuffleMergeBackward", "gat_attention_dense",
                "_GatAttentionBackward",
                "gat_attention_coo", "reverse_shuffle",
                "_ReverseShuffleBackward", "shuffle_softmax_merge",
                "_ShuffleSoftmaxMergeBackward", "quiver_draw",
                "quiver_gather", "dense_sage_forward",
                "Optimizer.step#Adam.step")


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def summarize_step(prof, top: int = 10) -> dict:
    """The recorded step: its window, the device's busy time (the union of
    its kernel, copy and set intervals inside the window) and idle share,
    the ``top`` device kernels by time, and for each of ``NAMED_RANGES``
    the device time of the kernels launched inside it and its calls.
    Times in ms from the profiler's microsecond clock."""
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    steps = [e for e in cpu if e.name.startswith("ProfilerStep")]
    if not steps:
        raise RuntimeError("the profiler recorded no step window")
    step = max(steps, key=lambda e: e.time_range.end - e.time_range.start)
    w0, w1 = step.time_range.start, step.time_range.end
    ranges = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    ranges |= set(NAMED_RANGES) | {step.name}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in ranges]
    clipped = [(e.name, max(e.time_range.start, w0), min(e.time_range.end, w1))
               for e in kernels]
    clipped = [c for c in clipped if c[2] > c[1]]
    busy = _union_ms((a, b) for _, a, b in clipped)
    window = (w1 - w0) / 1e3
    by_name: dict[str, list] = {}
    for name, a, b in clipped:
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += (b - a) / 1e3
        entry[1] += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    named = {}
    for name in NAMED_RANGES:
        host = [e for e in cpu if e.name == name]
        if host:
            named[name] = {
                "device_ms": sum(e.device_time_total for e in host) / 1e3,
                "calls": len(host),
            }
    return {
        "window_ms": window,
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / window if window > 0 else None,
        "device_kernels": len(clipped),
        "top_ops": [{"name": k, "device_ms": v[0], "calls": v[1]}
                    for k, v in ops[:top]],
        "named_ms": named,
    }
