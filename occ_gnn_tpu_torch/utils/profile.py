"""Device-time summary of one profiled training step.

``train_split --profile-dir`` records one steady step with
``torch.profiler`` (the window runs from the launch of that step to the
launch of the next, by which time the lag-1 pipeline has waited for the
step to finish); ``chip_smoke.py`` records one quiver step the same way.
``summarize_step`` reads the recorded window: its wall time, the union of
the device's kernel and copy intervals inside it (so the device's idle
share), the top device kernels by time, and the device time under each
named range (``utils/timers.span``) that the split and quiver paths,
the C++ service's feed and the phase timers mark.

A range's device time is that of the kernels launched inside it, on its
thread, whoever launched them: each device kernel or copy goes to the
innermost named range whose host interval holds its runtime launch
event (``cudaLaunchKernel`` and the like, correlated with the kernel),
and a range counts its own kernels and those of the ranges nested in it
(``attribute_kernels``). So a kernel launched through ctypes counts in
its range as one launched by a torch op does.
"""

from __future__ import annotations

from torch.autograd import DeviceType

NAMED_RANGES = (
    # The CLI's phases (``utils/timers.PhaseTimers``).
    "partition", "capacity_plan", "sample", "feature_load",
    "feature_gather", "train_step", "fused_step", "infer_step",
    # The C++ service's feed (``sampling/native.py``).
    "occ.feed.submit", "occ.feed.wait", "occ.feed.copy", "occ.feed.upload",
    "occ.feed.cache",
    # A training step's phases (``parallel/model.py``, ``parallel/dp.py``,
    # ``sampling/device_sampler.py``).
    "occ.step", "occ.step.upload", "occ.step.layers", "occ.step.forward",
    "occ.step.loss", "occ.step.backward", "occ.step.optimizer",
    # The layers' ranges, and the autograd nodes of their backwards.
    "local_aggregate_dense", "_DenseAggregateBackward",
    "synthesize_device_innermost", "local_aggregate", "slice_owned",
    "shuffle_merge", "_ShuffleMergeBackward", "gat_attention_dense",
    "gat_attention_online", "gat_attention_tiled", "_GatAttentionBackward",
    "gat_attention_coo", "gat_tail", "_GatTailBackward", "unimp_query",
    "qk_attention_dense", "_QkAttentionBackward", "unimp_tail",
    "_UnimpTailBackward", "reverse_shuffle",
    "_ReverseShuffleBackward", "shuffle_softmax_merge",
    "_ShuffleSoftmaxMergeBackward", "quiver_draw", "quiver_gather",
    "dense_sage_forward", "Optimizer.step#Adam.step")


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def attribute_kernels(ranges, launches, kernels) -> dict:
    """Device time by named range, from plain intervals: ``ranges`` are
    ``(name, thread, start, end)`` host intervals of named ranges, properly
    nested on each thread; ``launches`` maps a correlation id to the
    ``(thread, time)`` of its runtime launch; ``kernels`` are ``(correlation
    id, device time)``. A kernel goes to the innermost range (the latest
    start, then the earliest end) on its launch's thread whose closed
    interval holds the launch time, and counts for that range and every
    range holding it; a kernel with no launch, or whose launch no range
    holds, counts for none. Returns {name: device time} for the names
    that got any."""
    by_thread: dict = {}
    for name, thread, start, end in ranges:
        by_thread.setdefault(thread, []).append((start, end, name))
    out: dict = {}
    for corr, dur in kernels:
        launch = launches.get(corr)
        if launch is None:
            continue
        thread, at = launch
        held = [r for r in by_thread.get(thread, ()) if r[0] <= at <= r[1]]
        if not held:
            continue
        inner = max(held, key=lambda r: (r[0], -r[1]))
        # Proper nesting: the ranges holding the innermost one are the
        # others that hold the launch.
        for start, end, name in held:
            if start <= inner[0] and inner[1] <= end:
                out[name] = out.get(name, 0.0) + dur
    return out


def _launch_threads(prof) -> dict:
    """The torch thread id of each runtime thread: the profiler labels a
    torch op with its own per-thread id and a runtime event with the
    system's, so pair them where a runtime event is linked to the torch op
    it ran under."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        return {}
    cpu = [e for e in results.events() if e.device_type() == DeviceType.CPU]
    op_thread = {e.correlation_id(): e.start_thread_id() for e in cpu
                 if not _is_runtime(e.name(), e.is_user_annotation())}
    out = {}
    for e in cpu:
        linked = e.linked_correlation_id()
        if _is_runtime(e.name(), e.is_user_annotation()) and (
                linked in op_thread):
            out[e.start_thread_id()] = op_thread[linked]
    return out


def _is_runtime(name: str, user_annotation: bool) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    return name.startswith("cu") and not user_annotation


def summarize_step(prof, top: int = 10) -> dict:
    """The recorded step: its window, the device's busy time (the union of
    its kernel, copy and set intervals inside the window) and idle share,
    the ``top`` device kernels by time (``ops_ms``: every one), and for
    each of ``NAMED_RANGES`` the device time of the kernels launched
    inside it (``attribute_kernels``) and its calls. Times in ms from the
    profiler's microsecond clock."""
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
    kernel_ids = {e.id for e in kernels}
    threads = _launch_threads(prof)
    launches = {}
    for e in cpu:
        if e.id in kernel_ids and _is_runtime(
                e.name, getattr(e, "is_user_annotation", False)):
            launches[e.id] = (threads.get(e.thread, e.thread),
                              e.time_range.start)
    named_set = set(NAMED_RANGES)
    device_us = attribute_kernels(
        [(e.name, e.thread, e.time_range.start, e.time_range.end)
         for e in cpu if e.name in named_set],
        launches,
        [(e.id, e.time_range.end - e.time_range.start) for e in kernels])
    named = {}
    for name in NAMED_RANGES:
        calls = sum(1 for e in cpu if e.name == name)
        if calls:
            named[name] = {"device_ms": device_us.get(name, 0.0) / 1e3,
                           "calls": calls}
    return {
        "window_ms": window,
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / window if window > 0 else None,
        "device_kernels": len(clipped),
        "top_ops": [{"name": k, "device_ms": v[0], "calls": v[1]}
                    for k, v in ops[:top]],
        "ops_ms": {k: v[0] for k, v in ops},
        "named_ms": named,
    }
