#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--num-nodes N]

1. Prints the card (name and power limit), torch and CUDA versions, and
   builds every hand-written kernel from the sources in the checkout.
2. Builds the products-scale graph (2.45 M nodes, degree 25, 100 features,
   47 classes) and samples the first batch of the slice.
3. Holds each kernel against its plain PyTorch version on the card: at the
   three shapes the first batch gives it, then on ragged cases. For each
   case it prints the max abs error, the kernel's time, the plain
   version's, one ``index_add_`` call's (a yardstick the port never
   calls) and the least time the card could take (the bound).
4. Checks that the first batch's logits through the kernel equal those of
   a plain forward written here, with the same weights.
5. Drives ``--mode single`` GraphSAGE training (3 layers, hidden 128,
   fan-out 10,10,25, batch 1024, 8 steps) through the port's
   ``train_single``, and checks the kernel launched 3 times a step.
6. Prints the card again, one JSON line of kernel numbers, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It also fails when torch sees no CUDA device, and outside the repository.
``--num-nodes`` cuts the graph for a quick run; every width stays.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.models import get_model
from occ_gnn_tpu_torch.ops.build import KERNELS, build_kernel
from occ_gnn_tpu_torch.ops.segment_sum_sorted import (
    segment_sum_sorted,
    segment_sum_sorted_reference,
)
from occ_gnn_tpu_torch.sampling.neighbor import (
    NeighborSampler,
    measure_capacities,
)
from occ_gnn_tpu_torch.train import build_argparser, train_single
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils import PhaseTimers

PRODUCTS_NODES = 2_450_000
AVG_DEGREE, FEATURE_DIM, NUM_CLASSES = 25, 100, 47
TRAIN_FLAGS = ["--mode", "single", "--num-hidden", "128",
               "--fan-out", "10,10,25", "--batch-size", "1024",
               "--measure-caps", "--limit-train", "8192", "--num-epochs", "1"]
# f32 sums taken in another order than the plain version's atomics.
KERNEL_TOL = 1e-4
# Logits: the same sums followed by three layers of f32 matmuls; the
# limit is 1e-4 of the logits' scale (at least 1).
LOGITS_TOL = 1e-4
TIMED_RUNS = 30
GRAPH_REPS = 10
# Peak device-memory rate by card (NVIDIA data sheets), bytes/s.
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
H100_SXM_RATE = 3.35e12
F32_RATE = 67e12  # f32 outside the tensor cores, operations/s

KERNEL_SOURCE = "occ_gnn_tpu_torch/csrc/segment_sum_sorted.cu"
KERNEL_REPLACES = "occ_gnn_tpu/ops/pallas_spmm_blocked.py:190"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def memory_rate(name: str) -> float:
    for key, rate in MEMORY_RATE.items():
        if key in name:
            return rate
    return H100_SXM_RATE


def median_ms(fn) -> float:
    """Median over TIMED_RUNS of one call's device time. ``fn`` is captured
    GRAPH_REPS times into one CUDA graph and each run replays the graph
    between two CUDA events, so the host's launch time is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(GRAPH_REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TIMED_RUNS)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    graph.reset()
    return statistics.median(
        s.elapsed_time(e) / GRAPH_REPS for s, e in events)


class StepTimers(PhaseTimers):
    """PhaseTimers that also keep every duration of each phase, in ms."""

    def __init__(self):
        super().__init__()
        self.each = defaultdict(list)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with super().phase(name):
            yield
        self.each[name].append(1e3 * (time.perf_counter() - t0))


def kernel_case(label, msgs, edge_dst, n, rate):
    num_edges, h = msgs.shape
    out = segment_sum_sorted(msgs, edge_dst, n)
    ref = segment_sum_sorted_reference(msgs, edge_dst, n)
    torch.cuda.synchronize()
    if out.shape != (n, h) or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: bad kernel output {tuple(out.shape)}")
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{label}: kernel differs from its plain "
                             f"version by {err} > {KERNEL_TOL}")
    dst_long = edge_dst.long()
    ms = median_ms(lambda: segment_sum_sorted(msgs, edge_dst, n))
    plain_ms = median_ms(
        lambda: segment_sum_sorted_reference(msgs, edge_dst, n))
    library_ms = median_ms(
        lambda: torch.zeros(n + 1, h, device=msgs.device).index_add_(
            0, dst_long, msgs))
    valid = int((edge_dst < n).sum())
    # Each valid message row and its edge_dst entry read once, out written
    # once; the sum never needs the padding tail (the binary searches probe
    # only log2(E) entries a row). One add per valid element.
    bytes_ms = 4 * (valid * h + valid + n * h) / rate * 1e3
    ops_ms = valid * h / F32_RATE * 1e3
    print(f"kernel {label}: E={num_edges} valid={valid} D={n} H={h} "
          f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"index_add_ms={library_ms:.4f} bound_ms={max(bytes_ms, ops_ms):.4f}"
          f" ({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes_ms=bytes_ms, ops_ms=ops_ms)


def ragged_cases(device):
    """(label, msgs, edge_dst, num_segments) at the kernel's edges."""
    rng = np.random.default_rng(7)

    def case(label, dst_valid, num_edges, n, h, integers=False):
        dst = np.full(num_edges, n, np.int32)
        dst[: dst_valid.shape[0]] = np.sort(dst_valid)
        if integers:
            msgs = rng.integers(-8, 9, (num_edges, h)).astype(np.float32)
        else:
            msgs = rng.standard_normal((num_edges, h)).astype(np.float32)
        return (label, torch.from_numpy(msgs).to(device),
                torch.from_numpy(dst).to(device), n)

    yield case("E=0", np.zeros(0, np.int32), 0, 16, 8)
    yield case("all padding", np.zeros(0, np.int32), 1000, 50, 32)
    yield case("num_segments=1", np.zeros(400, np.int32), 500, 1, 64)
    for h in (1, 3, 100, 128):
        yield case(f"H={h}", rng.integers(0, 777, 15000), 20000, 777, h)
    # Small-integer messages: every partial sum is exact in f32, so the
    # 10000-term row is held to equality whatever the summation order
    # (normal draws would differ by ~1e-3 from rounding alone).
    long_row = np.concatenate([np.full(10000, 2), np.repeat([0, 1, 3, 4], 100)])
    yield case("segment of 10000 edges", long_row, 10600, 5, 128,
               integers=True)
    yield case("empty segments between full ones",
               3 * rng.integers(0, 333, 8000), 9000, 999, 100)
    # A 4-byte offset takes the scalar path although H % 4 == 0.
    label, msgs, dst, n = case("unaligned rows", rng.integers(0, 300, 5000),
                               5000, 300, 4)
    flat = torch.empty(msgs.numel() + 1, device=device)
    flat[1:] = msgs.reshape(-1)
    yield label, flat[1:].view(msgs.shape), dst, n


def plain_forward(model, batch, x0):
    """SAGE forward written with the plain segment-sum, as a reference."""
    seg_sum = segment_sum_sorted_reference
    x = x0
    for i, blk in enumerate(batch.blocks):
        n = blk.dst_cap
        total = seg_sum(x[blk.edge_src.long()], blk.edge_dst, n)
        ones = torch.ones(blk.edge_cap, 1, device=x.device)
        neigh = total / seg_sum(ones, blk.edge_dst, n).clamp(min=1.0)
        p = model.layer_params(i)
        x = torch.cat([x[:n], neigh], dim=1) @ p["w"] + p["b"]
        if i != len(batch.blocks) - 1:
            x = torch.relu(x)
    return x


def main(argv=None) -> int:
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("--num-nodes", type=int, default=PRODUCTS_NODES)
    opts = cli.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: torch sees no CUDA device; chip_smoke.py runs on a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"memory rate for the bound {rate / 1e12} TB/s")

    # 1. Build every kernel from the checkout's sources.
    for kernel in KERNELS:
        t0 = time.perf_counter()
        report = build_kernel(kernel)
        print(f"kernel build: {kernel} in {time.perf_counter() - t0:.2f}s")
        print(f"--- nvcc {kernel}:\n{report.strip()}")

    # 2. The slice's graph and first batch.
    args = build_argparser().parse_args(
        ["--graph", "random", "--num-nodes", str(opts.num_nodes),
         "--avg-degree", str(AVG_DEGREE), "--feature-dim", str(FEATURE_DIM)]
        + TRAIN_FLAGS)
    if opts.num_nodes != PRODUCTS_NODES:
        print(f"cut: {opts.num_nodes} nodes in place of {PRODUCTS_NODES}; "
              f"every width kept")
    t0 = time.perf_counter()
    g = random_graph(opts.num_nodes, AVG_DEGREE, FEATURE_DIM,
                     num_classes=NUM_CLASSES, seed=args.seed)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, feat "
          f"{g.feature_dim}, {g.num_classes} classes, built in "
          f"{time.perf_counter() - t0:.1f}s")
    fanouts = [int(f) for f in args.fan_out.split(",")]
    nodes = g.train_nodes()[: args.limit_train]
    # The capacities and first batch train_single will use: same seeds.
    caps = measure_capacities(g, nodes, fanouts, args.batch_size,
                              seed=args.seed + 99)
    print(f"capacities: {caps}")
    batch = next(iter(NeighborSampler(g, nodes, fanouts, args.batch_size,
                                      capacities=caps, seed=args.seed,
                                      device=device)))
    x0 = gather_features(g.features, batch.input_nodes, device)

    # 3. Each kernel against its plain version, main-path shapes first.
    gen = torch.Generator(device).manual_seed(1)
    main_cases = []
    for i, blk in enumerate(batch.blocks):
        x = x0 if i == 0 else torch.randn(
            blk.src_cap, args.num_hidden, generator=gen, device=device)
        msgs = x[blk.edge_src]
        main_cases.append(kernel_case(f"layer {i}", msgs, blk.edge_dst,
                                      blk.dst_cap, rate))
        del msgs
    ragged = [kernel_case(*c, rate) for c in ragged_cases(device)]

    # 4. First batch: logits through the kernel == the plain forward.
    model = get_model("sage", g.feature_dim, args.num_hidden, g.num_classes,
                      len(fanouts),
                      generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device).eval()
    with torch.no_grad():
        logits = model(batch, x0)
        ref = plain_forward(model, batch, x0)
    torch.cuda.synchronize()
    if logits.shape != (caps["frame_caps"][-1], g.num_classes) or not (
            torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    scale = max(1.0, ref.abs().max().item())
    logits_err = (logits - ref).abs().max().item()
    print(f"first-batch logits: max_abs_err={logits_err:.3g} at scale "
          f"{scale:.3g} (limit {LOGITS_TOL * scale:.3g})")
    if not logits_err <= LOGITS_TOL * scale:
        raise AssertionError("kernel-path logits differ from the plain "
                             "forward")
    del batch, x0, logits, ref, model

    # 5. The slice through the port's entry point.
    timers = StepTimers()
    torch.cuda.reset_peak_memory_stats(device)
    segment_sum_sorted.launches = 0
    metrics = train_single(args, g, fanouts, timers, device)
    launches = segment_sum_sorted.launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = metrics["steps"]
    print(f"slice: {steps} steps, loss {metrics['loss']:.4f}, acc "
          f"{metrics['acc']:.4f}, segment_sum_sorted launches {launches}, "
          f"peak device memory {peak_gib:.3f} GiB")
    # Each phase is recorded once a step (capacity_plan once a run), so
    # "the rest" is steps 2..N.
    for phase, each in sorted(timers.each.items()):
        rest = each[1:] or each
        print(f"  phase {phase}: {sum(each) / 1e3:.4f}s total over "
              f"{len(each)}, first {each[0]:.2f} ms, median of the rest "
              f"{statistics.median(rest):.2f} ms (min {min(rest):.2f}, "
              f"max {max(rest):.2f})")
        if phase != "capacity_plan" and len(each) != steps:
            raise AssertionError(f"phase {phase} recorded {len(each)} times "
                                 f"in {steps} steps")
    if steps == 0 or launches != 3 * steps:
        raise AssertionError(f"{launches} kernel launches for {steps} steps; "
                             f"expected 3 a step")
    if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["acc"])):
        raise AssertionError(f"non-finite loss/accuracy: {metrics}")

    # 6. Summary: the main-path numbers are one step's three forward shapes.
    def total(key):
        return sum(c[key] for c in main_cases)

    bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
    kernels = [{
        "name": "segment_sum_sorted",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(c["err"] for c in main_cases + ragged),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": total("library_ms"),
    }]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
