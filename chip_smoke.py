#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--num-nodes N] [--ranks N]

1. Prints the card (name and power limit), torch and CUDA versions, and
   builds every hand-written kernel and the C++ sampling service from the
   sources in the checkout, one compiler for each, all at once.
2. Builds the products-scale graph (2.45 M nodes, degree 25, 100 features,
   47 classes) once for the single path, split A and split GAT A, and
   samples the single path's first batch.
3. Holds each kernel against its plain PyTorch version on the card: at the
   three shapes the first batch gives it, then on ragged cases (GAT's
   widths among them). For each case it prints the max abs error, the
   kernel's time, the plain version's, one ``index_add_`` call's (a
   yardstick the port never calls) and the least time the card could take
   (the bound).
4. Checks that the first batch's logits through the kernel equal those of
   a plain forward written here, with the same weights.
5. Drives ``--mode single`` GraphSAGE training (3 layers, hidden 128,
   fan-out 10,10,25, batch 1024, 8 steps) through the port's
   ``train_single``, and checks the kernel launched 3 times a step.
6. pa-cache: before the run, the frame of the single path's first batch
   assembled by a cache of the same share, bit-equal to
   ``gather_features``, and the assembly's device time beside its byte
   bound; then ``--mode pa-cache --cache-per 0.25`` at the single path's
   flags (8 steps) through ``train_single``: the same first batch, the
   hit rate equal to a host recount of every frame's ids (recorded on
   the host), 3 launches a step, and the host-to-device feature bytes a
   step against the single path's.
7. Quiver: ``--mode quiver`` at the same widths: one batch's logits on
   the trainer's own drawn frontiers against a plain dense forward
   written here, 10,000 draws checked as in-neighbours, the draw, the
   gather and the layer-0 mean timed beside their byte bounds, one steady
   step profiled, then 8 steps through ``train_quiver`` (no launch).
8. Split A, products scale, every width kept: checks one layer 0
   synthesized on the card from the resident CSR, and the split logits of
   a host-innermost batch against the single-chip logits of the same
   sample; times the split path's torch ops at the first batch's shapes
   beside their byte bounds; then drives ``--mode split --cache-per auto``
   (replicated cache, device innermost, C++ sampler; 8 steps) through
   ``train_split`` with one steady step profiled.
   Split GAT A: the same with ``--model-name gat --num-hidden 32
   --num-heads 4`` (the JAX package's GAT bench widths): split vs single
   GAT logits, the batched attention's times forward and backward beside
   their byte bounds, 8 steps with one profiled, no kernel launch.
9. Split B, 200,000 nodes (depth cut for time, every width kept):
   ``--cache-per 0.25 --innermost host --fan-out 10,10,-1 --save-dir``,
   the refreshing cache with a COO layer 0. Checks the split-vs-single
   logits, that a step launched before a tail write reads the old tail,
   one kernel launch a step and one tail write a step. Then single GAT
   and single GCN on the same graph (3 steps each): 3 launches a step
   each. Then ``--mode infer`` of split B's checkpoint on the test nodes
   (worst-case capacities, no cache): first its first batch's split
   logits against a plain forward written here with the same weights,
   and the kernel at that batch's layer-0 COO against its plain version;
   then the run, one launch a batch.
10. Split P2: split A's flags at ``--partitions 2 --partition-mode
   round_robin`` (metis took 109-123 s a rank on the products graph on
   the H100 host), two ranks spawned as the CLI's launcher spawns them,
   each running ``train_split`` on the products graph (saved once in the
   binary format and loaded by each rank): NCCL when there are two
   cards, else both ranks on ``cuda:0`` over gloo. Checks equal global
   metrics on both ranks, 2 shuffles forward and 2 backward a step, and
   that one raw sample's P = 2 logits, loss and gradients equal P = 1's
   on the card.
11. Split P2-B: split B's flags at ``--partitions 2 --partition-mode
   metis``: the cache tails refresh per rank, layer 0 is COO through the
   kernel (one launch per rank a step) and shuffles forward only (3
   forward, 2 backward a step). Split GAT P2-B: the same with GAT, whose
   layers each run the reverse shuffle and the softmax merge both ways
   (6 forward, 6 backward a step), and the two shuffles' times at the
   run's own capacities. Both with the P = 2 vs P = 1 check of split P2
   (the P = 2 sample sliced at the capacities the run trained at), each
   rank's refreshing frame against the frame of every node.
12. DDP P2 (the products graph), quiver P2 and infer P2 (split B's
   graph, ``--partition-mode round_robin``), two ranks each: equal global
   metrics on every rank, and equal final weights for ddp and quiver;
   ddp 3 launches a step per rank and one step's all-reduced gradient
   against one process summing the shard batches through the plain
   forward, at the run's measured capacities; infer one launch a
   batch per rank, the P = 1 count and at least 99.9 % of its
   predictions.
13. Prints the card again, one JSON line of kernel numbers, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It also fails when torch sees no CUDA device, and outside the repository.
``--num-nodes`` cuts the products graph for a quick run; every width stays.
``--ranks N`` sets the ranks of steps 10-12 (default 2): on a machine
with a card for every rank, the ranks run over NCCL.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

from occ_gnn_tpu_torch.cache import (
    CachePlan,
    SingleChipCache,
    SplitFeatureCache,
)
from occ_gnn_tpu_torch.data import (
    edge_cut_fraction,
    load_graph,
    random_graph,
    save_graph,
)
from occ_gnn_tpu_torch.models import get_model
from occ_gnn_tpu_torch.ops.build import (
    KERNELS,
    build_kernel,
    build_partitioner,
    build_sampler,
)
from occ_gnn_tpu_torch.ops.segment_sum_sorted import (
    segment_sum_sorted,
    segment_sum_sorted_reference,
)
from occ_gnn_tpu_torch.parallel import dist
from occ_gnn_tpu_torch.parallel.dp import make_dp_train_step
from occ_gnn_tpu_torch.parallel.model import (
    SplitGAT,
    SplitSAGE,
    dense_attention,
    make_device_csr,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.parallel.split import (
    local_aggregate_dense,
    reset_shuffle_counts,
    reverse_shuffle,
    shuffle_counts,
    shuffle_softmax_merge,
    slice_owned,
    synthesize_device_innermost,
)
from occ_gnn_tpu_torch.sampling.device_sampler import (
    DeviceSampleTrainer,
    sample_neighbors_dense,
)
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
from occ_gnn_tpu_torch.sampling.neighbor import (
    NeighborSampler,
    measure_capacities,
)
from occ_gnn_tpu_torch.sampling.slicer import (
    SplitSampler,
    plan_split_capacities,
    raw_to_single_batch,
)
from occ_gnn_tpu_torch.train import (
    build_argparser,
    run_infer,
    train_ddp,
    train_quiver,
    train_single,
    train_split,
)
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils import PhaseTimers
from occ_gnn_tpu_torch.utils.checkpoint import load_checkpoint
from occ_gnn_tpu_torch.utils.profile import summarize_step

PRODUCTS_NODES = 2_450_000
SPLIT_B_NODES = 200_000
AVG_DEGREE, FEATURE_DIM, NUM_CLASSES = 25, 100, 47
COMMON_FLAGS = ["--num-hidden", "128", "--batch-size", "1024",
                "--measure-caps", "--limit-train", "8192", "--num-epochs", "1"]
TRAIN_FLAGS = ["--mode", "single", "--fan-out", "10,10,25"] + COMMON_FLAGS
SPLIT_A_FLAGS = ["--mode", "split", "--cache-per", "auto",
                 "--fan-out", "10,10,25", "--profile-dir",
                 "chiprun_out/split_a_profile"] + COMMON_FLAGS
SPLIT_B_FLAGS = ["--mode", "split", "--cache-per", "0.25", "--innermost",
                 "host", "--fan-out", "10,10,-1"] + COMMON_FLAGS
# GAT at the JAX package's GAT bench widths (bench.py:262-268): hidden 32
# per head, 4 heads. The flags after COMMON_FLAGS win over its hidden 128.
GAT_FLAGS = ["--model-name", "gat", "--num-hidden", "32", "--num-heads", "4"]
GAT_A_FLAGS = ["--mode", "split", "--cache-per", "auto", "--fan-out",
               "10,10,25", "--profile-dir",
               "chiprun_out/split_gat_a_profile"] + COMMON_FLAGS + GAT_FLAGS
# The single-chip GAT and GCN phases run 3 steps each on split B's graph.
SINGLE_B_FLAGS = TRAIN_FLAGS + ["--limit-train", "3072"]
# The baselines at the single path's widths: pa-cache and quiver on the
# products graph, ddp at --partitions RANKS on it, quiver at RANKS on
# split B's graph.
PA_CACHE_FLAGS = ["--mode", "pa-cache", "--cache-per", "0.25", "--fan-out",
                  "10,10,25"] + COMMON_FLAGS
# Quiver's shapes are dense: it measures no capacities.
QUIVER_FLAGS = ["--mode", "quiver", "--fan-out", "10,10,25"] + [
    f for f in COMMON_FLAGS if f != "--measure-caps"]
DDP_FLAGS = ["--mode", "ddp", "--fan-out", "10,10,25"] + COMMON_FLAGS
# Inference of split B's checkpoint (its model flags) on the test nodes.
INFER_FLAGS = ["--mode", "infer", "--fan-out", "10,10,-1", "--num-hidden",
               "128", "--batch-size", "1024", "--infer-nodes", "test"]
# P vs P = 1 predictions: equal but for near-ties of the logits.
PRED_AGREEMENT = 0.999
DRAW_CHECKS = 10_000
# Sorted segment-sum launches a step: one a layer. Single SAGE and GCN
# sum the messages; GAT (single, and split on its COO layer 0) sums the
# softmax denominators and the weighted messages as one [p, p * feat].
SINGLE_LAUNCHES = {"sage": 3, "gcn": 3, "gat": 3}
# The P > 1 phases, one process per partition: split A's and split B's
# flags at --partitions RANKS.
RANKS = 2
# metis on the products graph took 109.12 s and 122.57 s a rank in two
# runs on the H100 host (both ranks at once); above 120 s the products
# phase partitions round-robin. The 200,000-node graph takes metis in
# ~8 s.
PRODUCTS_PARTITION_MODE = "round_robin"
SPLIT_B_PARTITION_MODE = "metis"
RANK_TIMEOUT_S = 600
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
# Links of an H100 SXM, bytes/s each way: PCIe Gen5 x16 to the host (gloo
# moves a CUDA tensor's all-to-all through host memory) and NVLink 4
# between cards (NCCL).
PCIE_RATE = 64e9
NVLINK_RATE = 450e9

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
    """PhaseTimers that also keep every duration of each phase, in ms,
    and the wall-clock start of each one."""

    def __init__(self):
        super().__init__()
        self.each = defaultdict(list)
        self.starts = defaultdict(list)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        self.starts[name].append(t0)
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
    # GAT's COO message [p, p * feat] a head, 4 heads: 132 = 4 x (32 + 1)
    # on hidden layers, 192 = 4 x (47 + 1) on the last; 188 (not a
    # multiple of 4) takes the scalar path.
    for h in (1, 3, 4, 100, 128, 132, 188, 192):
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


def graph_args(num_nodes: int, flags: list[str]):
    return build_argparser().parse_args(
        ["--graph", "random", "--num-nodes", str(num_nodes),
         "--avg-degree", str(AVG_DEGREE), "--feature-dim", str(FEATURE_DIM)]
        + flags)


def build_all():
    """Build every kernel, the C++ service and the partitioner at once,
    one compiler each."""
    def timed(fn, *a):
        t0 = time.perf_counter()
        report = fn(*a)
        return time.perf_counter() - t0, report

    with ThreadPoolExecutor(max_workers=len(KERNELS) + 2) as pool:
        jobs = {f"{k} (nvcc)": pool.submit(timed, build_kernel, k)
                for k in KERNELS}
        jobs["occ_sampler (g++)"] = pool.submit(timed, build_sampler)
        jobs["partition (g++)"] = pool.submit(timed, build_partitioner)
        for name, job in jobs.items():
            secs, report = job.result()
            print(f"build: {name} in {secs:.2f}s")
            if report.strip():
                print(f"--- {name}:\n{report.strip()}")


def events_ms(fn, runs: int = 20) -> float:
    """Mean device time of one call over ``runs`` back-to-back calls
    between two CUDA events (host launch time included where the device
    waits for it)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def check_synthesized_layer(g, fanouts, batch_size, device):
    """One layer 0 synthesized on the card from the resident CSR, held to
    the sampling contract: slot 0 is the self row, every other used slot
    a true neighbour, unused slots the zero row, rows with deg <= fanout
    the adjacency in order, and owned_deg == take + 1. Returns the native
    batch, its synthesized layer 0 and the CSR for the op timings."""
    pmap = np.zeros(g.num_nodes, np.int32)
    nodes = g.train_nodes()
    caps = plan_split_capacities(batch_size, fanouts, g.num_nodes, 1)
    plan = CachePlan(g, pmap, 1, 1.0, refresh_cap=8)
    sampler = NativeSplitSampler(g, nodes, pmap, 1, fanouts, batch_size,
                                 capacities=caps, seed=0, cache=plan,
                                 innermost="device", device=device)
    batch = sampler.sample_batch(nodes[:batch_size])
    sampler.close()
    csr = make_device_csr(g, device)
    gen = torch.Generator(device).manual_seed(5)
    l0 = batch.layers[0].partition(0)
    syn = synthesize_device_innermost(l0, csr[0], csr[1], gen)
    indptr, indices = (t.long() for t in csr)
    K, N, zero = l0.fanout, g.num_nodes, l0.src_cap - 1
    dg = l0.dst_global.long()
    valid = dg >= 0
    gl = dg.clamp(min=0)
    off = indptr[gl]
    deg = torch.where(valid, indptr[gl + 1] - off, 0)
    take = deg.clamp(max=K)
    nbr = syn.nbr_idx.long()
    k = torch.arange(1, K + 1, device=device)[:, None]
    used = k <= take[None, :]
    checks = {
        "slot 0 is the self row": bool(
            (nbr[0] == torch.where(valid, gl, zero)).all()),
        "unused slots hold the zero row": bool((nbr[1:][~used] == zero).all()),
    }
    # Membership: (dst, value) keys against the dst rows' adjacency keys.
    kd = torch.nonzero(used)
    keys = gl[kd[:, 1]] * N + nbr[1:][used]
    vd = torch.nonzero(valid).squeeze(1)
    dv = deg[vd]
    rep = torch.repeat_interleave(torch.arange(vd.shape[0], device=device), dv)
    within = torch.arange(rep.shape[0], device=device) - (
        torch.cumsum(dv, 0) - dv)[rep]
    adj_keys = gl[vd][rep] * N + indices[off[vd][rep] + within]
    checks["every used slot is a true neighbour"] = bool(
        torch.isin(keys, adj_keys).all())
    small = used & (deg <= K)[None, :]
    in_order = indices[(off[None, :] + k - 1).clamp(max=indices.shape[0] - 1)]
    checks["deg <= fanout rows equal the adjacency in order"] = bool(
        (nbr[1:][small] == in_order[small]).all())
    O = l0.out_cap
    v = valid[:O]
    checks["owned_deg == take + 1"] = bool(
        (syn.owned_deg[v] == (take[:O][v] + 1).float()).all()
        and (syn.owned_deg[~v] == 1).all())
    print(f"  synthesized layer 0: D={dg.shape[0]} valid={int(valid.sum())} "
          f"deg>fanout={int((deg > K).sum())} slots used={int(used.sum())}")
    for name, ok in checks.items():
        print(f"  check {name}: {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"synthesized layer 0: {name} fails")
    return batch, syn, csr


def split_model(args, g, seed: int = 0):
    """The split model the flags name (SAGE or GAT), weights from ``seed``."""
    dims = (g.feature_dim, args.num_hidden, g.num_classes,
            len(args.fan_out.split(",")))
    gen = torch.Generator().manual_seed(seed)
    if args.model_name == "gat":
        return SplitGAT(*dims, num_heads=args.num_heads, generator=gen)
    return SplitSAGE(*dims, generator=gen)


def split_vs_single(g, args, cache_pct, device):
    """The first host-innermost batch of the numpy SplitSampler under the
    cache plan: its split logits against the port's single-chip logits
    (the model of ``args``: SAGE or GAT) on ``raw_to_single_batch`` of the
    same raw sample, with the same weights. Returns what the tail check of
    split B reuses."""
    fanouts = [int(f) for f in args.fan_out.split(",")]
    batch_size = args.batch_size
    pmap = np.zeros(g.num_nodes, np.int32)
    nodes = g.train_nodes()
    caps = plan_split_capacities(batch_size, fanouts, g.num_nodes, 1)
    plan = CachePlan(g, pmap, 1, cache_pct, refresh_cap=caps["frame_caps"][0])
    cache = SplitFeatureCache(plan, device=device)
    sampler = SplitSampler(g, nodes, pmap, 1, fanouts, batch_size,
                           capacities=caps, seed=0, cache=cache,
                           device=device)
    raw = sampler._sample_raw(nodes[:batch_size])
    split_batch = sampler.slice_raw(raw)
    single = raw_to_single_batch(raw, g, sampler.caps, device)
    x0 = gather_features(g.features, single.input_nodes, device)
    model = split_model(args, g).to(device)
    kw = {"num_heads": args.num_heads} if args.model_name == "gat" else {}
    single_model = get_model(args.model_name, g.feature_dim, args.num_hidden,
                             g.num_classes, len(fanouts), **kw)
    single_model = single_model.to(device).eval()
    single_model.load_state_dict(model.state_dict())
    fwd = make_split_forward(model)
    with torch.no_grad():
        split_logits = fwd(split_batch, cache.frames)[0]
        single_logits = single_model(single, x0)
    n = raw[0].frontier.shape[0]
    ref = single_logits[:n]
    scale = max(1.0, ref.abs().max().item())
    err = (split_logits[:n] - ref).abs().max().item()
    print(f"  split vs single {args.model_name} logits, first batch ({n} "
          f"targets): "
          f"max_abs_err={err:.3g} at scale {scale:.3g} (limit "
          f"{LOGITS_TOL * scale:.3g})")
    if not (torch.isfinite(split_logits).all() and err <= LOGITS_TOL * scale):
        raise AssertionError("split logits differ from single-chip logits")
    return cache, sampler, fwd, split_batch


def check_tail_order(cache, sampler, fwd, batch, nodes, batch_size):
    """A step launched before a tail write reads the old tail: a forward
    is enqueued on the frames, the next batch's tail is written in place
    at once, and the forward's logits must equal those on a copy of the
    frames taken before the write."""
    before = cache.frames.clone()
    in_flight = fwd(batch, cache.frames)
    sampler.sample_batch(nodes[batch_size : 2 * batch_size])
    ref = fwd(batch, before)
    torch.cuda.synchronize()
    wrote = not torch.equal(before, cache.frames)
    same = torch.equal(in_flight, ref)
    print(f"  tail write ordered after the step in flight: tail "
          f"{'written' if wrote else 'NOT written'}, logits "
          f"{'unchanged' if same else 'CHANGED'}")
    if not (wrote and same):
        raise AssertionError("the in-place tail write raced a step")


def split_op_times(batch, syn, csr, frames, hidden, rate, device):
    """The split path's torch ops at the first batch's shapes: device ms
    per call, calls a step, and the byte bound (each input read once,
    each output written once; padding slots of nbr read the one zero
    row). Layer 0 reads the frame, which takes no gradient."""
    gen = torch.Generator(device).manual_seed(6)
    layers = [syn] + [lyr.partition(0) for lyr in batch.layers[1:]]
    l0 = batch.layers[0].partition(0)
    rows = []

    def add(name, fn, nbytes):
        ms = events_ms(fn)
        rows.append((name, ms, nbytes / rate * 1e3))
        print(f"  op {name}: ms={ms:.4f} bound_ms={nbytes / rate * 1e3:.4f} "
              f"(bytes)")

    D0, O0, K0 = l0.dst_global.shape[0], l0.out_cap, l0.fanout
    used0 = int((syn.nbr_idx[1:] != l0.src_cap - 1).sum())
    add("synthesize_device_innermost",
        lambda: synthesize_device_innermost(l0, csr[0], csr[1], gen),
        4 * (D0 + 2 * D0 + used0 + (K0 + 1) * D0) + 13 * O0)
    for i, lyr in enumerate(layers):
        nbr = lyr.nbr_idx
        K, D = nbr.shape
        if i == 0:
            x = frames[0]
        else:
            x = torch.randn(lyr.src_cap, hidden, device=device,
                            requires_grad=True)
        H, xb = x.shape[1], x.element_size()
        valid = int((nbr != lyr.src_cap - 1).sum())
        add(f"local_aggregate_dense fwd, layer {i} (K={K}, D={D}, H={H})",
            lambda: local_aggregate_dense(x, nbr),
            4 * K * D + xb * valid * H + 4 * D * H)
        merged = local_aggregate_dense(x, nbr)
        if x.requires_grad:
            g = torch.randn_like(merged)
            add(f"local_aggregate_dense bwd, layer {i}",
                lambda: torch.autograd.grad(merged, x, g, retain_graph=True),
                4 * K * D + 4 * D * H + 4 * x.shape[0] * H)
        O = lyr.out_cap
        add(f"slice_owned, layer {i} (O={O})",
            lambda: slice_owned(merged.detach(), lyr, x.detach()),
            O * (4 + 4 + 4 + 1) + O * H * (4 + xb) + 2 * 4 * O * H)
    return rows


def gat_op_times(batch, syn, frames, args, num_classes, rate, device):
    """GAT's batched attention (``dense_attention``) at split GAT A's first
    batch's shapes, forward and backward: device ms per call and the byte
    bound (each input read once, each output written once: the nbr matrix,
    the valid leaf rows of x, er and the (m, s, v) partials; the backward
    reads the gradients of s and v and the leaves again, and writes the
    gradients of er, the weights and, past layer 0, of x)."""
    gen = torch.Generator(device).manual_seed(8)
    heads, hidden = args.num_heads, args.num_hidden
    layers = [syn] + [lyr.partition(0) for lyr in batch.layers[1:]]
    outs = [hidden] * (len(layers) - 1) + [num_classes]
    rows = []

    def add(name, fn, nbytes):
        ms = events_ms(fn)
        rows.append((name, ms, nbytes / rate * 1e3))
        print(f"  op {name}: ms={ms:.4f} bound_ms={nbytes / rate * 1e3:.4f} "
              f"(bytes)")

    def param(*shape):
        return (0.1 * torch.randn(*shape, generator=gen, device=device)
                ).requires_grad_()

    for i, lyr in enumerate(layers):
        nbr = lyr.nbr_idx
        K, D = nbr.shape
        x = frames[0] if i == 0 else param(lyr.src_cap, hidden * heads)
        F, H = x.shape
        xb, dh = x.element_size(), outs[i]
        wl, w3, er = param(H, heads), param(H, heads, dh), param(D, heads)
        valid = int((nbr != F - 1).sum())
        leaves = 4 * K * D + xb * valid * H
        add(f"dense_attention fwd, layer {i} (K={K}, D={D}, H={H}, "
            f"heads={heads}, Dh={dh})",
            lambda: dense_attention(x, nbr, wl, w3, er),
            leaves + 4 * D * heads + 4 * D * heads * (2 + dh))
        _, s, v = dense_attention(x, nbr, wl, w3, er)
        grads = (torch.randn_like(s), torch.randn_like(v))
        inputs = [wl, w3, er] + ([x] if x.requires_grad else [])
        dx = 4 * F * H if x.requires_grad else 0
        add(f"dense_attention bwd, layer {i}",
            lambda: torch.autograd.grad((s, v), inputs, grads,
                                        retain_graph=True),
            leaves + 4 * D * heads * (1 + dh) + 4 * D * heads + dx)
        del s, v, grads
    return rows


def gat_shuffle_times(batch, args, num_classes, rate, backend, device,
                      runs: int = 10) -> list:
    """``reverse_shuffle`` and ``shuffle_softmax_merge``, forward and
    backward, at one P > 1 batch's shapes on this rank (sliced at the
    capacities the run trained at): host ms per call (the gloo all-to-all
    blocks the host), every rank in the same order. The bound is the
    larger of the device bytes of the op's inputs and outputs (frames,
    partials, gradients, index tensors), each once, over the memory rate,
    and the link's: over gloo, the host copies of the all-to-all's buffer
    (sent to the host and received from it, the two directions
    overlapped) over PCIE_RATE, leaving out gloo's exchange through host
    memory; over NCCL, the chunks for the other ranks over NVLINK_RATE."""
    gen = torch.Generator(device).manual_seed(9)
    heads, hidden = args.num_heads, args.num_hidden
    link, link_rate = (("NVLink", NVLINK_RATE) if backend == "nccl"
                       else ("host copies", PCIE_RATE))
    outs = [hidden] * (len(batch.layers) - 1) + [num_classes]
    rows = []

    def timed(fn):
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize(device)
        return 1e3 * (time.perf_counter() - t0) / runs

    def rand(*shape, grad=False):
        return torch.randn(*shape, generator=gen, device=device
                           ).requires_grad_(grad)

    for i, lyr in enumerate(batch.layers):
        lp = lyr.partition(0)
        push, recv = lp.push_idx, lp.recv_idx
        D, dh = lp.dst_cap, outs[i]
        P = push.shape[0]
        # Rows of the all-to-all buffer the link carries: all of them to
        # and from the host, the other ranks' chunks over NVLink.
        link_rows = push.numel() * ((P - 1) / P if backend == "nccl" else 1)
        idx = 2 * 4 * push.numel()
        frame = rand(D, heads, grad=True)
        er = reverse_shuffle(frame, push, recv)
        g_er = torch.randn_like(er)
        m = rand(D, heads)
        s = rand(D, heads, grad=True)
        v = rand(D, heads, dh, grad=True)
        so, vo = shuffle_softmax_merge(m, s, v, push, recv)
        g_sv = (torch.randn_like(so), torch.randn_like(vo))
        sv = 4 * D * heads * (1 + dh)
        # The all-to-all buffer [P * S, width] f32: er's heads; (m, s, v)
        # forward, (s, v) backward.
        for name, fn, nbytes, width in (
                ("reverse_shuffle fwd",
                 lambda: reverse_shuffle(frame, push, recv),
                 idx + 2 * 4 * D * heads, heads),
                ("reverse_shuffle bwd",
                 lambda: torch.autograd.grad(er, frame, g_er,
                                             retain_graph=True),
                 idx + 2 * 4 * D * heads, heads),
                ("shuffle_softmax_merge fwd",
                 lambda: shuffle_softmax_merge(m, s, v, push, recv),
                 idx + 4 * D * heads + 2 * sv, heads * (2 + dh)),
                ("shuffle_softmax_merge bwd",
                 lambda: torch.autograd.grad((so, vo), (s, v), g_sv,
                                             retain_graph=True),
                 idx + 2 * sv + 4 * (D + push.numel()) * heads,
                 heads * (1 + dh))):
            device_ms = 1e3 * nbytes / rate
            link_ms = 1e3 * 4 * link_rows * width / link_rate
            rows.append((f"{name}, layer {i} (P={P}, S={push.shape[1]}, "
                         f"D={D}, heads={heads}, Dh={dh})",
                         timed(fn), max(device_ms, link_ms),
                         link if link_ms >= device_ms else "bytes"))
    return rows


def phase_lines(timers, steps: int,
                once=("partition", "capacity_plan")) -> list[str]:
    """Each per-step phase must be recorded once a step; reports first and
    the median of the rest, and the step's wall time: from one step's
    ``train_step`` start to the next's (so sampling, staging and the wait
    for the step before are inside it)."""
    lines = []
    starts = timers.starts["train_step"]
    walls = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
    if walls:
        rest = walls[1:] or walls
        lines.append(f"step wall (launch to launch): first {walls[0]:.2f} "
                     f"ms, median of the rest {statistics.median(rest):.2f} "
                     f"ms (min {min(rest):.2f}, max {max(rest):.2f}) over "
                     f"{len(walls)}")
    for phase, each in sorted(timers.each.items()):
        rest = each[1:] or each
        lines.append(f"phase {phase}: {sum(each) / 1e3:.4f}s total over "
                     f"{len(each)}, first {each[0]:.2f} ms, median of the "
                     f"rest {statistics.median(rest):.2f} ms (min "
                     f"{min(rest):.2f}, max {max(rest):.2f})")
        if phase not in once and len(each) != steps:
            raise AssertionError(f"phase {phase} recorded {len(each)} times "
                                 f"in {steps} steps")
    return lines


def print_phases(timers, steps: int, once=("partition", "capacity_plan")):
    for line in phase_lines(timers, steps, once):
        print(f"  {line}")


def print_profile(profile: dict):
    print(f"  profiled step: window {profile['window_ms']:.3f} ms, device "
          f"busy {profile['device_busy_ms']:.3f} ms, idle share "
          f"{profile['device_idle_share']:.4f} "
          f"({profile['device_kernels']} device kernels and copies)")
    for op in profile["top_ops"]:
        print(f"    top op {op['device_ms']:9.4f} ms  x{op['calls']:<4} "
              f"{op['name'][:90]}")
    for name, v in sorted(profile["named_ms"].items()):
        print(f"    range {name}: {v['device_ms']:.4f} ms of kernels over "
              f"{v['calls']} calls")


def run_split(label, args, g, fanouts, device):
    """Drive the split path through train_split with the launch counts
    set to 0 just before; returns the metrics and the kernel's launches."""
    timers = StepTimers()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    segment_sum_sorted.launches = 0
    metrics = train_split(args, g, fanouts, timers, device)
    launches = segment_sum_sorted.launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = metrics["steps"]
    print(f"{label}: {steps} steps, loss {metrics['loss']:.4f}, acc "
          f"{metrics['acc']:.4f}, cache {metrics['cache_pct']:.4f}, "
          f"innermost {metrics['innermost']}, sampler {metrics['sampler']}, "
          f"segment_sum_sorted launches {launches}, tail writes "
          f"{metrics['tail_batches']}, peak device memory {peak_gib:.3f} GiB")
    phases = metrics["phases"]
    print(f"  C++ service per batch: cxx_sample "
          f"{1e3 * phases.get('cxx_sample', float('nan')):.2f} ms, cxx_slice "
          f"{1e3 * phases.get('cxx_slice', float('nan')):.2f} ms")
    print_phases(timers, steps)
    if steps == 0 or not (np.isfinite(metrics["loss"])
                          and np.isfinite(metrics["acc"])):
        raise AssertionError(f"{label}: no steps or non-finite loss: "
                             f"{metrics}")
    return metrics, launches


def check_vs_one_partition(ranks, g, args, fanouts, cache_pct, caps2,
                           device):
    """One raw sample of the numpy SplitSampler sliced at P (this rank's
    row, its partition map, the capacities ``caps2`` the run trained at)
    and at P = 1, with the same weights of the flags' model (SAGE or GAT):
    this rank's owned logits, the global loss and every all-reduced
    gradient against the P = 1 computation, and whether all are finite.
    Returns the errors and this rank's P batch. At P the rank holds its
    own frame under the phase's ``cache_pct`` (static rows plus the tail
    this sample writes when the cache refreshes); at P = 1 the frame holds
    every node. Each error is relative to the largest magnitude of the
    P = 1 tensor it is held to."""
    r, P = ranks.rank, ranks.world_size
    pmap, nodes, bs = g.partition_map, g.train_nodes(), args.batch_size
    cache2 = SplitFeatureCache(
        CachePlan(g, pmap, P, cache_pct, refresh_cap=caps2["frame_caps"][0]),
        device=device, partitions=(r, r + 1))
    s2 = SplitSampler(g, nodes, pmap, P, fanouts, bs, seed=0, cache=cache2,
                      capacities=caps2, emit_range=(r, r + 1), device=device)
    raw = s2._sample_raw(nodes[:bs])
    b2 = s2.slice_raw(raw)
    zeros = np.zeros(g.num_nodes, np.int32)
    plan1 = CachePlan(g, zeros, 1, 1.0, refresh_cap=8)
    s1 = SplitSampler(g, nodes, zeros, 1, fanouts, bs, seed=0, cache=plan1,
                      capacities=plan_split_capacities(bs, fanouts,
                                                       g.num_nodes, 1),
                      device=device)
    b1 = s1.slice_raw(raw)
    x2 = cache2.frames
    x1 = (x2 if cache2.plan.replicated
          else SplitFeatureCache(plan1, device=device).frames)
    m2 = split_model(args, g).to(device)
    m1 = copy.deepcopy(m2)
    logits2 = make_split_forward(m2, ranks=ranks)(b2, x2)[0]
    logits1 = make_split_forward(m1)(b1, x1)[0]
    loss2, _, count = make_split_train_step(
        m2, torch.optim.SGD(m2.parameters(), lr=0.0), ranks=ranks)(b2, x2)
    loss1, _, _ = make_split_train_step(
        m1, torch.optim.SGD(m1.parameters(), lr=0.0))(b1, x1)
    rows = np.nonzero(pmap[raw[0].frontier] == r)[0]
    ref = logits1[torch.from_numpy(rows).to(device)]
    got = logits2[: rows.shape[0]]

    def rel(a, b):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        return err / scale if scale > 0 else err

    check = dict(targets=int(rows.shape[0]), count=int(count),
                 logits_err=rel(got, ref), loss_err=rel(loss2, loss1),
                 grad_err=max(rel(p2.grad, p1.grad) for p2, p1 in
                              zip(m2.parameters(), m1.parameters())),
                 all_finite=bool(torch.isfinite(logits2).all() and all(
                     torch.isfinite(p.grad).all() for p in m2.parameters())))
    return check, b2


def split_rank(rank, world, store, spec, out_dir):
    """One rank of a P > 1 phase, as the CLI's launcher runs it: joins
    the process group, loads the saved graph, and drives ``train_split``
    with the counts set to 0 just before and read just after; then
    ``check_vs_one_partition`` under the phase's cache and, for GAT, the
    two GAT shuffles' times. Writes what it measured to
    ``out_dir/rank{r}.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranks = dist.init_distributed(store, world, rank, cpu=False)
    try:
        device = ranks.device
        args = build_argparser().parse_args(
            ["--graph", spec["name"], "--data-root", spec["root"]]
            + spec["flags"])
        fanouts = [int(f) for f in args.fan_out.split(",")]
        g = load_graph(spec["root"], spec["name"])
        timers = StepTimers()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        segment_sum_sorted.launches = 0
        reset_shuffle_counts()
        metrics = train_split(args, g, fanouts, timers, device, ranks=ranks)
        out = dict(rank=rank, metrics=metrics,
                   edge_cut=edge_cut_fraction(g, g.partition_map),
                   launches=segment_sum_sorted.launches,
                   shuffles=shuffle_counts(),
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                   phase_lines=phase_lines(timers, metrics["steps"]))
        out["check"], b2 = check_vs_one_partition(
            ranks, g, args, fanouts, metrics["cache_pct"],
            metrics["capacities"], device)
        if args.model_name == "gat":
            out["shuffle_ops"] = gat_shuffle_times(
                b2, args, g.num_classes,
                memory_rate(torch.cuda.get_device_name(device)),
                ranks.backend, device)
    finally:
        dist.close(ranks)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_ranks(label, num_ranks, name, root, flags, shuffles_per_step):
    """Spawn the ranks of a P > 1 phase and hold what they report: equal
    global loss and accuracy, ``shuffles_per_step`` (forward, backward)
    all-to-alls a step, and each rank's P vs P = 1 errors."""
    spec = dict(name=name, root=root, flags=flags)
    with tempfile.TemporaryDirectory(prefix="occ_smoke_ranks_") as out_dir:
        dist.spawn(split_rank, num_ranks, spec, out_dir,
                   timeout=RANK_TIMEOUT_S)
        results = []
        for r in range(num_ranks):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    backends = {res["metrics"]["backend"] for res in results}
    print(f"{label}: {num_ranks} ranks, partition mode "
          f"{flags[flags.index('--partition-mode') + 1]} (edge cut "
          f"{results[0]['edge_cut']:.4f}), backend {', '.join(backends)}, "
          f"{torch.cuda.device_count()} card(s)"
          + ("" if "nccl" in backends else
             " (the ranks share cuda:0; wall times are no scaling numbers)"))
    fwd, bwd = shuffles_per_step
    for res in results:
        m, sh = res["metrics"], res["shuffles"]
        steps = m["steps"]
        print(f"  rank {res['rank']}: {steps} steps, global loss "
              f"{m['loss']:.6f}, acc {m['acc']:.6f}, cache {m['cache_pct']:.4f},"
              f" innermost {m['innermost']}, replans {m['replans']}, tail "
              f"writes {m['tail_batches']}, segment_sum_sorted launches "
              f"{res['launches']}, peak device memory {res['peak_gib']:.3f} "
              f"GiB")
        print(f"  rank {res['rank']}: shuffles forward {sh['forward']} "
              f"({sh['forward'] / max(steps, 1):g} a step), backward "
              f"{sh['backward']} ({sh['backward'] / max(steps, 1):g} a "
              f"step), bytes sent {sh['bytes_sent']} "
              f"({sh['bytes_sent'] / max(steps, 1):.0f} a step), "
              f"shuffle_caps {m['capacities']['shuffle_caps']}")
        phases = m["phases"]
        print(f"  rank {res['rank']}: C++ service per batch: cxx_sample "
              f"{1e3 * phases.get('cxx_sample', float('nan')):.2f} ms, "
              f"cxx_slice {1e3 * phases.get('cxx_slice', float('nan')):.2f}"
              f" ms")
        for line in res["phase_lines"]:
            print(f"  rank {res['rank']}: {line}")
        if steps == 0 or not (np.isfinite(m["loss"])
                              and np.isfinite(m["acc"])):
            raise AssertionError(f"{label}: no steps or non-finite loss: {m}")
        if (sh["forward"], sh["backward"]) != (fwd * steps, bwd * steps):
            raise AssertionError(f"{label}: rank {res['rank']} ran {sh} "
                                 f"shuffles in {steps} steps; expected "
                                 f"{fwd} forward and {bwd} backward a step")
        c = res["check"]
        print(f"  rank {res['rank']}: P = {num_ranks} vs P = 1, one raw "
              f"sample ({c['targets']} owned targets of {c['count']}): "
              f"logits {c['logits_err']:.3g}, loss {c['loss_err']:.3g}, "
              f"gradients {c['grad_err']:.3g} of each tensor's scale "
              f"(limit {LOGITS_TOL})")
        if not (c["all_finite"] and max(c["logits_err"], c["loss_err"],
                                        c["grad_err"]) <= LOGITS_TOL):
            raise AssertionError(f"{label}: P = {num_ranks} differs from "
                                 f"P = 1 on rank {res['rank']}: {c}")
        for op, ms, bound, by in res.get("shuffle_ops", []):
            print(f"  rank {res['rank']}: op {op}: ms={ms:.4f} (host clock) "
                  f"bound_ms={bound:.4f} ({by})")
    agreed = {(res["metrics"]["loss"], res["metrics"]["acc"],
               res["metrics"]["steps"]) for res in results}
    if len(agreed) != 1:
        raise AssertionError(f"{label}: the ranks report different global "
                             f"metrics: {agreed}")
    return results


def rank_phases(phase, root: str, num_ranks: int):
    """Split P, split P-B and split GAT P-B: split A's and split B's flags
    (the latter with SAGE and with GAT) at ``num_ranks`` partitions, on the
    graphs saved under ``root``. Returns the kernel's launches over every
    rank of the two P-B phases, and rank 0's GAT shuffle times."""
    def parts(mode):
        return ["--partitions", str(num_ranks), "--partition-mode", mode]

    label = f"split P{num_ranks}"
    with phase(label):
        flags = [f for f in SPLIT_A_FLAGS if f not in (
            "--profile-dir", "chiprun_out/split_a_profile")]
        flags += parts(PRODUCTS_PARTITION_MODE)
        for res in run_ranks(label, num_ranks, "products", root, flags,
                             shuffles_per_step=(2, 2)):
            m = res["metrics"]
            if not (m["cache_pct"] >= 1.0 and m["innermost"] == "device"
                    and res["launches"] == 0):
                raise AssertionError(f"{label} must run with a replicated "
                                     f"cache, device innermost and dense "
                                     f"layers only")
    # The cache refreshes per rank when 0.25 < 1/P.
    refreshing = 0.25 < 1.0 / num_ranks
    launches = 0
    # Layer 0 is COO through the kernel (one launch a step) in both. SAGE
    # shuffles it forward only (the frame takes no gradient); GAT runs the
    # reverse shuffle and the merge on all 3 layers both ways (its layer-0
    # er, s and v depend on W).
    for name, extra, shuffles in (
            (f"{label}-B", [], (3, 2)),
            (f"split GAT P{num_ranks}-B", GAT_FLAGS, (6, 6))):
        with phase(name):
            results = run_ranks(
                name, num_ranks, "split_b", root,
                SPLIT_B_FLAGS + extra + parts(SPLIT_B_PARTITION_MODE),
                shuffles_per_step=shuffles)
        for res in results:
            m = res["metrics"]
            if res["launches"] != m["steps"]:
                raise AssertionError(f"{name}: rank {res['rank']}: "
                                     f"{res['launches']} kernel launches for "
                                     f"{m['steps']} steps; expected 1 a step")
            if m["tail_batches"] != (m["steps"] if refreshing else 0):
                raise AssertionError(f"{name}: rank {res['rank']}: "
                                     f"{m['tail_batches']} tail writes for "
                                     f"{m['steps']} steps")
        launches += sum(res["launches"] for res in results)
    return launches, results[0]["shuffle_ops"]


def check_dense_run(label, metrics, launches):
    """Split A and split GAT A: replicated cache, device innermost, the C++
    sampler, and dense layers only (no segment-sum launch)."""
    if not (metrics["cache_pct"] >= 1.0 and metrics["innermost"] == "device"
            and metrics["sampler"] == "native" and launches == 0):
        raise AssertionError(f"{label} must run with a replicated cache, "
                             f"device innermost, the native sampler and "
                             f"dense layers only")


def single_gat_cases(g, args, rate, device):
    """The kernel at single GAT's first batch's three shapes (each layer's
    [p, p * feat] message, [E, heads * (1 + Dh)]), with random messages:
    the batch ``train_single`` samples first."""
    fanouts = [int(f) for f in args.fan_out.split(",")]
    nodes = g.train_nodes()[: args.limit_train]
    caps = measure_capacities(g, nodes, fanouts, args.batch_size,
                              seed=args.seed + 99)
    batch = next(iter(NeighborSampler(g, nodes, fanouts, args.batch_size,
                                      capacities=caps, seed=args.seed,
                                      device=device)))
    gen = torch.Generator(device).manual_seed(2)
    heads = args.num_heads
    outs = [args.num_hidden] * (len(fanouts) - 1) + [g.num_classes]
    cases = []
    for i, blk in enumerate(batch.blocks):
        msgs = torch.randn(blk.edge_cap, heads * (1 + outs[i]),
                           generator=gen, device=device)
        cases.append(kernel_case(f"single GAT layer {i}", msgs, blk.edge_dst,
                                 blk.dst_cap, rate))
    return cases


def run_single(kind, args, g, device) -> int:
    """Drive ``train_single`` with the launch count set to 0 just before;
    checks the kernel's launches a step. Returns the launches."""
    fanouts = [int(f) for f in args.fan_out.split(",")]
    timers = StepTimers()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    segment_sum_sorted.launches = 0
    metrics = train_single(args, g, fanouts, timers, device)
    launches = segment_sum_sorted.launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = metrics["steps"]
    print(f"single {kind}: {steps} steps, loss {metrics['loss']:.4f}, acc "
          f"{metrics['acc']:.4f}, segment_sum_sorted launches {launches}, "
          f"peak device memory {peak_gib:.3f} GiB")
    print_phases(timers, steps, once=("capacity_plan",))
    want = SINGLE_LAUNCHES[kind]
    if steps == 0 or launches != want * steps:
        raise AssertionError(f"single {kind}: {launches} kernel launches for "
                             f"{steps} steps; expected {want} a step")
    if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["acc"])):
        raise AssertionError(f"single {kind}: non-finite loss: {metrics}")
    return launches


def start_count(device) -> None:
    """Empty the allocator, reset the peak and set the launch count to 0,
    just before a main-path run."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    segment_sum_sorted.launches = 0


def run_pa_cache(args, g, first_ids, single_caps, rate, device):
    """``--mode pa-cache`` through ``train_single``. Before the run, a
    cache of the same share assembles the frame of ``first_ids`` (the
    single path's first batch: the same seeds, flags and capacities),
    which must equal ``gather_features`` of those ids bit for bit, and
    the assembly is timed at its shapes. During the run the ids of every
    frame are recorded on the host, as ``stage`` reads them; afterwards
    the first must be ``first_ids``, the hit rate must equal a recount of
    every recorded id against the cached node set, and the kernel must
    have launched 3 times a step. Returns the launches and the assembly's
    op row (device ms beside its byte bound)."""
    fanouts = [int(f) for f in args.fan_out.split(",")]
    check = SingleChipCache(g, float(args.cache_per), device=device)
    got = check.load_input_frame(first_ids).cpu()
    ref = gather_features(g.features, first_ids, "cpu")
    bit_equal = got.shape == ref.shape and bool(torch.equal(
        got.view(torch.int32), ref.view(torch.int32)))
    # The device half of one frame's assembly: the zero frame, the hit
    # rows gathered from the cache and copied in, the miss rows copied
    # in. Bound: the index read, the hit and miss rows read, the frame
    # written once.
    index, rows, nh, f_rows = check.stage(first_ids)
    nm, H = rows.shape
    nbytes = 8 * index.numel() + 4 * (nh + nm) * H + 4 * f_rows * H
    ms = events_ms(lambda: check.assemble(index, rows, nh, f_rows))
    op_name = (f"pa-cache assembly (F={f_rows}, hits={nh}, misses={nm}, "
               f"H={H})")
    cached = np.zeros(g.num_nodes, bool)
    cached[check.cached_nodes] = True
    del check, got, ref, index, rows

    seen = []
    stage = SingleChipCache.stage

    def recording(cache, input_nodes):
        # The copy to the host that stage makes first; stage takes ids.
        ids = input_nodes.cpu().numpy()
        seen.append(ids)
        return stage(cache, ids)

    timers = StepTimers()
    start_count(device)
    SingleChipCache.stage = recording
    try:
        metrics = train_single(args, g, fanouts, timers, device,
                               use_cache=True)
    finally:
        SingleChipCache.stage = stage
    launches = segment_sum_sorted.launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = metrics["steps"]
    hits = sum(int(cached[i[i >= 0]].sum()) for i in seen)
    valid = sum(int((i >= 0).sum()) for i in seen)
    recount = hits / valid
    frame_bytes = 4 * single_caps["frame_caps"][0] * g.feature_dim
    sent = metrics["bytes_sent"] / steps
    print(f"pa-cache: {steps} steps, loss {metrics['loss']:.4f}, acc "
          f"{metrics['acc']:.4f}, cache {metrics['cache_pct']:.4f} "
          f"({int(cached.sum())} nodes), hit_rate "
          f"{metrics['hit_rate']:.6f} (host recount {recount:.6f}), "
          f"segment_sum_sorted launches {launches}, peak device memory "
          f"{peak_gib:.3f} GiB")
    print(f"  first frame (checked before the run) bit-equal to "
          f"gather_features: {bit_equal}")
    print(f"  host->device feature bytes a step: pa-cache {sent:.0f} (miss "
          f"rows and positions) against single {frame_bytes} (the padded "
          f"frame, F0_cap {single_caps['frame_caps'][0]}): "
          f"{sent / frame_bytes:.4f}")
    print(f"  op {op_name}: ms={ms:.4f} bound_ms="
          f"{nbytes / rate * 1e3:.4f} (bytes)")
    print_phases(timers, steps, once=("capacity_plan",))
    if not bit_equal:
        raise AssertionError("pa-cache: the assembled frame differs from "
                             "gather_features")
    if not np.array_equal(seen[0], first_ids):
        raise AssertionError("pa-cache: the run's first frame has other ids "
                             "than the checked one")
    if metrics["hit_rate"] != recount:
        raise AssertionError(f"pa-cache: hit rate {metrics['hit_rate']} != "
                             f"host recount {recount}")
    if steps == 0 or launches != SINGLE_LAUNCHES["sage"] * steps:
        raise AssertionError(f"pa-cache: {launches} kernel launches for "
                             f"{steps} steps; expected 3 a step")
    if not np.isfinite(metrics["loss"]):
        raise AssertionError(f"pa-cache: non-finite loss: {metrics}")
    return launches, (op_name, ms, nbytes / rate * 1e3)


def plain_dense_forward(model, features, frontiers, fanouts):
    """The quiver forward written with the plain segment-sum over an
    explicit COO (each self row and its K drawn rows summed into the self
    row's segment), as a reference."""
    x = features[frontiers[-1].long()]
    num_layers = len(fanouts)
    for i in range(num_layers):
        m = num_layers - 1 - i
        n, k = frontiers[m].shape[0], fanouts[m]
        rows = torch.arange(n, device=x.device)
        seg = torch.cat([rows, rows.repeat_interleave(k)]).int()
        mean = segment_sum_sorted_reference(x.float(), seg, n) / (k + 1)
        p = model.layer_params(i)
        x = torch.cat([x[:n].float(), mean], dim=1) @ p["w"] + p["b"]
        if i != num_layers - 1:
            x = torch.relu(x)
    return x


def check_draws(g, frontiers, fanouts, seed: int) -> int:
    """DRAW_CHECKS (node, drawn) pairs picked at random over every layer:
    each must be an in-neighbour of its node, or the node itself at
    degree 0. Returns the pairs drawn in all."""
    parents, drawn = [], []
    for m, k in enumerate(fanouts):
        n = frontiers[m].shape[0]
        parents.append(frontiers[m].repeat_interleave(k))
        drawn.append(frontiers[m + 1][n:])
    parents, drawn = torch.cat(parents), torch.cat(drawn)
    pick = np.random.default_rng(seed).choice(parents.shape[0], DRAW_CHECKS,
                                              replace=False)
    pick_t = torch.from_numpy(pick).to(parents.device)
    vs = parents[pick_t].cpu().numpy()
    us = drawn[pick_t].cpu().numpy()
    bad = 0
    for v, u in zip(vs, us):
        lo, hi = g.indptr[v], g.indptr[v + 1]
        ok = (u == v) if lo == hi else bool((g.indices[lo:hi] == u).any())
        bad += not ok
    print(f"  {DRAW_CHECKS} of {parents.shape[0]} draws checked: "
          f"{DRAW_CHECKS - bad} in-neighbours (or self at degree 0)")
    if bad:
        raise AssertionError(f"quiver: {bad} draws are no in-neighbour")
    return parents.shape[0]


def profile_one_step(trainer, nodes) -> dict:
    """One steady quiver step (the second of two, each ending in a
    synchronise) recorded by torch.profiler and summarized."""
    from torch.profiler import ProfilerActivity, profile, schedule

    summary = {}
    batches = trainer.epoch_batches(nodes)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: summary.update(summarize_step(p))
                 ) as prof:
        for _ in range(2):
            trainer.step(*next(batches))
            torch.cuda.synchronize()
            prof.step()
    return summary


def check_quiver(args, g, rate, device):
    """The quiver path's checks on its own trainer (seeded as
    ``train_quiver``'s): one batch's logits against ``plain_dense_forward``
    on the trainer's own drawn frontiers, the draws, the draw, gather and
    mean times beside their byte bounds, and one profiled steady step.
    Returns the op rows and the profile."""
    fanouts = [int(f) for f in args.fan_out.split(",")]
    nodes = g.train_nodes()[: args.limit_train]
    model = get_model("sage", g.feature_dim, args.num_hidden, g.num_classes,
                      len(fanouts),
                      generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    trainer = DeviceSampleTrainer(
        g, fanouts, args.batch_size, model,
        torch.optim.Adam(model.parameters(), lr=args.lr), seed=args.seed,
        device=device)
    targets, _ = next(trainer.epoch_batches(nodes))
    model.eval()
    with torch.no_grad():
        frontiers = trainer.sample(torch.from_numpy(targets[0]).to(device))
        logits = trainer.forward(frontiers)
        ref = plain_dense_forward(model, trainer.features, frontiers,
                                  fanouts)
    torch.cuda.synchronize()
    scale = max(1.0, ref.abs().max().item())
    err = (logits - ref).abs().max().item()
    sizes = [int(f.shape[0]) for f in frontiers]
    print(f"  frontiers {sizes}; logits {tuple(logits.shape)} vs the plain "
          f"dense forward: max_abs_err={err:.3g} at scale {scale:.3g} (limit "
          f"{LOGITS_TOL * scale:.3g})")
    if not (torch.isfinite(logits).all() and logits.shape == (
            args.batch_size, g.num_classes) and err <= LOGITS_TOL * scale):
        raise AssertionError("quiver logits differ from the plain forward")
    del logits, ref
    check_draws(g, frontiers, fanouts, args.seed)
    # Op times at this batch's shapes: the deepest draw, the gather of the
    # deepest frontier's rows, the layer-0 mean. Bounds: each input read
    # once, each output written once.
    rows = []

    def add(name, fn, nbytes):
        ms = events_ms(fn)
        rows.append((name, ms, nbytes / rate * 1e3))
        print(f"  op {name}: ms={ms:.4f} bound_ms={nbytes / rate * 1e3:.4f} "
              f"(bytes)")

    n, k = frontiers[-2].shape[0], fanouts[-1]
    last, deep = frontiers[-2], frontiers[-1]
    gen = torch.Generator(device).manual_seed(11)
    # The frontier, indptr[v] and indptr[v + 1], the drawn indices, the
    # output.
    add(f"quiver draw (n={n}, K={k})",
        lambda: sample_neighbors_dense(trainer.csr, last, k, gen),
        4 * n + 8 * n + 4 * n * k + 4 * n * k)
    M, H = deep.shape[0], trainer.features.shape[1]
    eb = trainer.features.element_size()
    add(f"quiver gather (M={M}, H={H})",
        lambda: trainer.features.index_select(0, deep),
        4 * M + 2 * eb * M * H)
    x = trainer.features.index_select(0, deep)
    add(f"quiver layer-0 mean (n={n}, K={k}, H={H})",
        lambda: (x[:n].float() + x[n:].reshape(n, k, -1).sum(
            dim=1, dtype=torch.float32)) / (k + 1.0),
        eb * M * H + 4 * n * H)
    del x, frontiers
    model.train()
    profile = profile_one_step(trainer, nodes)
    return rows, profile


def run_quiver(args, g, device) -> dict:
    """Drive ``train_quiver`` with the counts set to 0 just before; the
    path launches no kernel."""
    fanouts = [int(f) for f in args.fan_out.split(",")]
    timers = StepTimers()
    start_count(device)
    metrics = train_quiver(args, g, fanouts, timers, device)
    launches = segment_sum_sorted.launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = metrics["steps"]
    fused = 1e3 * metrics["phases"]["fused_step"]
    print(f"quiver: {steps} steps, loss {metrics['loss']:.4f}, acc "
          f"{metrics['acc']:.4f}, segment_sum_sorted launches {launches}, "
          f"peak device memory {peak_gib:.3f} GiB; fused_step {fused:.2f} "
          f"ms for the epoch, {fused / max(steps, 1):.2f} ms a step (the "
          f"first step's warm-up included)")
    if steps == 0 or launches or not np.isfinite(metrics["loss"]):
        raise AssertionError(f"quiver: {launches} launches in {steps} "
                             f"steps, metrics {metrics}")
    return dict(metrics=metrics, peak_gib=peak_gib)


def ddp_grad_check(ranks, g, args, fanouts, device):
    """One DDP step's all-reduced gradient (lr 0) on the first batch of
    every shard, at the capacities ``train_ddp`` measured (so the kernel
    runs at the run's shapes), against the gradient of the global mean
    loss over the same P batches through ``plain_forward`` (the plain
    segment-sum), summed in one process (rank 0). Returns the largest
    error relative to each tensor's max |.|, on rank 0 (None on the
    others)."""
    P, r = ranks.world_size, ranks.rank
    per_dev = args.batch_size // P
    nodes = g.train_nodes()[: args.limit_train]
    caps = measure_capacities(g, nodes, fanouts, per_dev,
                              seed=args.seed + 99)
    shards = np.array_split(np.random.default_rng(args.seed).permutation(
        nodes), P)

    def shard_batch(q):
        batch = next(iter(NeighborSampler(
            g, shards[q], fanouts, per_dev, capacities=caps,
            seed=args.seed + q, drop_last=True, device=device)))
        return batch, gather_features(g.features, batch.input_nodes, device)

    model = get_model("sage", g.feature_dim, args.num_hidden, g.num_classes,
                      len(fanouts),
                      generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    ref = copy.deepcopy(model)
    make_dp_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                       ranks)(*shard_batch(r))
    if r != 0:
        return None
    nll, count = 0.0, 0
    for q in range(P):
        batch, x0 = shard_batch(q)
        logits = plain_forward(ref, batch, x0)
        valid = batch.labels >= 0
        logp = torch.log_softmax(logits, dim=-1)[valid]
        nll = nll - logp.gather(-1, batch.labels[valid, None].long()).sum()
        count += int(valid.sum())
    (nll / count).backward()
    errs = [(a.grad - b.grad).abs().max().item() / b.grad.abs().max().item()
            for a, b in zip(model.parameters(), ref.parameters())]
    return max(errs)


def baseline_rank(rank, world, store, spec, out_dir):
    """One rank of a ddp, quiver or infer phase at P > 1, as the CLI's
    launcher runs it: joins the process group, loads the saved graph and
    drives the mode's entry point with the counts set to 0 just before
    and read just after; ddp then runs ``ddp_grad_check``. Writes what it
    measured to ``out_dir/rank{r}.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranks = dist.init_distributed(store, world, rank, cpu=False)
    try:
        device = ranks.device
        args = build_argparser().parse_args(
            ["--graph", spec["name"], "--data-root", spec["root"]]
            + spec["flags"])
        fanouts = [int(f) for f in args.fan_out.split(",")]
        g = load_graph(spec["root"], spec["name"])
        run = {"ddp": train_ddp, "quiver": train_quiver,
               "infer": run_infer}[args.mode]
        timers = StepTimers()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        segment_sum_sorted.launches = 0
        metrics = run(args, g, fanouts, timers, device, ranks=ranks)
        out = dict(rank=rank, metrics=metrics,
                   launches=segment_sum_sorted.launches,
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                   phase_lines=phase_lines(timers, metrics.get("steps", 0),
                                           once=("fused_step",
                                                 "infer_step")))
        if args.mode == "ddp":
            out["grad_err"] = ddp_grad_check(ranks, g, args, fanouts, device)
    finally:
        dist.close(ranks)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_baseline_ranks(label, num_ranks, name, root, flags):
    """Spawn the ranks of a ddp, quiver or infer phase and hold what they
    report: equal global metrics (and, for ddp and quiver, equal final
    weights) on every rank. Returns the ranks' results."""
    spec = dict(name=name, root=root, flags=flags)
    with tempfile.TemporaryDirectory(prefix="occ_smoke_ranks_") as out_dir:
        dist.spawn(baseline_rank, num_ranks, spec, out_dir,
                   timeout=RANK_TIMEOUT_S)
        results = []
        for r in range(num_ranks):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    backends = {res["metrics"].get("backend") for res in results}
    print(f"{label}: {num_ranks} ranks, backend {', '.join(backends)}, "
          f"{torch.cuda.device_count()} card(s)"
          + ("" if "nccl" in backends else
             " (the ranks share cuda:0; wall times are no scaling numbers)"))
    keys = ("loss", "acc", "steps", "weights_crc32", "count")
    for res in results:
        m = res["metrics"]
        print(f"  rank {res['rank']}: "
              + ", ".join(f"{k} {m[k]}" for k in keys if k in m)
              + f", segment_sum_sorted launches {res['launches']}, peak "
              f"device memory {res['peak_gib']:.3f} GiB")
        for line in res["phase_lines"]:
            print(f"  rank {res['rank']}: {line}")
        if not np.isfinite(m.get("loss", 0.0)):
            raise AssertionError(f"{label}: non-finite loss: {m}")
    agreed = {tuple(res["metrics"].get(k) for k in keys) for res in results}
    if len(agreed) != 1:
        raise AssertionError(f"{label}: the ranks report different global "
                             f"metrics or weights: {agreed}")
    return results


def baseline_rank_phases(phase, root: str, num_ranks: int, infer_ref):
    """ddp on the products graph, quiver and infer on split B's graph, at
    ``num_ranks`` ranks. ``infer_ref`` is the P = 1 inference (metrics,
    predictions, flags). Returns the kernel's launches over every rank."""
    parts = ["--partitions", str(num_ranks)]
    launches = 0
    label = f"ddp P{num_ranks}"
    with phase(label):
        results = run_baseline_ranks(label, num_ranks, "products", root,
                                     DDP_FLAGS + parts)
        for res in results:
            steps = res["metrics"]["steps"]
            if steps == 0 or res["launches"] != SINGLE_LAUNCHES["sage"] * (
                    steps):
                raise AssertionError(f"{label}: rank {res['rank']}: "
                                     f"{res['launches']} kernel launches for "
                                     f"{steps} steps; expected 3 a step")
        err = results[0]["grad_err"]
        print(f"  one step's all-reduced gradient vs one process summing the "
              f"{num_ranks} shard batches: {err:.3g} of each tensor's scale "
              f"(limit {LOGITS_TOL})")
        if not err <= LOGITS_TOL:
            raise AssertionError(f"{label}: all-reduced gradient differs "
                                 f"from the single-process sum: {err}")
        launches += sum(res["launches"] for res in results)
    label = f"quiver P{num_ranks}"
    with phase(label):
        results = run_baseline_ranks(label, num_ranks, "split_b", root,
                                     QUIVER_FLAGS + parts)
        if any(res["launches"] for res in results):
            raise AssertionError(f"{label}: the quiver path launched the "
                                 "kernel")
    label = f"infer P{num_ranks}"
    ref_metrics, ref_preds, flags, batches = infer_ref
    out = os.path.join(root, f"preds_p{num_ranks}.npy")
    flags = flags + parts + ["--partition-mode", "round_robin", "--output",
                             out]
    with phase(label):
        results = run_baseline_ranks(label, num_ranks, "split_b", root,
                                     flags)
        preds = np.load(out)
        m = results[0]["metrics"]
        predicted = ref_preds >= 0
        same = float((preds[predicted] == ref_preds[predicted]).mean())
        print(f"  count {m['count']} (P = 1: {ref_metrics['count']}), acc "
              f"{m['acc']:.6f} (P = 1: {ref_metrics['acc']:.6f}); "
              f"predictions equal to P = 1's on {same:.6f} of the nodes "
              f"(limit {PRED_AGREEMENT})")
        if m["count"] != ref_metrics["count"] or not (
                (preds >= 0) == predicted).all():
            raise AssertionError(f"{label}: another node set than P = 1's")
        if not same >= PRED_AGREEMENT:
            raise AssertionError(f"{label}: predictions differ from P = 1's "
                                 f"on {1 - same:.6f} of the nodes")
        for res in results:
            if res["launches"] != batches:
                raise AssertionError(f"{label}: rank {res['rank']}: "
                                     f"{res['launches']} kernel launches for "
                                     f"{batches} batches; expected 1 a batch")
        launches += sum(res["launches"] for res in results)
    return launches


def check_infer_batch(g, args, rate, device):
    """The first test batch as ``--mode infer`` samples it at P = 1
    (worst-case capacities, no cache, the host gather) through the split
    forward with the checkpoint ``args.resume``, against ``plain_forward``
    of the same weights on ``raw_to_single_batch`` of the same raw sample;
    then the kernel at that batch's layer-0 COO against its plain version.
    Returns the kernel case."""
    fanouts = [int(f) for f in args.fan_out.split(",")]
    nodes = np.nonzero(g.test_mask)[0]
    sampler = SplitSampler(g, nodes, np.zeros(g.num_nodes, np.int32), 1,
                           fanouts, args.batch_size, seed=args.seed,
                           device=device)
    raw = sampler._sample_raw(nodes[: args.batch_size])
    batch = sampler.slice_raw(raw)
    xs = gather_features(g.features, batch.input_nodes[0].cpu().numpy(),
                         device)
    model = split_model(args, g)
    load_checkpoint(args.resume, model)
    model = model.to(device)
    plain = get_model("sage", g.feature_dim, args.num_hidden, g.num_classes,
                      len(fanouts)).to(device)
    plain.load_state_dict(model.state_dict())
    single = raw_to_single_batch(raw, g, sampler.caps, device)
    with torch.no_grad():
        logits = make_split_forward(model)(batch, xs[None])[0]
        ref = plain_forward(plain, single, gather_features(
            g.features, single.input_nodes, device))
    n = raw[0].frontier.shape[0]
    scale = max(1.0, ref[:n].abs().max().item())
    err = (logits[:n] - ref[:n]).abs().max().item()
    print(f"  first test batch ({n} targets, worst-case capacities): split "
          f"logits vs the plain forward: max_abs_err={err:.3g} at scale "
          f"{scale:.3g} (limit {LOGITS_TOL * scale:.3g})")
    if not (torch.isfinite(logits).all() and err <= LOGITS_TOL * scale):
        raise AssertionError("infer logits differ from the plain forward")
    lyr = batch.layers[0].partition(0)
    return kernel_case("infer layer 0", xs[lyr.edge_src.long()],
                       lyr.edge_dst, lyr.dst_cap, rate)


def run_infer_one(g, ck_path, out_dir, rate, device):
    """``--mode infer`` of split B's checkpoint at P = 1 on its test
    nodes: ``check_infer_batch`` first, then the run with the counts set
    to 0 just before: one launch a batch (the COO layer 0). Returns
    (launches, kernel case, (metrics, predictions, flags, batches))."""
    out = os.path.join(out_dir, "preds_p1.npy")
    flags = INFER_FLAGS + ["--resume", ck_path]
    args = graph_args(SPLIT_B_NODES, flags + ["--output", out])
    case = check_infer_batch(g, args, rate, device)
    timers = StepTimers()
    start_count(device)
    metrics = run_infer(args, g, [int(f) for f in args.fan_out.split(",")],
                        timers, device)
    launches = segment_sum_sorted.launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    batches = -(-int(g.test_mask.sum()) // args.batch_size)
    print(f"infer P1: count {metrics['count']}, acc {metrics['acc']:.6f}, "
          f"{batches} batches, segment_sum_sorted launches {launches}, peak "
          f"device memory {peak_gib:.3f} GiB")
    print_phases(timers, batches, once=())
    if launches != batches or metrics["count"] != int(g.test_mask.sum()):
        raise AssertionError(f"infer P1: {launches} launches for {batches} "
                             f"batches, count {metrics['count']}")
    return launches, case, (metrics, np.load(out), flags, batches)


def main(argv=None) -> int:
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("--num-nodes", type=int, default=PRODUCTS_NODES)
    cli.add_argument("--ranks", type=int, default=RANKS,
                     help="partitions (one process each) of the split P "
                          "phases")
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
    wall = time.perf_counter()

    @contextmanager
    def phase(label):
        t0 = time.perf_counter()
        print(f"== {label}")
        yield
        print(f"== {label}: {time.perf_counter() - t0:.1f}s wall")

    # 1. Build every kernel and the C++ service from the checkout.
    with phase("build"):
        build_all()

    # 2. The products-scale graph, shared by the single path and split A.
    args = graph_args(opts.num_nodes, TRAIN_FLAGS)
    if opts.num_nodes != PRODUCTS_NODES:
        print(f"cut: {opts.num_nodes} nodes in place of {PRODUCTS_NODES}; "
              f"every width kept")
    with phase("graph"):
        g = random_graph(opts.num_nodes, AVG_DEGREE, FEATURE_DIM,
                         num_classes=NUM_CLASSES, seed=args.seed)
        print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, feat "
              f"{g.feature_dim}, {g.num_classes} classes")
    fanouts = [int(f) for f in args.fan_out.split(",")]
    nodes = g.train_nodes()[: args.limit_train]
    graphs = tempfile.TemporaryDirectory(prefix="occ_smoke_graphs_")
    # 3-5. The single path: the kernel at its shapes, the first batch's
    # logits, and train_single.
    with phase("single path"):
        # The capacities and first batch train_single will use: same seeds.
        caps = measure_capacities(g, nodes, fanouts, args.batch_size,
                                  seed=args.seed + 99)
        print(f"capacities: {caps}")
        batch = next(iter(NeighborSampler(g, nodes, fanouts, args.batch_size,
                                          capacities=caps, seed=args.seed,
                                          device=device)))
        x0 = gather_features(g.features, batch.input_nodes, device)
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

        model = get_model("sage", g.feature_dim, args.num_hidden,
                          g.num_classes, len(fanouts),
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
        first_ids = batch.input_nodes.cpu().numpy()
        del batch, x0, logits, ref, model

        single_launches = run_single("sage", args, g, device)

    # 6-7. pa-cache and quiver on the products graph.
    with phase("pa-cache"):
        launches_pc, pc_row = run_pa_cache(
            graph_args(opts.num_nodes, PA_CACHE_FLAGS), g, first_ids, caps,
            rate, device)
    with phase("quiver"):
        args_q = graph_args(opts.num_nodes, QUIVER_FLAGS)
        quiver_rows, quiver_profile = check_quiver(args_q, g, rate, device)
        print_profile(quiver_profile)
        quiver = run_quiver(args_q, g, device)

    # 8. Split A: products scale, replicated cache, device innermost.
    with phase("split A"):
        args_a = graph_args(opts.num_nodes, SPLIT_A_FLAGS)
        fan_a = [int(f) for f in args_a.fan_out.split(",")]
        batch, syn, csr = check_synthesized_layer(g, fan_a, args_a.batch_size,
                                                  device)
        cache, _, _, _ = split_vs_single(g, args_a, 1.0, device)
        op_rows = split_op_times(batch, syn, csr, cache.frames,
                                 args_a.num_hidden, rate, device)
        del csr, cache
        metrics_a, launches_a = run_split("split A", args_a, g, fan_a, device)
        check_dense_run("split A", metrics_a, launches_a)
        print_profile(metrics_a["profile"])

    # 8b. Split GAT A: the same graph and flags with GAT (hidden 32, 4
    # heads): the batched attention on every layer.
    with phase("split GAT A"):
        args_ga = graph_args(opts.num_nodes, GAT_A_FLAGS)
        cache, _, _, _ = split_vs_single(g, args_ga, 1.0, device)
        gat_rows = gat_op_times(batch, syn, cache.frames, args_ga,
                                g.num_classes, rate, device)
        del batch, syn, cache
        metrics_ga, launches_ga = run_split("split GAT A", args_ga, g, fan_a,
                                            device)
        check_dense_run("split GAT A", metrics_ga, launches_ga)
        print_profile(metrics_ga["profile"])
    with phase("save graphs"):
        save_graph(g, graphs.name, "products")
    del g

    # 9. Split B: 200,000 nodes, refreshing cache, COO layer 0.
    with phase("split B"):
        ck_dir = os.path.join(graphs.name, "split_b_checkpoint")
        args_b = graph_args(SPLIT_B_NODES,
                            SPLIT_B_FLAGS + ["--save-dir", ck_dir])
        fan_b = [int(f) for f in args_b.fan_out.split(",")]
        g_b = random_graph(SPLIT_B_NODES, AVG_DEGREE, FEATURE_DIM,
                           num_classes=NUM_CLASSES, seed=args_b.seed)
        cache, sampler, fwd, batch = split_vs_single(g_b, args_b, 0.25,
                                                     device)
        check_tail_order(cache, sampler, fwd, batch, g_b.train_nodes(),
                         args_b.batch_size)
        lyr = batch.layers[0].partition(0)
        msgs = cache.frames[0][lyr.edge_src.long()].float()
        split_case = kernel_case("split B layer 0", msgs, lyr.edge_dst,
                                 lyr.dst_cap, rate)
        # Split GAT's COO layer 0 sends one [p, p * feat] message a head:
        # 4 x (32 + 1) floats an edge.
        gat_split_case = kernel_case(
            "split GAT B layer 0", torch.randn(
                msgs.shape[0], 4 * 33, device=device), lyr.edge_dst,
            lyr.dst_cap, rate)
        del cache, sampler, fwd, batch, lyr, msgs
        metrics_b, launches_b = run_split("split B", args_b, g_b, fan_b,
                                          device)
        steps_b = metrics_b["steps"]
        if launches_b != steps_b:
            raise AssertionError(f"split B: {launches_b} kernel launches for "
                                 f"{steps_b} steps; expected 1 a step")
        if metrics_b["tail_batches"] != steps_b:
            raise AssertionError(f"split B: {metrics_b['tail_batches']} tail "
                                 f"writes for {steps_b} steps")

    # 9b. Single GAT and single GCN on split B's graph, 3 steps each.
    with phase("single GAT and GCN"):
        args_sg = graph_args(SPLIT_B_NODES, SINGLE_B_FLAGS + GAT_FLAGS)
        gat_cases = single_gat_cases(g_b, args_sg, rate, device)
        launches_sgl = sum(
            run_single(kind, graph_args(SPLIT_B_NODES, SINGLE_B_FLAGS + extra),
                       g_b, device)
            for kind, extra in (("gat", GAT_FLAGS),
                                ("gcn", ["--model-name", "gcn"])))
    # 9c. Inference of split B's checkpoint at P = 1.
    with phase("infer P1"):
        launches_i1, infer_case, infer_ref = run_infer_one(
            g_b, os.path.join(ck_dir, "split_epoch.npz"), graphs.name, rate,
            device)
    with phase("save graphs"):
        save_graph(g_b, graphs.name, "split_b")
    del g_b

    # 10-11. Split P2, split P2-B and split GAT P2-B: split A and split B
    # (SAGE and GAT) at two partitions, one process each.
    launches_pb, gat_shuffle_rows = rank_phases(phase, graphs.name,
                                                opts.ranks)
    # 12. ddp, quiver and infer at the same number of ranks.
    launches_bl = baseline_rank_phases(phase, graphs.name, opts.ranks,
                                       infer_ref)
    graphs.cleanup()

    # 13. Summary: the kernel's numbers are one single step's three forward
    # shapes; its launches those of every phase's main-path run.
    def total(key):
        return sum(c[key] for c in main_cases)

    bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
    print("split op times (torch ops, split A's first batch; a step runs "
          "the synthesis once, the dense aggregation 3 times forward and "
          "2 times backward, slice_owned 3 times):")
    for op, ms, bound in op_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms")
    print("GAT op times (split GAT A's first batch; a step runs each layer's "
          "batched attention once forward and once backward):")
    for op, ms, bound in gat_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms")
    print("baseline op times (torch ops; pa-cache: the first batch's "
          "frame, once a step; quiver: its first batch, the draw once a "
          "layer, the gather and the layer-0 mean once a step):")
    for op, ms, bound in [pc_row] + quiver_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms")
    print(f"quiver: peak device memory {quiver['peak_gib']:.3f} GiB, "
          f"profiled step idle share "
          f"{quiver_profile['device_idle_share']:.4f}")
    print(f"GAT shuffle times (split GAT P{opts.ranks}-B, rank 0, host "
          f"clock; a step runs each once a layer):")
    for op, ms, bound, by in gat_shuffle_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms ({by})")
    for label, case in (("split B's layer 0", split_case),
                        ("split GAT B's layer 0", gat_split_case),
                        ("infer's layer 0", infer_case)):
        print(f"kernel at {label}: ms={case['ms']:.4f} bound_ms="
              f"{max(case['bytes_ms'], case['ops_ms']):.4f}")
    print(f"kernel at single GAT's step (3 launches): ms="
          f"{sum(c['ms'] for c in gat_cases):.4f} bound_ms="
          f"{sum(max(c['bytes_ms'], c['ops_ms']) for c in gat_cases):.4f} "
          f"plain_ms={sum(c['plain_ms'] for c in gat_cases):.4f} "
          f"index_add_ms={sum(c['library_ms'] for c in gat_cases):.4f}")
    kernels = [{
        "name": "segment_sum_sorted",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": (single_launches + launches_pc + launches_a
                     + launches_ga + launches_b + launches_sgl + launches_i1
                     + launches_pb + launches_bl),
        "max_abs_err": max(c["err"] for c in main_cases + ragged + gat_cases
                           + [split_case, gat_split_case, infer_case]),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": total("library_ms"),
    }]
    print(f"total wall {time.perf_counter() - wall:.1f}s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
