#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--num-nodes N] [--ranks N]

1. Prints the card (name and power limit), torch and CUDA versions, and
   builds every hand-written kernel (``csrc/segment_sum_sorted.cu`` and
   ``csrc/dense_gather_sum.cu``) and the C++ sampling service from the
   sources in the checkout, one compiler for each, all at once.
2. Builds the products-scale graph (2.45 M nodes, degree 25, 100 features,
   47 classes) once for the single path, split A and split GAT A, and
   samples the single path's first batch.
3. Holds the kernel's two entries, ``segment_sum_sorted`` (messages) and
   ``gather_segment_sum`` (the row gather fused in), against their plain
   PyTorch versions on the card: at the three shapes the first batch
   gives it, then on ragged cases (tiles cut every way, long rows, GAT's
   widths, bf16 frames). Each case checks two launches bit-equal and
   prints the max abs error, the kernel's time, the plain version's, one
   ``index_add_`` call's and one ``torch.segment_reduce`` call's
   (yardsticks the port never calls, timed in the kernel's own CUDA-graph
   harness), for the fused entry the gather-then-messages path it
   replaced (``as_run``), and the least time the card could take (the
   bound).
4. Checks that the first batch's logits through the kernel equal those of
   a plain forward written here, with the same weights.
5. Drives ``--mode single`` GraphSAGE training (3 layers, hidden 128,
   fan-out 10,10,25, batch 1024, 8 steps) through the port's
   ``train_single``, and checks the fused entry launched 3 times a step
   (SAGE, GCN, pa-cache, ddp, split B and infer call it; GAT calls the
   messages' entry; each run counts both).
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
   sample; times the split path's ops at the first batch's shapes beside
   their byte bounds; holds the dense gather-sum's two kernels,
   ``dense_gather_sum`` (forward) and ``dense_scatter_add`` (backward),
   against their plain versions at each layer of that batch (the forward
   bit-equal, also on the frame in bf16; the backward within 1e-4 of max
   |dx|), timed beside ``embedding_bag`` and the bound; then drives
   ``--mode split --cache-per auto`` (replicated cache, device innermost,
   C++ sampler; 8 steps) through ``train_split`` with one steady step
   profiled: the dense kernels 3 times forward and 2 times backward a
   step, no segment-sum.
   Split GAT A: the same with ``--model-name gat --num-hidden 32
   --num-heads 4`` (the JAX package's GAT bench widths): split vs single
   GAT logits, the batched attention's times forward and backward beside
   their byte bounds, 8 steps with one profiled, no kernel launch.
   The lowerings of ``ops/config.py`` on the same graph: layer 0 under
   ``OCC_DEVICE_SAMPLE=bitsf32``, ``bitsf32_dk`` and ``window`` (the
   doubled CSR) held to the sampling contract and timed; the layer-0
   aggregation under ``OCC_DENSE_AGG=tiled`` bit-equal to the unrolled
   one, then 3 steps of split A under it; split GAT A's first batch
   under ``OCC_GAT_ATTENTION=online`` and ``tiled``, ``OCC_GAT_AGG=fma``
   and ``OCC_GAT_REMAT=dots`` (logits and weight gradients within 1e-4
   of scale of the batched form's, the attention timed each way), then
   3 steps of each, ``train_step`` and peak beside batched's.
9. Split B, 200,000 nodes (depth cut for time, every width kept):
   ``--cache-per 0.25 --innermost host --fan-out 10,10,-1 --save-dir``,
   the refreshing cache with a COO layer 0. Checks the split-vs-single
   logits, that a step launched before a tail write reads the old tail,
   both entries at its layer 0 (and the fused one on a bf16 frame) and
   the dense kernels at its layers 1-2, one fused launch and two of each
   dense kernel a step, and one tail write a step. Then single GAT
   and single GCN on the same graph (3 steps each): 3 launches a step
   each. Split B's feed unpacked (``packed=False``): its first batch
   equal to the packed feed's field by field, then 3 steps (``sample``
   beside packed's). Single GCN with ``norm="sym"`` (3 steps, the model
   factory bound to it, as no flag selects it): the first batch's logits
   against a plain forward written here, the kernel at its three
   weighted-message shapes, 3 launches a step. Then ``--mode infer`` of split B's checkpoint on the test nodes
   (worst-case capacities, no cache): first its first batch's split
   logits against a plain forward written here with the same weights,
   and the kernel at that batch's layer-0 COO against its plain version;
   then the run, one launch a batch.
10. Split P2: split A's flags at ``--partitions 2 --partition-mode
   round_robin`` (metis took 109-123 s a rank on the products graph on
   the H100 host), placed as the CLI's launcher places them: one process
   holding both partitions on one card (one process per card on a
   machine with more), its exchange a copy in device memory with no
   collective. Checks 2 exchanges forward and 2 backward a step per
   partition, and that one raw sample's P = 2 logits of each local
   partition, the loss and the gradients equal P = 1's on the card.
11. Split P2-B: split B's flags at ``--partitions 2 --partition-mode
   metis``, 3 steps: the cache tails refresh per partition, layer 0 is
   COO through the kernel (one launch per partition a step) and shuffles
   forward only (3 forward, 2 backward a step). Split GAT P2-B: the same
   with GAT, whose layers each run the reverse shuffle and the softmax
   merge both ways (6 forward, 6 backward a step), and the two shuffles'
   times at the run's own capacities. Both with the P vs P = 1 check of
   split P2 (the P = 2 sample sliced at the capacities the run trained
   at). Split P2-B gloo: the same run as two ``--distributed`` processes
   of one partition on one card over gloo: its global loss within 1e-5 of
   scale of the one-process run's, its accuracy equal, and the two
   exchanges' times a call side by side (CUDA events in one process, the
   host clock over gloo).
   Split P4-B local: split B at ``--partitions 4`` in one process (8
   steps, one profiled, a checkpoint): the P vs P = 1 check, 4 fused
   launches a step (and 8 of each dense kernel), the exchange's device
   time a call, both kernel entries at its layer 0 and the dense kernels
   at its layers 1-2 against their plain versions. Split GAT P4-B
   local (3 steps, 4 launches of the messages' entry a step). Infer P4
   local of that checkpoint against infer P1 of it (99.9 % of the
   predictions). Then ``occ_gnn_tpu_torch.entry``: ``entry()``'s forward
   on the card and ``dryrun_multichip(4)`` (three finite losses). On a
   machine with several cards, split P(2N)-B over NCCL: N = ``--ranks``
   processes of 2 partitions, held against P = 1.
12. DDP P2 (the products graph) and quiver P2 (split B's graph), 3
   steps each, placed as the CLI's launcher places them on one card: one
   process holding both shards, no process group, no collective. ddp
   launches the fused entry 3 times a step a shard, and one step's
   gradient over both shards is held against one process summing the
   shard batches through the kernel forward, and that against the plain
   forward's at the same ReLU masks, at the run's measured capacities;
   quiver launches no kernel. Beside each, the same flags as two
   ``--distributed`` processes of one shard sharing the card over gloo,
   the path this replaces: global loss within 1e-5 of scale of the
   one-process run's, accuracy and steps equal, final weights within
   1e-4 of scale, and the two runs' ``train_step``, step wall and peak
   memory side by side. On a machine with several cards, ddp and quiver
   P(2N) as N = ``--ranks`` processes of 2 shards over NCCL against one
   process of 2N (ddp with the gradient check). Infer P2 (split B's
   graph, ``--partition-mode round_robin``), two ranks: equal global
   metrics on every rank, one launch a batch per rank, the P = 1 count
   and at least 99.9 % of its predictions.
13. Prints the kernels' times at every main-path shape, the card again,
   one JSON line of kernel numbers (one object each for the segment-sum's
   two entries and the two dense kernels), and last ``{"ok": true,
   "device": {...}}``. Every phase's run checks the launches of each
   kernel its path calls: a split SAGE or GCN step launches the dense
   kernels once a dense layer forward and once a dense layer past layer 0
   backward, per partition (``SPLIT_A_STEP``, ``SPLIT_B_STEP``), an
   inference batch once a dense layer (``INFER_BATCH``).

Any failed check raises, so the script exits non-zero and prints no result.
It also fails when torch sees no CUDA device, and outside the repository.
``--num-nodes`` cuts the products graph for a quick run; every width stays.
``--ranks N`` sets the processes of infer's step-12 phase (default 2)
and of the NCCL phases of steps 11 and 12, which run on a machine with
several cards and stop when it has fewer than N; on a machine with a
card for every rank, the ranks run over NCCL. ``--baselines-only``
runs step 12 alone (with split B's run and the P = 1 inference it
needs) and prints no result; ``--split-nccl-only`` runs the NCCL phase
of step 11 alone (on several cards) and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import partial

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
from occ_gnn_tpu_torch import models as models_pkg
from occ_gnn_tpu_torch.models import GCNModel, get_model
from occ_gnn_tpu_torch.ops import config as ops_config
from occ_gnn_tpu_torch.ops.build import (
    KERNELS,
    build_kernel,
    build_partitioner,
    build_sampler,
)
from occ_gnn_tpu_torch.ops.dense_gather_sum import (
    dense_gather_sum,
    dense_gather_sum_reference,
    dense_scatter_add,
    dense_scatter_add_reference,
)
from occ_gnn_tpu_torch.ops.segment_sum_sorted import (
    TILE_EDGES,
    gather_segment_sum,
    gather_segment_sum_backward,
    gather_segment_sum_reference,
    segment_sum_sorted,
    segment_sum_sorted_reference,
)
from occ_gnn_tpu_torch.parallel import dist
from occ_gnn_tpu_torch.parallel.dp import make_dp_train_step
from occ_gnn_tpu_torch.parallel.model import (
    ATTENTION,
    SplitGAT,
    SplitSAGE,
    checkpoint_dots,
    dense_attention,
    make_device_csr,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.parallel.split import (
    DENSE_TILE,
    collective_count,
    local_aggregate_dense,
    reset_shuffle_counts,
    reverse_shuffle,
    shuffle_counts,
    shuffle_merge,
    shuffle_softmax_merge,
    slice_owned,
    synthesize_device_innermost,
)
from occ_gnn_tpu_torch.sampling.device_sampler import (
    DeviceSampleTrainer,
    sample_neighbors_dense,
)
from occ_gnn_tpu_torch.sampling import native as native_mod
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
# 3 steps of a batch of 1024 (the flags after COMMON_FLAGS win).
SHORT = ["--limit-train", "3072"]
# The baselines at the single path's widths: pa-cache and quiver on the
# products graph, ddp at --partitions 2 on it, quiver at 2 on split B's
# graph.
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
# The sorted segment-sum's two entries and the dense gather-sum's two
# kernels, each with its own launch count.
MSGS, FUSED = "segment_sum_sorted", "gather_segment_sum"
DENSE_FWD, DENSE_BWD = "dense_gather_sum", "dense_scatter_add"
ENTRIES = {MSGS: segment_sum_sorted, FUSED: gather_segment_sum,
           DENSE_FWD: dense_gather_sum, DENSE_BWD: dense_scatter_add}
# Sorted segment-sum launches a step: one a layer. Single SAGE and GCN
# (either norm) sum the rows of their frame through the fused gather; GAT
# (single, and split on its COO layer 0) sums the softmax denominators and
# the weighted messages as one [p, p * feat] through the messages' entry.
SINGLE_LAUNCHES = {"sage": 3, "gcn": 3, "gat": 3, "gcn sym": 3}
SINGLE_ENTRY = {"sage": FUSED, "gcn": FUSED, "gat": MSGS, "gcn sym": FUSED}
# Launches of the split paths a step per partition (inference: a batch
# per partition). Every dense layer (a finite fan-out) runs the dense
# gather-sum once forward and its scatter-add once backward, but layer 0,
# whose frame takes no gradient; a COO layer 0 (fan-out -1) runs the fused
# entry (SAGE) or the messages' entry (GAT, whose dense layers run its
# attention, no kernel).
SPLIT_A_STEP = {DENSE_FWD: 3, DENSE_BWD: 2}
SPLIT_B_STEP = {FUSED: 1, DENSE_FWD: 2, DENSE_BWD: 2}
GAT_B_STEP = {MSGS: 1}
INFER_BATCH = {FUSED: 1, DENSE_FWD: 2}
# The processes of infer's P > 1 phase and of the NCCL phases.
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
# The dense scatter-add against its plain version, relative to max |dx|
# (at least 1): both add with atomics in an order that changes from run to
# run, and the zero row sums every padding slot's gradient row (tens of
# thousands at layer 1), whose rounding grows with their count.
DENSE_BWD_TOL = 1e-4
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

KERNEL_SOURCE = {
    MSGS: "occ_gnn_tpu_torch/csrc/segment_sum_sorted.cu",
    FUSED: "occ_gnn_tpu_torch/csrc/segment_sum_sorted.cu",
    DENSE_FWD: "occ_gnn_tpu_torch/csrc/dense_gather_sum.cu",
    DENSE_BWD: "occ_gnn_tpu_torch/csrc/dense_gather_sum.cu",
}
DENSE_REPLACES = ("occ_gnn_tpu/parallel/split.py:161-197 (XLA fusion, no "
                  "pallas_call)")
KERNEL_REPLACES = {
    MSGS: "occ_gnn_tpu/ops/pallas_spmm_blocked.py:190",
    FUSED: "occ_gnn_tpu/ops/pallas_spmm_blocked.py:190 and :213",
    DENSE_FWD: DENSE_REPLACES,
    DENSE_BWD: DENSE_REPLACES,
}


def reset_launches() -> None:
    for fn in ENTRIES.values():
        fn.launches = 0


def read_launches() -> Counter:
    return Counter({name: fn.launches for name, fn in ENTRIES.items()})


def launch_text(launches) -> str:
    return ", ".join(f"{name} launches {launches.get(name, 0)}"
                     for name in ENTRIES)


def scaled(per, n: int) -> dict:
    """Launches ``per`` (entry -> count) ``n`` times over."""
    return {entry: count * n for entry, count in per.items()}


def expect_launches(label, launches, want, what) -> None:
    """Raise unless every kernel launched as many times in the run as
    ``want`` (entry -> count) says, and the others never."""
    if +Counter(launches) != +Counter(want):
        raise AssertionError(f"{label}: {launch_text(launches)} for {what}; "
                             f"expected {launch_text(want)}")


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


def median_ms(fn, reps: int = GRAPH_REPS, runs: int = TIMED_RUNS) -> float:
    """Median over ``runs`` of one call's device time. ``fn`` is captured
    ``reps`` times into one CUDA graph and each run replays the graph
    between two CUDA events, so the host's launch time is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    graph.reset()
    return statistics.median(s.elapsed_time(e) / reps for s, e in events)


def yardstick_ms(fn) -> float:
    """``median_ms`` of a slow plain yardstick (milliseconds a call): one
    call a graph, the median of 5 replays."""
    return median_ms(fn, reps=1, runs=5)


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


def kernel_cases(label, x, edge_src, edge_dst, n, rate, weight=None,
                 entries=(MSGS, FUSED), msgs=None):
    """The kernel's entries on one shape, each against its plain version
    (within KERNEL_TOL) and bit-equal over two launches: the messages'
    entry on ``x[edge_src]`` in f32 (times ``weight``, as the callers
    write it; ``msgs`` when given, the same values laid out otherwise),
    the fused entry on ``x`` itself. Every time is a CUDA-graph
    replay (``median_ms``; the plain versions and ``index_add_``, tens of
    ms at the large shapes, through ``yardstick_ms``), ``segment_reduce``
    too. Returns {entry: case}."""
    h = x.shape[1]
    valid = int((edge_dst < n).sum())
    if msgs is None:
        msgs = x.index_select(0, edge_src).float()
        if weight is not None:
            msgs = msgs * weight[:, None]
    ref = segment_sum_sorted_reference(msgs, edge_dst, n)
    dst_long = edge_dst.long()
    # The library yardsticks over the valid rows (the padding tail sorts
    # last), with each segment's length on the device.
    lengths = torch.bincount(dst_long[:valid], minlength=n)
    index_add_ms = yardstick_ms(
        lambda: torch.zeros(n + 1, h, device=x.device).index_add_(
            0, dst_long, msgs))
    reduce_ms = median_ms(lambda: torch.segment_reduce(
        msgs[:valid], "sum", lengths=lengths, unsafe=True))
    src_valid = edge_src[:valid]

    def as_run():  # the gather as written before the fused entry
        m = x.index_select(0, edge_src).float()
        return segment_sum_sorted(m if weight is None else m * weight[:, None],
                                  edge_dst, n)

    def library():
        rows = x.index_select(0, src_valid).float()
        if weight is not None:
            rows = rows * weight[:valid, None]
        return torch.segment_reduce(rows, "sum", lengths=lengths, unsafe=True)

    runs = {
        MSGS: (lambda: segment_sum_sorted(msgs, edge_dst, n),
               lambda: segment_sum_sorted_reference(msgs, edge_dst, n)),
        FUSED: (lambda: gather_segment_sum(x, edge_src, edge_dst, n, weight),
                lambda: gather_segment_sum_reference(x, edge_src, edge_dst, n,
                                                     weight)),
    }
    cases = {}
    for entry in entries:
        kernel, plain = runs[entry]
        out, again = kernel(), kernel()
        torch.cuda.synchronize()
        if out.shape != (n, h) or not torch.isfinite(out).all():
            raise AssertionError(f"{label}: bad {entry} output "
                                 f"{tuple(out.shape)}")
        err = (out - ref).abs().max().item() if out.numel() else 0.0
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{label}: {entry} differs from its plain "
                                 f"version by {err} > {KERNEL_TOL}")
        if not torch.equal(out, again):
            raise AssertionError(f"{label}: two launches of {entry} on the "
                                 f"same inputs differ")
        case = dict(err=err, ms=median_ms(kernel), plain_ms=yardstick_ms(plain),
                    index_add_ms=index_add_ms, reduce_ms=reduce_ms)
        if entry == MSGS:
            # Each valid message row and its edge_dst entry read once, out
            # written once; one add per valid element.
            nbytes = 4 * (valid * h + valid + n * h)
            ops = valid * h
            case["library_ms"] = reduce_ms
            extra = ""
        else:
            # Each x row a valid edge names read once (in its own type),
            # each valid edge's src, dst (and weight) once, out written
            # once; one add (and one multiply) per gathered element.
            rows = torch.unique(src_valid).numel()
            nbytes = (rows * h * x.element_size() + 4 * n * h
                      + valid * (12 if weight is not None else 8))
            ops = valid * h * (2 if weight is not None else 1)
            case["as_run_ms"] = median_ms(as_run)
            case["library_ms"] = median_ms(library)
            extra = (f" as_run_ms={case['as_run_ms']:.4f} library_ms="
                     f"{case['library_ms']:.4f} (gather + segment_reduce)"
                     f" x_rows_read={rows}")
        case["bytes_ms"] = nbytes / rate * 1e3
        case["ops_ms"] = ops / F32_RATE * 1e3
        bound = max(case["bytes_ms"], case["ops_ms"])
        by = "bytes" if case["bytes_ms"] >= case["ops_ms"] else "operations"
        print(f"kernel {entry} {label}: E={edge_dst.shape[0]} valid={valid} "
              f"D={n} H={h} x {str(x.dtype)[6:]}"
              f"{' weighted' if weight is not None else ''} "
              f"max_abs_err={err:.3g} bit-equal ms={case['ms']:.4f} "
              f"plain_ms={case['plain_ms']:.4f} index_add_ms="
              f"{index_add_ms:.4f} segment_reduce_ms={reduce_ms:.4f}{extra} "
              f"bound_ms={bound:.4f} ({by}, {100 * bound / case['ms']:.1f} "
              f"% of it)")
        cases[entry] = case
    return cases


def backward_case(label, blk, h, rate, gen):
    """The fused entry's backward (torch ops: the gather of the output
    gradient's rows, then ``index_add_`` into the frame) at one block's
    shape, beside its byte bound: the gradient and the indices read once,
    the frame's gradient written once. Returns (label, ms, bound_ms)."""
    grad = torch.randn(blk.dst_cap, h, generator=gen,
                       device=blk.edge_dst.device)
    ms = median_ms(lambda: gather_segment_sum_backward(
        grad, blk.edge_src, blk.edge_dst, blk.dst_cap, blk.src_cap))
    valid = int((blk.edge_dst < blk.dst_cap).sum())
    bound = 4 * ((blk.dst_cap + blk.src_cap) * h + 2 * valid) / rate * 1e3
    print(f"kernel {FUSED} backward (torch ops) {label}: E={blk.edge_cap} "
          f"valid={valid} D={blk.dst_cap} S={blk.src_cap} H={h} ms={ms:.4f} "
          f"bound_ms={bound:.4f} (bytes)")
    return label, ms, bound


def dense_cases(label, x, nbr, rate, gen, backward=True):
    """The dense gather-sum's two kernels on one layer's shape against
    their plain versions: the forward bit-equal to its plain version and
    over two launches; the backward (``backward``) within DENSE_BWD_TOL of
    max |dx| of its plain version, and two launches within the same bound
    of each other (atomics). Each is timed in the CUDA-graph harness
    (``median_ms``; the plain versions, 2K and K launches, one call a
    graph) beside ``embedding_bag`` (f32 frames: the same sums, its
    ``[D, K]`` index transposed ahead of the timing; its backward through
    ``torch.autograd.grad``, timed with its forward in one graph, less the
    forward's time) and the byte bound. Returns {kernel: case}."""
    K, D = nbr.shape
    S, H = x.shape
    xb = x.element_size()
    valid = int((nbr != S - 1).sum())
    rows = torch.unique(nbr).numel()
    out, again = dense_gather_sum(x, nbr), dense_gather_sum(x, nbr)
    ref = dense_gather_sum_reference(x, nbr)
    torch.cuda.synchronize()
    if out.shape != (D, H) or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: bad {DENSE_FWD} output "
                             f"{tuple(out.shape)}")
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    if not torch.equal(out, ref):
        raise AssertionError(f"{label}: {DENSE_FWD} differs from its plain "
                             f"version (max abs {err}); it must be "
                             f"bit-equal")
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two launches of {DENSE_FWD} differ")
    f32 = x.dtype == torch.float32
    bags = nbr.t().contiguous().long() if f32 else None
    # nbr read once, each x row it names once in its own type (padding
    # slots name the one zero row), out written once; one add a valid
    # slot's element.
    cases = {DENSE_FWD: dict(
        err=err, ms=median_ms(lambda: dense_gather_sum(x, nbr)),
        plain_ms=yardstick_ms(lambda: dense_gather_sum_reference(x, nbr)),
        library_ms=median_ms(lambda: torch.nn.functional.embedding_bag(
            bags, x, mode="sum")) if f32 else None,
        bytes_ms=(4 * K * D + xb * rows * H + 4 * D * H) / rate * 1e3,
        ops_ms=valid * H / F32_RATE * 1e3)}
    if backward:
        g = torch.randn(D, H, generator=gen, device=x.device)
        dx, dx2 = dense_scatter_add(g, nbr, S), dense_scatter_add(g, nbr, S)
        ref_dx = dense_scatter_add_reference(g, nbr, S)
        torch.cuda.synchronize()
        scale = max(1.0, ref_dx.abs().max().item())
        err = (dx - ref_dx).abs().max().item()
        again = (dx - dx2).abs().max().item()
        if not (torch.isfinite(dx).all() and err <= DENSE_BWD_TOL * scale
                and again <= DENSE_BWD_TOL * scale):
            raise AssertionError(f"{label}: {DENSE_BWD} differs from its "
                                 f"plain version by {err} (two launches by "
                                 f"{again}) at scale {scale}")
        library = None
        if f32:
            # Autograd runs a backward on its forward's stream, so both go
            # into the graph; the forward's own time is taken off.
            xr = x.detach().clone().requires_grad_()
            library = median_ms(lambda: torch.autograd.grad(
                torch.nn.functional.embedding_bag(bags, xr, mode="sum"), xr,
                g)) - cases[DENSE_FWD]["library_ms"]
        # g and nbr read once, dx written once; one add a slot's element.
        cases[DENSE_BWD] = dict(
            err=err, scale=scale, ms=median_ms(
                lambda: dense_scatter_add(g, nbr, S)),
            plain_ms=yardstick_ms(
                lambda: dense_scatter_add_reference(g, nbr, S)),
            library_ms=library,
            bytes_ms=(4 * K * D + 4 * D * H + 4 * S * H) / rate * 1e3,
            ops_ms=K * D * H / F32_RATE * 1e3)
    for name, c in cases.items():
        bound = max(c["bytes_ms"], c["ops_ms"])
        by = "bytes" if c["bytes_ms"] >= c["ops_ms"] else "operations"
        lib = ("n/a (bf16 frame)" if c["library_ms"] is None
               else f"{c['library_ms']:.4f}")
        check = ("bit-equal" if name == DENSE_FWD else
                 f"(limit {DENSE_BWD_TOL * c['scale']:.3g})")
        print(f"kernel {name} {label}: K={K} D={D} S={S} H={H} x "
              f"{str(x.dtype)[6:]} valid={valid} x_rows_read={rows} "
              f"max_abs_err={c['err']:.3g} "
              f"{check} ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
              f"embedding_bag_ms={lib} bound_ms={bound:.4f} ({by}, "
              f"{100 * bound / c['ms']:.1f} % of it)")
    return cases


def split_dense_cases(label, layers, x0, hidden, rate, device):
    """``dense_cases`` at every dense layer of one partition's batch:
    ``layers[i]`` with an ``nbr_idx``; layer 0 reads ``x0`` (a frame: no
    backward), later layers a random f32 frame of ``hidden`` columns.
    Returns {layer: cases}."""
    gen = torch.Generator(device).manual_seed(9)
    out = {}
    for i, lyr in enumerate(layers):
        if lyr.nbr_idx is None:
            continue
        x = x0 if i == 0 else torch.randn(lyr.src_cap, hidden, generator=gen,
                                          device=device)
        out[i] = dense_cases(f"{label} layer {i}", x, lyr.nbr_idx, rate, gen,
                             backward=i > 0)
    return out


def ragged_cases(device):
    """``kernel_cases`` arguments at the kernel's edges: rows of
    TILE_EDGES-edge tiles cut every way, long rows, empty runs, widths of
    every load path, bf16 frames, rows off 16-byte alignment."""
    rng = np.random.default_rng(7)
    both = (MSGS, FUSED)

    def case(label, dst_valid, num_edges, n, h, rows=3000, integers=False,
             dtype=torch.float32, entries=both):
        dst = np.full(num_edges, n, np.int32)
        dst[: dst_valid.shape[0]] = np.sort(dst_valid)
        src = rng.integers(0, rows, num_edges).astype(np.int32)
        if integers:
            x = rng.integers(-8, 9, (rows, h)).astype(np.float32)
        else:
            x = rng.standard_normal((rows, h)).astype(np.float32)
        return dict(label=label, x=torch.from_numpy(x).to(device, dtype),
                    edge_src=torch.from_numpy(src).to(device),
                    edge_dst=torch.from_numpy(dst).to(device), n=n,
                    entries=entries)

    T = TILE_EDGES
    yield case("E=0", np.zeros(0, np.int32), 0, 16, 8)
    yield case("all padding", np.zeros(0, np.int32), 1000, 50, 32)
    yield case("num_segments=1", np.zeros(400, np.int32), 500, 1, 64)
    # GAT's COO message [p, p * feat] a head, 4 heads: 132 = 4 x (32 + 1)
    # on hidden layers, 192 = 4 x (47 + 1) on the last; 101 and 3 take the
    # one-element path, the rest 16-byte loads.
    for h in (1, 3, 4, 100, 101, 128, 132, 188, 192):
        yield case(f"H={h}", rng.integers(0, 777, 15000), 20000, 777, h)
    # bf16 frames: 8-byte loads (H = 100, 188) and one element (101).
    for h in (100, 101, 188):
        yield case(f"bf16 H={h}", rng.integers(0, 777, 15000), 20000, 777, h,
                   dtype=torch.bfloat16, entries=(FUSED,))
    # Rows cut by tiles: small-integer rows (as for the 10000-edge row
    # below) keep the long sums exact whatever their order.
    yield case("a row over five tiles", np.concatenate(
        [np.full(5 * T + 7, 3), rng.integers(0, 50, 900)]), 2000, 50, 100,
        integers=True)
    yield case("rows cut at tile edges", np.concatenate(
        [np.repeat(np.arange(40), T // 2), np.full(2 * T, 41)]),
        40 * T // 2 + 2 * T + 10, 45, 100, integers=True)
    # One tile's edges between runs of empty rows longer than a tile.
    yield case("empty runs around tiles",
               np.repeat(3 * T * np.arange(8), T), 8 * T + 20, 30 * T, 64)
    # Small-integer rows: every partial sum is exact in f32, so the
    # 10000-term row is held to equality whatever the summation order
    # (normal draws would differ by ~1e-3 from rounding alone). The
    # bf16 frame holds the same integers exactly.
    long_row = np.concatenate([np.full(10000, 2), np.repeat([0, 1, 3, 4], 100)])
    yield case("segment of 10000 edges", long_row, 10600, 5, 128,
               integers=True)
    yield case("bf16 segment of 10000 edges", long_row, 10600, 5, 128,
               integers=True, dtype=torch.bfloat16, entries=(FUSED,))
    yield case("empty segments between full ones",
               3 * rng.integers(0, 333, 8000), 9000, 999, 100)
    # A 4-byte offset takes the one-element path although H % 4 == 0, for
    # the frame and for the messages.
    c = case("unaligned rows", rng.integers(0, 300, 5000), 5000, 300, 4)

    def off_by_one(t):
        flat = torch.empty(t.numel() + 1, device=device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    c["msgs"] = off_by_one(c["x"].index_select(0, c["edge_src"]))
    c["x"] = off_by_one(c["x"])
    yield c


def plain_forward(model, batch, x0, masks=None, pre=None):
    """SAGE forward written with the plain segment-sum, as a reference.
    ``masks`` (one bool tensor a hidden layer) stand in for the ReLU's own
    ``x > 0``; ``pre``, a list, receives the hidden pre-activations."""
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
            if pre is not None:
                pre.append(x.detach())
            x = x * masks[i] if masks is not None else torch.relu(x)
    return x


def kernel_preactivations(model, batch, x0):
    """The hidden pre-activations of a SAGE model's own forward (through
    the kernel), layer by layer: bit for bit those its training step
    sees, as the forward is deterministic."""
    out, x = [], x0
    with torch.no_grad():
        for i, blk in enumerate(batch.blocks[:-1]):
            x = model.layer(i, blk, x)
            out.append(x)
            x = torch.relu(x)
    return out


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
    """One layer 0 synthesized on the card from the resident CSR (the
    layout ``OCC_DEVICE_SAMPLE`` selects), held to the sampling contract
    against the graph's own CSR: slot 0 is the self row, every other used
    slot a true neighbour, unused slots the zero row, rows with deg <=
    fanout the adjacency in order, and owned_deg == take + 1. Returns the
    native batch, its synthesized layer 0 and the CSR for the op
    timings."""
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
    indptr, indices = (torch.from_numpy(a).to(device).long()
                       for a in (g.indptr, g.indices))
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
    """The split path's ops at the first batch's shapes: device ms per
    call, calls a step, and the byte bound (each input read once, each
    output written once: each frame row nbr names once, padding slots
    naming the one zero row). Layer 0 reads the frame, which takes no
    gradient."""
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
        x_rows = torch.unique(nbr).numel()
        add(f"local_aggregate_dense fwd, layer {i} (K={K}, D={D}, H={H})",
            lambda: local_aggregate_dense(x, nbr),
            4 * K * D + xb * x_rows * H + 4 * D * H)
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


def gat_op_times(batch, syn, frames, args, num_classes, rate, device,
                 attend=dense_attention, label="dense_attention",
                 backward_once=False):
    """GAT's dense attention (``attend``: the batched ``dense_attention``,
    or another lowering of the same function) at split GAT A's first
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
        add(f"{label} fwd, layer {i} (K={K}, D={D}, H={H}, "
            f"heads={heads}, Dh={dh})",
            lambda: attend(x, nbr, wl, w3, er),
            leaves + 4 * D * heads + 4 * D * heads * (2 + dh))
        fwd_ms = rows[-1][1]
        _, s, v = attend(x, nbr, wl, w3, er)
        grads = (torch.randn_like(s), torch.randn_like(v))
        inputs = [wl, w3, er] + ([x] if x.requires_grad else [])
        dx = 4 * F * H if x.requires_grad else 0
        bwd_bytes = leaves + 4 * D * heads * (1 + dh) + 4 * D * heads + dx
        if backward_once:
            # A selective checkpoint runs its backward once: time forward
            # and backward together, and count the forward's time off.
            ms = events_ms(lambda: torch.autograd.grad(
                attend(x, nbr, wl, w3, er)[1:], inputs, grads)) - fwd_ms
            rows.append((f"{label} bwd, layer {i}", ms,
                         bwd_bytes / rate * 1e3))
            print(f"  op {label} bwd, layer {i}: ms={ms:.4f} (forward and "
                  f"backward less the forward) bound_ms="
                  f"{bwd_bytes / rate * 1e3:.4f} (bytes)")
        else:
            add(f"{label} bwd, layer {i}",
                lambda: torch.autograd.grad((s, v), inputs, grads,
                                            retain_graph=True), bwd_bytes)
        del s, v, grads
    return rows


def host_ms(fn, device, runs: int = 10) -> float:
    """Mean host time of one call over ``runs`` calls, the device drained
    before and after (a gloo all-to-all blocks the host)."""
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize(device)
    return 1e3 * (time.perf_counter() - t0) / runs


def gat_shuffle_times(batch, args, num_classes, rate, backend, device,
                      runs: int = 10) -> list:
    """``reverse_shuffle`` and ``shuffle_softmax_merge``, forward and
    backward, at one P > 1 batch's shapes in this process (its L
    partitions, sliced at the capacities the run trained at): host ms per
    call (a gloo all-to-all blocks the host), every process in the same
    order. The bound is the larger of the device bytes of the op's inputs
    and outputs (frames, partials, gradients, index tensors), each once,
    over the memory rate, and the link's: over gloo, the host copies of
    the all-to-all's buffer (sent to the host and received from it, the
    two directions overlapped) over PCIE_RATE, leaving out gloo's exchange
    through host memory; over NCCL, the chunks for the other processes
    over NVLINK_RATE; in one process there is no link."""
    gen = torch.Generator(device).manual_seed(9)
    heads, hidden = args.num_heads, args.num_hidden
    link, link_rate = (("NVLink", NVLINK_RATE) if backend == "nccl"
                       else ("host copies", PCIE_RATE))
    outs = [hidden] * (len(batch.layers) - 1) + [num_classes]
    rows = []

    def rand(*shape, grad=False):
        return torch.randn(*shape, generator=gen, device=device
                           ).requires_grad_(grad)

    for i, lyr in enumerate(batch.layers):
        push, recv = lyr.push_idx, lyr.recv_idx
        L, P = push.shape[:2]
        D, dh = lyr.dst_cap, outs[i]
        W = P // L
        # Rows of the all-to-all buffer the link carries: all of them to
        # and from the host, the other processes' chunks over NVLink.
        link_rows = (0 if W == 1 else
                     push.numel() * ((W - 1) / W if backend == "nccl" else 1))
        idx = 2 * 4 * push.numel()
        frame = rand(L, D, heads, grad=True)
        er = reverse_shuffle(frame, push, recv)
        g_er = torch.randn_like(er)
        m = rand(L, D, heads)
        s = rand(L, D, heads, grad=True)
        v = rand(L, D, heads, dh, grad=True)
        so, vo = shuffle_softmax_merge(m, s, v, push, recv)
        g_sv = (torch.randn_like(so), torch.randn_like(vo))
        sv = 4 * L * D * heads * (1 + dh)
        # The all-to-all buffer [L * P * S, width] f32: er's heads;
        # (m, s, v) forward, (s, v) backward.
        for name, fn, nbytes, width in (
                ("reverse_shuffle fwd",
                 lambda: reverse_shuffle(frame, push, recv),
                 idx + 2 * 4 * L * D * heads, heads),
                ("reverse_shuffle bwd",
                 lambda: torch.autograd.grad(er, frame, g_er,
                                             retain_graph=True),
                 idx + 2 * 4 * L * D * heads, heads),
                ("shuffle_softmax_merge fwd",
                 lambda: shuffle_softmax_merge(m, s, v, push, recv),
                 idx + 4 * L * D * heads + 2 * sv, heads * (2 + dh)),
                ("shuffle_softmax_merge bwd",
                 lambda: torch.autograd.grad((so, vo), (s, v), g_sv,
                                             retain_graph=True),
                 idx + 2 * sv + 4 * (L * D + push.numel()) * heads,
                 heads * (1 + dh))):
            device_ms = 1e3 * nbytes / rate
            link_ms = 1e3 * 4 * link_rows * width / link_rate
            rows.append((f"{name}, layer {i} (P={P}, L={L}, "
                         f"S={push.shape[2]}, D={D}, heads={heads}, "
                         f"Dh={dh})", host_ms(fn, device, runs),
                         max(device_ms, link_ms),
                         link if link_ms >= device_ms else "bytes"))
    return rows


def exchange_times(batch, hidden: int, feature_dim: int, grouped: bool,
                   device) -> list:
    """``shuffle_merge`` forward, one call, at each shuffled layer of one
    P > 1 batch of this process (its L partitions' partial sums, random):
    device ms per call between CUDA events in a run of one process, where
    the exchange is a copy in device memory; host ms across processes,
    where the all-to-all blocks the host (gloo) or the device (NCCL)."""
    gen = torch.Generator(device).manual_seed(11)
    rows = []
    for i, lyr in enumerate(batch.layers):
        if lyr.push_idx is None:
            continue
        L, P, S = lyr.push_idx.shape
        h = feature_dim if i == 0 else hidden
        neigh = torch.randn(L, lyr.dst_cap, h, generator=gen, device=device)

        def fn():
            return shuffle_merge(neigh, lyr.push_idx, lyr.recv_idx)

        ms = host_ms(fn, device) if grouped else events_ms(fn)
        rows.append(dict(layer=i, P=P, L=L, S=S, D=lyr.dst_cap, H=h, ms=ms,
                         clock="host" if grouped else "CUDA events"))
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
    set to 0 just before; returns the metrics and the kernel's launches
    by entry."""
    timers = StepTimers()
    start_count(device)
    metrics = train_split(args, g, fanouts, timers, device)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = metrics["steps"]
    print(f"{label}: {steps} steps, loss {metrics['loss']:.4f}, acc "
          f"{metrics['acc']:.4f}, cache {metrics['cache_pct']:.4f}, "
          f"innermost {metrics['innermost']}, sampler {metrics['sampler']}, "
          f"{launch_text(launches)}, tail writes "
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
    metrics["medians"] = {phase: statistics.median(each[1:] or each)
                          for phase, each in timers.each.items()}
    metrics["peak_gib"] = peak_gib
    return metrics, launches


def check_vs_one_partition(ranks, g, args, fanouts, cache_pct, caps2,
                           device):
    """One raw sample of the numpy SplitSampler sliced at P (this
    process's rows ``[lo, hi)``, its partition map, the capacities
    ``caps2`` the run trained at) and at P = 1, with the same weights of
    the flags' model (SAGE or GAT): each local partition's owned logits,
    the global loss and every all-reduced gradient against the P = 1
    computation, and whether all are finite. Returns the errors and this
    process's P batch. At P the process holds its partitions' frames
    under the phase's ``cache_pct`` (static rows plus the tail this
    sample writes when the cache refreshes); at P = 1 the frame holds
    every node. Each error is relative to the largest magnitude of the
    P = 1 tensor it is held to."""
    lo, hi, P = ranks.lo, ranks.hi, ranks.num_partitions
    pmap, nodes, bs = g.partition_map, g.train_nodes(), args.batch_size
    cache2 = SplitFeatureCache(
        CachePlan(g, pmap, P, cache_pct, refresh_cap=caps2["frame_caps"][0]),
        device=device, partitions=(lo, hi))
    s2 = SplitSampler(g, nodes, pmap, P, fanouts, bs, seed=0, cache=cache2,
                      capacities=caps2, emit_range=(lo, hi), device=device)
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
    x1 = (x2[:1] if cache2.plan.replicated
          else SplitFeatureCache(plan1, device=device).frames)
    m2 = split_model(args, g).to(device)
    m1 = copy.deepcopy(m2)
    logits2 = make_split_forward(m2, ranks=ranks)(b2, x2)
    logits1 = make_split_forward(m1)(b1, x1)[0]
    loss2, _, count = make_split_train_step(
        m2, torch.optim.SGD(m2.parameters(), lr=0.0), ranks=ranks)(b2, x2)
    loss1, _, _ = make_split_train_step(
        m1, torch.optim.SGD(m1.parameters(), lr=0.0))(b1, x1)

    def rel(a, b):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        return err / scale if scale > 0 else err

    owners = pmap[raw[0].frontier]
    targets, logits_err = 0, 0.0
    for j, p in enumerate(range(lo, hi)):
        rows = np.nonzero(owners == p)[0]
        targets += int(rows.shape[0])
        ref = logits1[torch.from_numpy(rows).to(device)]
        logits_err = max(logits_err, rel(logits2[j, : rows.shape[0]], ref))
    check = dict(targets=targets, count=int(count), logits_err=logits_err,
                 loss_err=rel(loss2, loss1),
                 grad_err=max(rel(p2.grad, p1.grad) for p2, p1 in
                              zip(m2.parameters(), m1.parameters())),
                 all_finite=bool(torch.isfinite(logits2).all() and all(
                     torch.isfinite(p.grad).all() for p in m2.parameters())))
    return check, b2


def split_process(ranks, spec) -> dict:
    """What one process of a P > 1 phase measures, with the placement
    ``ranks`` (``[lo, hi)`` of P): loads the saved graph and drives
    ``train_split`` with the counts set to 0 just before and read just
    after; then ``check_vs_one_partition`` under the phase's cache, the
    exchange's time a call at the batch's shapes and, for GAT, the two
    GAT shuffles' times. JSON-ready."""
    device = ranks.device
    args = build_argparser().parse_args(
        ["--graph", spec["name"], "--data-root", spec["root"]]
        + spec["flags"])
    fanouts = [int(f) for f in args.fan_out.split(",")]
    g = load_graph(spec["root"], spec["name"])
    timers = StepTimers()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    reset_shuffle_counts()
    metrics = train_split(args, g, fanouts, timers, device,
                          ranks=ranks if ranks.grouped else None)
    out = dict(rank=ranks.rank, local=[ranks.lo, ranks.hi], metrics=metrics,
               edge_cut=edge_cut_fraction(g, g.partition_map),
               launches=dict(read_launches()), shuffles=shuffle_counts(),
               collectives=collective_count(),
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               phase_lines=phase_lines(timers, metrics["steps"]),
               medians={phase: statistics.median(each[1:] or each)
                        for phase, each in timers.each.items()},
               step_starts=timers.starts["train_step"])
    out["check"], b2 = check_vs_one_partition(
        ranks, g, args, fanouts, metrics["cache_pct"], metrics["capacities"],
        device)
    out["exchange"] = exchange_times(b2, args.num_hidden, g.feature_dim,
                                     ranks.grouped, device)
    if args.model_name == "gat":
        out["shuffle_ops"] = gat_shuffle_times(
            b2, args, g.num_classes,
            memory_rate(torch.cuda.get_device_name(device)),
            ranks.backend, device)
    if spec.get("kernel_cases"):
        # Both entries at the first local partition's COO layer 0.
        lyr = b2.layers[0].partition(0)
        frame = SplitFeatureCache(
            CachePlan(g, g.partition_map, ranks.num_partitions,
                      metrics["cache_pct"],
                      refresh_cap=metrics["capacities"]["frame_caps"][0]),
            device=device, partitions=(ranks.lo, ranks.lo + 1)).frames[0]
        rate = memory_rate(torch.cuda.get_device_name(device))
        out["kernel_cases"] = kernel_cases(
            f"{spec['label']} layer 0, partition {ranks.lo}", frame,
            lyr.edge_src, lyr.edge_dst, lyr.dst_cap, rate)
        # The dense kernels at its layers 1-2.
        out["dense_cases"] = split_dense_cases(
            f"{spec['label']}, partition {ranks.lo},",
            [layer.partition(0) for layer in b2.layers], frame,
            args.num_hidden, rate, device)
    return out


def split_rank(rank, world, store, spec, out_dir):
    """One process of a P > 1 phase with several processes, as the CLI's
    launcher runs it: joins the process group holding ``spec["local"]``
    partitions, runs ``split_process`` and writes what it measured to
    ``out_dir/rank{r}.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranks = dist.init_distributed(store, world, rank, cpu=False,
                                  local=spec["local"])
    try:
        out = split_process(ranks, spec)
    finally:
        dist.close(ranks)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_ranks(label, num_procs, local, name, root, flags, shuffles_per_step,
              kernel=False):
    """Run a P > 1 phase as ``num_procs`` processes of ``local`` partitions
    each: in this process when there is one (no process group), else
    spawned. Holds what they report: equal global loss and accuracy,
    ``shuffles_per_step`` (forward, backward) exchanges a step per
    partition, the collectives the processes issued (none in one
    process), and each process's P vs P = 1 errors."""
    spec = dict(name=name, root=root, flags=flags, local=local, label=label,
                kernel_cases=kernel)
    P = num_procs * local
    if num_procs == 1:
        results = [json.loads(json.dumps(split_process(
            dist.single_process(P, torch.device("cuda", 0)), spec)))]
    else:
        with tempfile.TemporaryDirectory(prefix="occ_smoke_ranks_") as out:
            dist.spawn(split_rank, num_procs, spec, out,
                       timeout=RANK_TIMEOUT_S)
            results = []
            for r in range(num_procs):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    results.append(json.load(f))
    backends = {res["metrics"]["backend"] for res in results}
    shared = "nccl" not in backends and num_procs > 1
    print(f"{label}: {P} partitions, {num_procs} process(es) of {local}, "
          f"partition mode {flags[flags.index('--partition-mode') + 1]} "
          f"(edge cut {results[0]['edge_cut']:.4f}), backend "
          f"{', '.join(backends)}, {torch.cuda.device_count()} card(s)"
          + (" (the processes share cuda:0; wall times are no scaling "
             "numbers)" if shared else ""))
    fwd, bwd = shuffles_per_step
    for res in results:
        m, sh = res["metrics"], res["shuffles"]
        steps = m["steps"]
        who = f"  rank {res['rank']} [{res['local'][0]}, {res['local'][1]})"
        print(f"{who}: {steps} steps, global loss {m['loss']:.6f}, acc "
              f"{m['acc']:.6f}, cache {m['cache_pct']:.4f}, innermost "
              f"{m['innermost']}, replans {m['replans']}, tail writes "
              f"{m['tail_batches']}, {launch_text(res['launches'])}, peak "
              f"device memory {res['peak_gib']:.3f} GiB")
        print(f"{who}: exchanges per partition forward {sh['forward']} "
              f"({sh['forward'] / max(steps, 1):g} a step), backward "
              f"{sh['backward']} ({sh['backward'] / max(steps, 1):g} a "
              f"step), bytes sent per partition {sh['bytes_sent']} "
              f"({sh['bytes_sent'] / max(steps, 1):.0f} a step), "
              f"collectives issued {res['collectives']}, shuffle_caps "
              f"{m['capacities']['shuffle_caps']}")
        phases = m["phases"]
        print(f"{who}: C++ service per batch: cxx_sample "
              f"{1e3 * phases.get('cxx_sample', float('nan')):.2f} ms, "
              f"cxx_slice {1e3 * phases.get('cxx_slice', float('nan')):.2f}"
              f" ms")
        for line in res["phase_lines"]:
            print(f"{who}: {line}")
        if steps == 0 or not (np.isfinite(m["loss"])
                              and np.isfinite(m["acc"])):
            raise AssertionError(f"{label}: no steps or non-finite loss: {m}")
        if (sh["forward"], sh["backward"]) != (fwd * steps, bwd * steps):
            raise AssertionError(f"{label}: rank {res['rank']} ran {sh} "
                                 f"exchanges in {steps} steps; expected "
                                 f"{fwd} forward and {bwd} backward a step")
        issued = (fwd + bwd) * steps if num_procs > 1 else 0
        if res["collectives"] < issued or (num_procs == 1
                                           and res["collectives"]):
            raise AssertionError(f"{label}: rank {res['rank']} issued "
                                 f"{res['collectives']} collectives in "
                                 f"{steps} steps over {num_procs} "
                                 f"process(es)")
        c = res["check"]
        print(f"{who}: P = {P} vs P = 1, one raw sample ({c['targets']} "
              f"owned targets of {c['count']}): logits "
              f"{c['logits_err']:.3g}, loss {c['loss_err']:.3g}, gradients "
              f"{c['grad_err']:.3g} of each tensor's scale (limit "
              f"{LOGITS_TOL})")
        if not (c["all_finite"] and max(c["logits_err"], c["loss_err"],
                                        c["grad_err"]) <= LOGITS_TOL):
            raise AssertionError(f"{label}: P = {P} differs from P = 1 on "
                                 f"rank {res['rank']}: {c}")
        for e in res["exchange"]:
            print(f"{who}: exchange (shuffle_merge fwd) layer {e['layer']} "
                  f"(P={e['P']}, L={e['L']}, S={e['S']}, D={e['D']}, "
                  f"H={e['H']}): {e['ms']:.4f} ms a call ({e['clock']})")
        for op, ms, bound, by in res.get("shuffle_ops", []):
            print(f"{who}: op {op}: ms={ms:.4f} (host clock) "
                  f"bound_ms={bound:.4f} ({by})")
    agreed = {(res["metrics"]["loss"], res["metrics"]["acc"],
               res["metrics"]["steps"]) for res in results}
    if len(agreed) != 1:
        raise AssertionError(f"{label}: the processes report different "
                             f"global metrics: {agreed}")
    return results


def launcher_processes(P: int) -> int:
    """The processes the CLI's one-host launcher starts for P partitions
    on this machine's cards."""
    return dist.placement(P, cpu=False, cpu_devices=8)[1]


def expect_local_launches(label, results, per_partition_step):
    """Each process launched every kernel ``per_partition_step`` (entry
    -> count) times per local partition a step; returns the launches over
    every process."""
    launches = Counter()
    for res in results:
        m = res["metrics"]
        local = res["local"][1] - res["local"][0]
        expect_launches(f"{label}: rank {res['rank']}", res["launches"],
                        scaled(per_partition_step, local * m["steps"]),
                        f"{m['steps']} steps of {local} partitions")
        launches += Counter(res["launches"])
    return launches


def rank_phases(phase, root: str, P: int = 2):
    """Split P, split P-B and split GAT P-B: split A's and split B's flags
    (the latter with SAGE and with GAT) at ``P`` partitions, on the graphs
    saved under ``root``, placed as the CLI's launcher places them (one
    process holding both on one card). Split B's two run 3 steps. Returns
    the kernels' launches by entry over the three, rank 0's GAT shuffle
    times and the P-B run's results."""
    def parts(mode):
        return ["--partitions", str(P), "--partition-mode", mode]

    W = launcher_processes(P)
    label = f"split P{P}"
    with phase(label):
        flags = [f for f in SPLIT_A_FLAGS if f not in (
            "--profile-dir", "chiprun_out/split_a_profile")]
        flags += parts(PRODUCTS_PARTITION_MODE)
        results = run_ranks(label, W, P // W, "products", root, flags,
                            shuffles_per_step=(2, 2))
        for res in results:
            m = res["metrics"]
            if not (m["cache_pct"] >= 1.0 and m["innermost"] == "device"):
                raise AssertionError(f"{label} must run with a replicated "
                                     f"cache and device innermost")
        launches = expect_local_launches(label, results, SPLIT_A_STEP)
    # The cache refreshes per partition when 0.25 < 1/P.
    refreshing = 0.25 < 1.0 / P
    out = {}
    # Layer 0 is COO through the kernel (one launch a partition a step) in
    # both: SAGE through the fused gather, GAT through the messages'
    # entry; SAGE's layers 1-2 through the dense kernels. SAGE shuffles
    # layer 0 forward only (the frame takes no gradient); GAT runs the
    # reverse shuffle and the merge on all 3 layers both ways (its layer-0
    # er, s and v depend on W).
    for name, extra, shuffles, per_step in (
            (f"{label}-B", [], (3, 2), SPLIT_B_STEP),
            (f"split GAT P{P}-B", GAT_FLAGS, (6, 6), GAT_B_STEP)):
        with phase(name):
            results = run_ranks(
                name, W, P // W, "split_b", root,
                SPLIT_B_FLAGS + SHORT + extra + parts(SPLIT_B_PARTITION_MODE),
                shuffles_per_step=shuffles)
        launches += expect_local_launches(name, results, per_step)
        for res in results:
            m = res["metrics"]
            if m["tail_batches"] != (m["steps"] if refreshing else 0):
                raise AssertionError(f"{name}: rank {res['rank']}: "
                                     f"{m['tail_batches']} tail writes for "
                                     f"{m['steps']} steps")
        out[name] = results
    return launches, out[f"split GAT P{P}-B"][0]["shuffle_ops"], \
        out[f"{label}-B"]


def run_gloo_p2b(root: str, one_process):
    """Split P2-B as two ``--distributed`` processes of one partition each
    on one card (gloo, through the host), 3 steps: its global loss within
    1e-5 of scale of the one-process run's and its accuracy equal; the
    two exchanges' times a call side by side."""
    label = "split P2-B gloo"
    flags = (SPLIT_B_FLAGS + SHORT + ["--partitions", "2", "--partition-mode",
                                      SPLIT_B_PARTITION_MODE])
    results = run_ranks(label, 2, 1, "split_b", root, flags,
                        shuffles_per_step=(3, 2))
    mine, ref = results[0]["metrics"], one_process[0]["metrics"]
    scale = max(1.0, abs(ref["loss"]))
    err = abs(mine["loss"] - ref["loss"])
    print(f"  {label} vs one process: global loss {mine['loss']:.8f} vs "
          f"{ref['loss']:.8f} (err {err:.3g}, limit {1e-5 * scale:.3g}), "
          f"acc {mine['acc']:.6f} vs {ref['acc']:.6f}; train_step median "
          f"{results[0]['medians']['train_step']:.2f} ms vs "
          f"{one_process[0]['medians']['train_step']:.2f} ms")
    for e2, e1 in zip(results[0]["exchange"], one_process[0]["exchange"]):
        print(f"  exchange layer {e2['layer']}: two processes over gloo "
              f"{e2['ms']:.4f} ms ({e2['clock']}), one process "
              f"{e1['ms']:.4f} ms ({e1['clock']})")
    if not (err <= 1e-5 * scale and mine["acc"] == ref["acc"]
            and mine["steps"] == ref["steps"]):
        raise AssertionError(f"{label}: differs from the one-process run: "
                             f"{mine} vs {ref}")
    return expect_local_launches(label, results, SPLIT_B_STEP)


def run_local_p4(root: str, infer_flags, rate):
    """Split P4-B local (8 steps, one profiled, a checkpoint saved), split
    GAT P4-B local (3 steps) and infer P4 local of that checkpoint: one
    process holding 4 partitions on cuda:0, as the launcher places
    ``--partitions 4`` on one card. Returns the launches, the kernel
    cases at P4-B's layer 0 and the P4-B results."""
    P = 4
    if launcher_processes(P) != 1:
        print(f"split P{P}-B local: the launcher places {P} partitions on "
              f"{launcher_processes(P)} cards here; run in one process all "
              f"the same")
    ck_dir = os.path.join(root, "split_p4b_checkpoint")
    parts = ["--partitions", str(P), "--partition-mode",
             SPLIT_B_PARTITION_MODE]
    label = f"split P{P}-B local"
    results = run_ranks(label, 1, P, "split_b", root,
                        SPLIT_B_FLAGS + parts + [
                            "--save-dir", ck_dir, "--profile-dir",
                            "chiprun_out/split_p4b_profile"],
                        shuffles_per_step=(3, 2), kernel=True)
    res = results[0]
    m = res["metrics"]
    launches = expect_local_launches(label, results, SPLIT_B_STEP)
    starts = res["step_starts"]
    walls = [1e3 * (b - a) for a, b in zip(starts, starts[1:])][1:]
    print(f"  {label}: step wall median {statistics.median(walls):.2f} ms, "
          f"train_step median {res['medians']['train_step']:.2f} ms, peak "
          f"device memory {res['peak_gib']:.3f} GiB, exchange at layer 0 "
          f"{res['exchange'][0]['ms']:.4f} ms a call (CUDA events)")
    print_profile(m["profile"])
    label = f"split GAT P{P}-B local"
    results_gat = run_ranks(label, 1, P, "split_b", root,
                            SPLIT_B_FLAGS + SHORT + GAT_FLAGS + parts,
                            shuffles_per_step=(6, 6))
    launches += expect_local_launches(label, results_gat, GAT_B_STEP)
    # Infer P4 local against infer P1 of the same checkpoint.
    ck = os.path.join(ck_dir, "split_epoch.npz")
    g = load_graph(root, "split_b")
    preds = {}
    for p in (1, P):
        out = os.path.join(root, f"preds_p4b_{p}.npy")
        args = graph_args(SPLIT_B_NODES, infer_flags + [
            "--resume", ck, "--output", out, "--partitions", str(p),
            "--partition-mode", "round_robin"])
        timers = StepTimers()
        start_count(torch.device("cuda", 0))
        metrics = run_infer(args, g, [int(f) for f in args.fan_out.split(",")],
                            timers, torch.device("cuda", 0))
        got = read_launches()
        batches = -(-int(g.test_mask.sum()) // args.batch_size)
        expect_launches(f"infer P{p} local", got,
                        scaled(INFER_BATCH, p * batches),
                        f"{batches} batches of {p} partitions")
        if p == P:
            launches += got
        preds[p] = (metrics, np.load(out))
        print(f"infer P{p} local (split P4-B's checkpoint): count "
              f"{metrics['count']}, acc {metrics['acc']:.6f}, backend "
              f"{metrics['backend']}, {launch_text(got)}")
    (m1, p1), (m4, p4) = preds[1], preds[P]
    predicted = p1 >= 0
    same = float((p4[predicted] == p1[predicted]).mean())
    print(f"  infer P{P} local: predictions equal to P = 1's on {same:.6f} "
          f"of the nodes (limit {PRED_AGREEMENT})")
    if m4["count"] != m1["count"] or not ((p4 >= 0) == predicted).all() \
            or not same >= PRED_AGREEMENT:
        raise AssertionError(f"infer P{P} local differs from P = 1: "
                             f"{m4} vs {m1}, {same}")
    return launches, res["kernel_cases"], results


def run_entry(device) -> Counter:
    """``occ_gnn_tpu_torch.entry``: ``entry()``'s forward on the card
    (finite logits of the target frame's shape, one fused launch a
    layer) and ``dryrun_multichip(4)``, one process holding 4
    partitions: three finite losses, and the dense kernels of its two
    SAGE steps (every layer dense: once a layer a partition forward, once
    a layer past layer 0 backward; GAT's attention launches none)."""
    from occ_gnn_tpu_torch import entry as entry_mod

    start_count(device)
    fn, args = entry_mod.entry(device)
    logits = fn(*args)
    torch.cuda.synchronize(device)
    launches = read_launches()
    if not (torch.isfinite(logits).all() and logits.dim() == 2
            and logits.shape[1] == 16):
        raise AssertionError(f"entry(): bad logits {tuple(logits.shape)}")
    expect_launches("entry()", launches, {FUSED: 3}, "one forward")
    print(f"entry(): logits {tuple(logits.shape)}, {launch_text(launches)}")
    reset_launches()
    losses = entry_mod.dryrun_multichip(4, device)
    dry = read_launches()
    print(f"dryrun_multichip(4): losses {losses}, {launch_text(dry)}")
    if len(losses) != 3 or not np.isfinite(losses).all():
        raise AssertionError(f"dryrun_multichip(4): losses {losses}")
    layers = len(entry_mod.DRYRUN_FANOUTS)
    expect_launches("dryrun_multichip(4)", dry,
                    scaled({DENSE_FWD: layers, DENSE_BWD: layers - 1}, 2 * 4),
                    "two SAGE steps of 4 partitions")
    return launches + dry


def run_nccl_ranks(root: str, num_procs: int):
    """Split B at ``2 * num_procs`` partitions as ``num_procs`` processes
    of 2 over NCCL (one card each), held against P = 1. Stops when the
    machine has fewer cards."""
    cards = torch.cuda.device_count()
    if cards < num_procs:
        raise SystemExit(f"--ranks {num_procs} needs {num_procs} cards; "
                         f"this machine has {cards}")
    P = 2 * num_procs
    label = f"split P{P}-B NCCL"
    results = run_ranks(label, num_procs, 2, "split_b", root,
                        SPLIT_B_FLAGS + SHORT + [
                            "--partitions", str(P), "--partition-mode",
                            SPLIT_B_PARTITION_MODE],
                        shuffles_per_step=(3, 2))
    return expect_local_launches(label, results, SPLIT_B_STEP)


def check_dense_run(label, metrics, launches, per_step):
    """Split A and split GAT A: replicated cache, device innermost, the C++
    sampler, and dense layers only: the launches ``per_step`` (entry ->
    count) a step, no segment-sum launch (SAGE: SPLIT_A_STEP; GAT, whose
    dense layers run its attention: none)."""
    if not (metrics["cache_pct"] >= 1.0 and metrics["innermost"] == "device"
            and metrics["sampler"] == "native"):
        raise AssertionError(f"{label} must run with a replicated cache, "
                             f"device innermost and the native sampler")
    steps = metrics["steps"]
    expect_launches(label, launches, scaled(per_step, steps),
                    f"{steps} steps of dense layers only")


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
        edges = torch.arange(blk.edge_cap, dtype=torch.int32, device=device)
        cases.append(kernel_cases(f"single GAT layer {i}", msgs, edges,
                                  blk.edge_dst, blk.dst_cap, rate,
                                  entries=(MSGS,), msgs=msgs)[MSGS])
    return cases


def run_single(kind, args, g, device) -> int:
    """Drive ``train_single`` with the launch counts set to 0 just before;
    checks the launches a step of the entry the model calls. Returns the
    launches by entry."""
    fanouts = [int(f) for f in args.fan_out.split(",")]
    timers = StepTimers()
    start_count(device)
    metrics = train_single(args, g, fanouts, timers, device)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = metrics["steps"]
    print(f"single {kind}: {steps} steps, loss {metrics['loss']:.4f}, acc "
          f"{metrics['acc']:.4f}, {launch_text(launches)}, "
          f"peak device memory {peak_gib:.3f} GiB")
    print_phases(timers, steps, once=("capacity_plan",))
    if steps == 0:
        raise AssertionError(f"single {kind}: no steps")
    expect_launches(f"single {kind}", launches,
                    {SINGLE_ENTRY[kind]: SINGLE_LAUNCHES[kind] * steps},
                    f"{steps} steps")
    if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["acc"])):
        raise AssertionError(f"single {kind}: non-finite loss: {metrics}")
    return launches


def start_count(device) -> None:
    """Empty the allocator, reset the peak and set the launch counts to 0,
    just before a main-path run."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()


def run_pa_cache(args, g, first_ids, single_caps, rate, device):
    """``--mode pa-cache`` through ``train_single``. Before the run, a
    cache of the same share assembles the frame of ``first_ids`` (the
    single path's first batch: the same seeds, flags and capacities),
    which must equal ``gather_features`` of those ids bit for bit, and
    the assembly is timed at its shapes. During the run the ids of every
    frame are recorded on the host, as ``stage`` reads them; afterwards
    the first must be ``first_ids``, the hit rate must equal a recount of
    every recorded id against the cached node set, and the fused entry
    must have launched 3 times a step. Returns the launches by entry and
    the assembly's op row (device ms beside its byte bound)."""
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
    launches = read_launches()
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
          f"{launch_text(launches)}, peak device memory "
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
    if steps == 0:
        raise AssertionError("pa-cache: no steps")
    expect_launches("pa-cache", launches,
                    {FUSED: SINGLE_LAUNCHES["sage"] * steps}, f"{steps} steps")
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
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = metrics["steps"]
    fused = 1e3 * metrics["phases"]["fused_step"]
    print(f"quiver: {steps} steps, loss {metrics['loss']:.4f}, acc "
          f"{metrics['acc']:.4f}, {launch_text(launches)}, "
          f"peak device memory {peak_gib:.3f} GiB; fused_step {fused:.2f} "
          f"ms for the epoch, {fused / max(steps, 1):.2f} ms a step (the "
          f"first step's warm-up included)")
    if steps == 0 or any(launches.values()) or not np.isfinite(
            metrics["loss"]):
        raise AssertionError(f"quiver: {launches} launches in {steps} "
                             f"steps, metrics {metrics}")
    return dict(metrics=metrics, peak_gib=peak_gib)


def ddp_grad_check(ranks, g, args, fanouts, device):
    """One DDP step's gradient (lr 0) on the first batch of this process's
    shards ``[lo, hi)`` of P, at the capacities ``train_ddp`` measured (so
    the kernel runs at the run's shapes), all-reduced over the processes
    when there are several, held in one process (rank 0) against the
    gradient of the global mean loss over the same P batches:

    * ``ddp``: the step's against the model's own forward (the kernel) of
      each batch summed here, what the step's sum over the local shards
      and the collective add;
    * ``plain``: the kernel forward's against ``plain_forward``'s (the
      plain segment-sum) with the kernel forward's ReLU masks, what the
      kernel adds.

    The masks are shared because a ReLU's gradient jumps at 0: the two
    forwards sum in other orders, so a pre-activation within rounding of
    0 can take either sign, and the gradient of the layer below then
    moves by that unit's whole term, far above rounding. ``own masks`` is
    ``plain_forward`` with its own ReLU, beside the number of
    pre-activations whose sign differs; it must pass the limit when none
    does. Each error is relative to each tensor's max |.|. Returns the
    readings on rank 0 (None on the others) and prints them."""
    P = ranks.num_partitions
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
    refs = {key: copy.deepcopy(model) for key in ("ddp", "plain", "own")}
    mine = [shard_batch(q) for q in range(ranks.lo, ranks.hi)]
    make_dp_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                       ranks)([b for b, _ in mine], [x for _, x in mine])
    if ranks.rank != 0:
        return None
    batches = mine + [shard_batch(q) for q in range(ranks.hi, P)]
    count = sum(int((b.labels >= 0).sum()) for b, _ in batches)
    flips = 0
    for batch, x0 in batches:
        kernel_pre, own_pre = kernel_preactivations(model, batch, x0), []
        masks = [a > 0 for a in kernel_pre]
        for key, m in refs.items():
            if key == "ddp":
                logits = m(batch, x0)
            else:
                logits = plain_forward(m, batch, x0, masks=(
                    masks if key == "plain" else None), pre=(
                    own_pre if key == "own" else None))
            valid = batch.labels >= 0
            logp = torch.log_softmax(logits, dim=-1)[valid]
            (-logp.gather(-1, batch.labels[valid, None].long()).sum()
             / count).backward()
        flips += sum(int(((a > 0) != (b > 0)).sum())
                     for a, b in zip(kernel_pre, own_pre))

    def rel(a, b):
        return (a.grad - b.grad).abs().max().item() / b.grad.abs().max().item()

    kernel = dict(refs["ddp"].named_parameters())
    errs = {"ddp": 0.0, "plain": 0.0, "own masks": 0.0}
    for name, a in model.named_parameters():
        k = kernel[name]
        row = {"ddp": rel(a, k),
               "plain": rel(k, dict(refs["plain"].named_parameters())[name]),
               "own masks": rel(k, dict(refs["own"].named_parameters())[name])}
        errs = {key: max(errs[key], v) for key, v in row.items()}
        print(f"  ddp P{P} gradient {name}: the step's vs one forward a "
              f"shard {row['ddp']:.3g}, kernel vs plain {row['plain']:.3g} "
              f"(own masks {row['own masks']:.3g}) of scale "
              f"{k.grad.abs().max().item():.3g}", flush=True)
    errs["flips"] = flips
    return errs


def baseline_process(ranks, spec):
    """What one process of a ddp, quiver or infer phase measures, with the
    placement ``ranks`` (shards ``[lo, hi)`` of P): loads the saved graph
    and drives the mode's entry point with the counts set to 0 just before
    and read just after; ddp then runs ``ddp_grad_check`` when
    ``spec["grad_check"]``. Returns what it measured (JSON-ready) and the
    final weights of the model the entry point built."""
    device = ranks.device
    args = build_argparser().parse_args(
        ["--graph", spec["name"], "--data-root", spec["root"]]
        + spec["flags"])
    fanouts = [int(f) for f in args.fan_out.split(",")]
    g = load_graph(spec["root"], spec["name"])
    run = {"ddp": train_ddp, "quiver": train_quiver,
           "infer": run_infer}[args.mode]
    built = []

    def capture(*a, **kw):
        built.append(get_model(*a, **kw))
        return built[-1]

    timers = StepTimers()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    with patched(models_pkg, "get_model", capture):
        metrics = run(args, g, fanouts, timers, device,
                      ranks=ranks if ranks.grouped else None)
    out = dict(rank=ranks.rank, local=[ranks.lo, ranks.hi], metrics=metrics,
               launches=dict(read_launches()),
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               phase_lines=phase_lines(timers, metrics.get("steps", 0),
                                       once=("fused_step", "infer_step")),
               medians={phase: statistics.median(each[1:] or each)
                        for phase, each in timers.each.items()},
               step_starts=timers.starts["train_step"])
    if args.mode == "ddp" and spec.get("grad_check"):
        out["grad_err"] = ddp_grad_check(ranks, g, args, fanouts, device)
    weights = ({n: p.detach().cpu().numpy()
                for n, p in built[-1].named_parameters()}
               if built else {})
    return out, weights


def baseline_rank(rank, world, store, spec, out_dir):
    """One process of a ddp, quiver or infer phase with several processes,
    as the CLI's launcher runs it: joins the process group holding
    ``spec["local"]`` shards, runs ``baseline_process`` and writes what it
    measured to ``out_dir/rank{r}.json`` and its weights beside it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranks = dist.init_distributed(store, world, rank, cpu=False,
                                  local=spec["local"])
    try:
        out, weights = baseline_process(ranks, spec)
    finally:
        dist.close(ranks)
    np.savez(os.path.join(out_dir, f"weights{rank}.npz"), **weights)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_baselines(label, num_procs, local, name, root, flags,
                  grad_check=False):
    """Run a ddp, quiver or infer phase as ``num_procs`` processes of
    ``local`` shards each: in this process when there is one (no process
    group), else spawned. Holds what they report: equal global metrics,
    and for ddp and quiver equal final weights, in every process; no
    collective in a run of one process. Returns each process's results,
    its weights under ``"weights"``."""
    spec = dict(name=name, root=root, flags=flags, local=local,
                grad_check=grad_check)
    P = num_procs * local
    if num_procs == 1:
        out, weights = baseline_process(
            dist.single_process(P, torch.device("cuda", 0)), spec)
        results = [dict(json.loads(json.dumps(out)), weights=weights)]
    else:
        with tempfile.TemporaryDirectory(prefix="occ_smoke_ranks_") as tmp:
            dist.spawn(baseline_rank, num_procs, spec, tmp,
                       timeout=RANK_TIMEOUT_S)
            results = []
            for r in range(num_procs):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    res = json.load(f)
                with np.load(os.path.join(tmp, f"weights{r}.npz")) as w:
                    res["weights"] = dict(w)
                results.append(res)
    backends = {res["metrics"].get("backend", "none") for res in results}
    shared = "nccl" not in backends and num_procs > 1
    print(f"{label}: {P} shards, {num_procs} process(es) of {local}, "
          f"backend {', '.join(backends)}, {torch.cuda.device_count()} "
          f"card(s)" + (" (the processes share cuda:0; wall times are no "
                        "scaling numbers)" if shared else ""))
    keys = ("loss", "acc", "steps", "weights_crc32", "count", "collectives")
    for res in results:
        m = res["metrics"]
        who = f"  rank {res['rank']} [{res['local'][0]}, {res['local'][1]})"
        print(f"{who}: " + ", ".join(f"{k} {m[k]}" for k in keys if k in m)
              + f", {launch_text(res['launches'])}, peak device memory "
              f"{res['peak_gib']:.3f} GiB")
        for line in res["phase_lines"]:
            print(f"{who}: {line}")
        if not np.isfinite(m.get("loss", 0.0)):
            raise AssertionError(f"{label}: non-finite loss: {m}")
        if num_procs == 1 and (m.get("collectives", 0)
                               or torch.distributed.is_initialized()):
            raise AssertionError(f"{label}: one process made a process "
                                 f"group or issued {m['collectives']} "
                                 f"collectives")
    agreed = {tuple(res["metrics"].get(k) for k in keys[:5])
              for res in results}
    if len(agreed) != 1:
        raise AssertionError(f"{label}: the processes report different "
                             f"global metrics or weights: {agreed}")
    return results


def expect_shard_launches(label, results):
    """ddp: the fused entry 3 times a step a local shard (one a layer);
    quiver: no launch. Returns the launches over every process."""
    launches = Counter()
    for res in results:
        m = res["metrics"]
        steps, local = m["steps"], res["local"][1] - res["local"][0]
        if steps == 0:
            raise AssertionError(f"{label}: rank {res['rank']}: no steps")
        if m["mode"] == "ddp":
            expect_launches(f"{label}: rank {res['rank']}", res["launches"],
                            {FUSED: SINGLE_LAUNCHES["sage"] * local * steps},
                            f"{steps} steps of {local} shards")
        elif any(res["launches"].values()):
            raise AssertionError(f"{label}: the quiver path launched the "
                                 f"kernel: {res['launches']}")
        launches += Counter(res["launches"])
    return launches


def check_grad_err(label, results):
    """``ddp_grad_check``'s readings (rank 0's) within ``LOGITS_TOL``."""
    err = results[0]["grad_err"]
    print(f"  one step's gradient, one process summing the shard batches: "
          f"the step's vs the kernel forward's {err['ddp']:.3g}, kernel vs "
          f"plain forward at the kernel's ReLU masks {err['plain']:.3g} of "
          f"each tensor's scale (limit {LOGITS_TOL}); the plain forward's "
          f"own masks {err['own masks']:.3g}, {err['flips']} "
          f"pre-activations of another sign")
    if not (err["ddp"] <= LOGITS_TOL and err["plain"] <= LOGITS_TOL and (
            err["flips"] or err["own masks"] <= LOGITS_TOL)):
        raise AssertionError(f"{label}: the step's gradient differs from "
                             f"the one-process sum: {err}")


def step_readings(res) -> str:
    """A process's step readings: ddp's median ``train_step`` and step wall
    (launch to launch, steps 2 on), quiver's ``fused_step`` a step; the
    peak device memory."""
    m = res["metrics"]
    if m["mode"] == "quiver":
        text = (f"fused_step {1e3 * m['phases']['fused_step'] / m['steps']:.2f}"
                f" ms a step (warm-up in)")
    else:
        starts = res["step_starts"]
        walls = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
        text = (f"train_step {res['medians']['train_step']:.2f} ms, step wall "
                f"{statistics.median(walls[1:] or walls):.2f} ms")
    return f"{text}, peak {res['peak_gib']:.3f} GiB"


def compare_baselines(label, got, ref):
    """``got`` (several processes) against ``ref`` (one process of every
    shard), the same flags: the global loss within 1e-5 of scale, the
    accuracy and the steps equal, the final weights within 1e-4 of each
    tensor's scale; the step readings side by side."""
    mine, want = got[0]["metrics"], ref[0]["metrics"]
    scale = max(1.0, abs(want["loss"]))
    err = abs(mine["loss"] - want["loss"])
    w_err = max(np.abs(w - ref[0]["weights"][n]).max()
                / max(1.0, np.abs(ref[0]["weights"][n]).max())
                for n, w in got[0]["weights"].items())
    print(f"  {label} vs one process: global loss {mine['loss']:.8f} vs "
          f"{want['loss']:.8f} (err {err:.3g}, limit {1e-5 * scale:.3g}), "
          f"acc {mine['acc']:.6f} vs {want['acc']:.6f}, steps "
          f"{mine['steps']} vs {want['steps']}, weights {w_err:.3g} of "
          f"scale (limit 1e-4)")
    for res in got:
        print(f"  rank {res['rank']}: {step_readings(res)}")
    print(f"  one process: {step_readings(ref[0])}")
    if not (err <= 1e-5 * scale and mine["acc"] == want["acc"]
            and mine["steps"] == want["steps"] and w_err <= 1e-4):
        raise AssertionError(f"{label}: differs from the one-process run: "
                             f"{mine} vs {want}, weights {w_err:.3g}")


# ddp on the products graph, quiver on split B's, 3 steps each.
BASELINES = (("ddp", DDP_FLAGS, "products"), ("quiver", QUIVER_FLAGS,
                                              "split_b"))


def baseline_rank_phases(phase, root: str, num_ranks: int, infer_ref):
    """ddp P2 and quiver P2 (3 steps) in one process holding both shards,
    as the CLI's launcher places them on one card, each beside the same
    run as two processes of one shard (gloo, sharing the card); on a
    machine with several cards, ddp and quiver P(2N) as N = ``num_ranks``
    processes of 2 over NCCL against one process of 2N; infer at
    ``num_ranks`` processes. ``infer_ref`` is the P = 1 inference
    (metrics, predictions, flags). Returns the kernel's launches by entry
    over every main-path run."""
    launches = Counter()
    for mode, flags, graph in BASELINES:
        flags = flags + SHORT + ["--partitions", "2"]
        label = f"{mode} P2"
        with phase(label):
            one = run_baselines(label, 1, 2, graph, root, flags,
                                grad_check=mode == "ddp")
            launches += expect_shard_launches(label, one)
            if mode == "ddp":
                check_grad_err(label, one)
        label = f"{mode} P2 gloo"
        with phase(label):
            two = run_baselines(label, 2, 1, graph, root, flags)
            launches += expect_shard_launches(label, two)
            compare_baselines(label, two, one)
    if torch.cuda.device_count() > 1:
        launches += run_nccl_baselines(phase, root, num_ranks)
    else:
        print(f"ddp and quiver P{2 * num_ranks} NCCL: need {num_ranks} "
              f"cards, this machine has 1; not run")
    label = f"infer P{num_ranks}"
    ref_metrics, ref_preds, flags, batches = infer_ref
    out = os.path.join(root, f"preds_p{num_ranks}.npy")
    flags = flags + ["--partitions", str(num_ranks), "--partition-mode",
                     "round_robin", "--output", out]
    with phase(label):
        results = run_baselines(label, num_ranks, 1, "split_b", root, flags)
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
            expect_launches(f"{label}: rank {res['rank']}", res["launches"],
                            scaled(INFER_BATCH, batches),
                            f"{batches} batches")
            launches += Counter(res["launches"])
    return launches


def run_nccl_baselines(phase, root: str, num_procs: int) -> Counter:
    """ddp and quiver at ``2 * num_procs`` shards as ``num_procs`` processes
    of 2 over NCCL (one card each; ddp with the gradient check), held
    against one process of every shard. Stops when the machine has fewer
    cards."""
    cards = torch.cuda.device_count()
    if cards < num_procs:
        raise SystemExit(f"--ranks {num_procs} needs {num_procs} cards; "
                         f"this machine has {cards}")
    P = 2 * num_procs
    launches = Counter()
    for mode, flags, graph in BASELINES:
        flags = flags + SHORT + ["--partitions", str(P)]
        label = f"{mode} P{P} NCCL"
        with phase(label):
            one = run_baselines(f"{mode} P{P}", 1, P, graph, root, flags)
            launches += expect_shard_launches(label, one)
            got = run_baselines(label, num_procs, 2, graph, root, flags,
                                grad_check=mode == "ddp")
            launches += expect_shard_launches(label, got)
            if mode == "ddp":
                check_grad_err(label, got)
            compare_baselines(label, got, one)
    return launches


def check_infer_batch(g, args, rate, device):
    """The first test batch as ``--mode infer`` samples it at P = 1
    (worst-case capacities, no cache, the host gather) through the split
    forward with the checkpoint ``args.resume``, against ``plain_forward``
    of the same weights on ``raw_to_single_batch`` of the same raw sample;
    then both entries at that batch's layer-0 COO against their plain
    versions. Returns the kernel cases by entry."""
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
    return kernel_cases("infer layer 0", xs, lyr.edge_src, lyr.edge_dst,
                        lyr.dst_cap, rate)


def run_infer_one(g, ck_path, out_dir, rate, device):
    """``--mode infer`` of split B's checkpoint at P = 1 on its test
    nodes: ``check_infer_batch`` first, then the run with the counts set
    to 0 just before: one fused launch a batch (the COO layer 0). Returns
    (launches, kernel cases, (metrics, predictions, flags, batches))."""
    out = os.path.join(out_dir, "preds_p1.npy")
    flags = INFER_FLAGS + ["--resume", ck_path]
    args = graph_args(SPLIT_B_NODES, flags + ["--output", out])
    case = check_infer_batch(g, args, rate, device)
    timers = StepTimers()
    start_count(device)
    metrics = run_infer(args, g, [int(f) for f in args.fan_out.split(",")],
                        timers, device)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    batches = -(-int(g.test_mask.sum()) // args.batch_size)
    print(f"infer P1: count {metrics['count']}, acc {metrics['acc']:.6f}, "
          f"{batches} batches, {launch_text(launches)}, peak "
          f"device memory {peak_gib:.3f} GiB")
    print_phases(timers, batches, once=())
    expect_launches("infer P1", launches, scaled(INFER_BATCH, batches),
                    f"{batches} batches")
    if metrics["count"] != int(g.test_mask.sum()):
        raise AssertionError(f"infer P1: count {metrics['count']}")
    return launches, case, (metrics, np.load(out), flags, batches)


@contextmanager
def patched(obj, name: str, value):
    """``obj.name`` set to ``value`` inside the block, restored after."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextmanager
def lowering(**impls):
    """The lowerings of ``ops/config.py`` named by keyword (``dense_agg``,
    ``device_sample``, ``gat_attention``, ``gat_agg``, ``gat_remat``) set
    inside the block, and back to what they were after it."""
    old = {name: getattr(ops_config, f"{name}_impl")() for name in impls}
    for name, value in impls.items():
        getattr(ops_config, f"set_{name}_impl")(value)
    try:
        yield
    finally:
        for name, value in old.items():
            getattr(ops_config, f"set_{name}_impl")(value)


def short_run(flags: list[str]) -> list[str]:
    """A phase's flags for a 3-step run: no profile, 3 batches."""
    out = []
    for f in flags:
        if out and out[-1] == "--profile-dir":
            out.pop()
            continue
        out.append(f)
    return out + ["--limit-train", str(3 * 1024)]


def run_sample_lowerings(g, args_a, fanouts, rate, device):
    """Split A's layer 0 under each other ``OCC_DEVICE_SAMPLE`` lowering
    (``randint`` ran in split A): ``check_synthesized_layer`` holds it to
    the sampling contract, then the synthesis is timed at that batch's
    shapes beside the byte bound of split_op_times (``window`` reads K
    consecutive words of one row a dst in place of K scattered ones; its
    doubled CSR's bytes are printed). Returns the op rows."""
    rows = []
    plain_bytes = 4 * (g.indptr.shape[0] + g.indices.shape[0])
    for impl in ("bitsf32", "bitsf32_dk", "window"):
        with lowering(device_sample=impl):
            print(f"  OCC_DEVICE_SAMPLE={impl}:")
            batch, syn, csr = check_synthesized_layer(
                g, fanouts, args_a.batch_size, device)
            l0 = batch.layers[0].partition(0)
            D0, O0, K0 = l0.dst_global.shape[0], l0.out_cap, l0.fanout
            used0 = int((syn.nbr_idx[1:] != l0.src_cap - 1).sum())
            gen = torch.Generator(device).manual_seed(6)
            nbytes = 4 * (D0 + 2 * D0 + used0 + (K0 + 1) * D0) + 13 * O0
            ms = events_ms(lambda: synthesize_device_innermost(
                l0, csr[0], csr[1], gen))
            csr_bytes = csr[0].nbytes + csr[1].nbytes
            name = (f"synthesize_device_innermost {impl} (D={D0}, K={K0}, "
                    f"CSR {csr[1].csr_layout} {csr_bytes} B, plain "
                    f"{plain_bytes} B)")
            rows.append((name, ms, nbytes / rate * 1e3))
            print(f"  op {name}: ms={ms:.4f} bound_ms="
                  f"{nbytes / rate * 1e3:.4f} (bytes)")
            del batch, syn, csr
    return rows


def check_dense_tiled(syn, frames, rate):
    """``OCC_DENSE_AGG=tiled``: split A's layer-0 aggregation through it
    must equal the unrolled one bit for bit; its forward is timed beside
    the byte bound. Returns the op row."""
    nbr = syn.nbr_idx
    x = frames[0]
    K, D = nbr.shape
    unrolled = local_aggregate_dense(x, nbr)
    with lowering(dense_agg="tiled"):
        tiled = local_aggregate_dense(x, nbr)
        equal = bool(torch.equal(tiled, unrolled))
        print(f"  OCC_DENSE_AGG=tiled, layer 0 (K={K}, D={D}, tile "
              f"{DENSE_TILE}): bit-equal to unrolled: {equal}")
        if not equal:
            raise AssertionError("tiled dense aggregation differs from the "
                                 "unrolled one")
        H, xb = x.shape[1], x.element_size()
        rows = torch.unique(nbr).numel()
        nbytes = 4 * K * D + xb * rows * H + 4 * D * H
        ms = events_ms(lambda: local_aggregate_dense(x, nbr))
    name = f"local_aggregate_dense tiled fwd, layer 0 (K={K}, D={D}, H={H})"
    print(f"  op {name}: ms={ms:.4f} bound_ms="
          f"{nbytes / rate * 1e3:.4f} (bytes)")
    return name, ms, nbytes / rate * 1e3


def run_dense_tiled(g, fanouts, metrics_a, device):
    """3 steps of split A through ``train_split`` under
    ``OCC_DENSE_AGG=tiled``: the forward kernel once a dst tile of
    ``DENSE_TILE`` rows (once a layer of at most that many), the backward
    once a layer past layer 0. Returns the launches."""
    args_t = graph_args(g.num_nodes, short_run(SPLIT_A_FLAGS))
    with lowering(dense_agg="tiled"):
        metrics, launches = run_split("split A, OCC_DENSE_AGG=tiled",
                                      args_t, g, fanouts, device)
    tiles = [-(-d // DENSE_TILE)
             for d in metrics["capacities"]["dst_caps"]]
    print(f"  dst tiles a layer: {tiles} (dst_caps "
          f"{metrics['capacities']['dst_caps']})")
    check_dense_run("split A tiled", metrics, launches,
                    {DENSE_FWD: sum(tiles), DENSE_BWD: len(tiles) - 1})
    print(f"  train_step median {metrics['medians']['train_step']:.2f} ms, "
          f"peak {metrics['peak_gib']:.3f} GiB, against unrolled's "
          f"{metrics_a['medians']['train_step']:.2f} ms, "
          f"{metrics_a['peak_gib']:.3f} GiB (split A)")
    return launches


GAT_VARIANTS = (("online", dict(gat_attention="online")),
                ("tiled", dict(gat_attention="tiled")),
                ("fma", dict(gat_agg="fma")),
                ("remat dots", dict(gat_remat="dots")))


def gat_variant_grads(model, layers, frames, labels):
    """Logits and weight gradients of the masked CE on one batch."""
    model.zero_grad(set_to_none=True)
    logits = model.forward_local(layers, frames[0])
    valid = labels >= 0
    torch.nn.functional.cross_entropy(logits[valid],
                                      labels[valid].long()).backward()
    return logits.detach(), {n: p.grad.clone()
                             for n, p in model.named_parameters()
                             if p.grad is not None}


def check_gat_variants(g, args_ga, batch, syn, frames, rate, device):
    """Split GAT A's first batch under each lowering of GAT_VARIANTS: its
    logits and weight gradients against the batched form's (each error
    relative to the largest magnitude of the batched tensor, TF32 off),
    and its layers' attention forward and backward beside their byte
    bounds. Returns the op rows."""
    model = split_model(args_ga, g).to(device)
    layers = [syn] + [lyr.partition(0) for lyr in batch.layers[1:]]
    labels = batch.labels[0]
    ref_logits, ref_grads = gat_variant_grads(model, layers, frames, labels)

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

    rows = []
    for name, impls in GAT_VARIANTS:
        with lowering(**impls):
            logits, grads = gat_variant_grads(model, layers, frames, labels)
            scale = max(1.0, ref_logits.abs().max().item())
            lerr = (logits - ref_logits).abs().max().item() / scale
            gerr = max(rel(grads[n], ref_grads[n]) for n in ref_grads)
            print(f"  {name}: first batch vs batched: logits {lerr:.3g} "
                  f"of scale, gradients {gerr:.3g} (limit {LOGITS_TOL})")
            if not (grads.keys() == ref_grads.keys()
                    and torch.isfinite(logits).all()
                    and max(lerr, gerr) <= LOGITS_TOL):
                raise AssertionError(f"split GAT {name} differs from the "
                                     f"batched form")
            del logits, grads
            attend = ATTENTION[impls.get("gat_attention", "batched")]
            if impls.get("gat_remat") == "dots":
                attend = partial(checkpoint_dots, attend)
            rows += gat_op_times(batch, syn, frames, args_ga, g.num_classes,
                                 rate, device, attend=attend,
                                 label=f"GAT attention {name}",
                                 backward_once="gat_remat" in impls)
    return rows


def run_gat_variants(g, fanouts, metrics_ga, device):
    """3 steps of split GAT A through ``train_split`` under each lowering
    of GAT_VARIANTS, with ``train_step`` and the peak beside batched's.
    Returns the launches (none)."""
    args_s = graph_args(g.num_nodes, short_run(GAT_A_FLAGS))
    launches = Counter()
    for name, impls in GAT_VARIANTS:
        with lowering(**impls):
            metrics, n = run_split(f"split GAT A, {name}", args_s, g,
                                   fanouts, device)
        check_dense_run(f"split GAT A {name}", metrics, n, {})
        launches += n
        print(f"  {name}: train_step median "
              f"{metrics['medians']['train_step']:.2f} ms, peak "
              f"{metrics['peak_gib']:.3f} GiB; batched "
              f"{metrics_ga['medians']['train_step']:.2f} ms, "
              f"{metrics_ga['peak_gib']:.3f} GiB")
    return launches


def sym_coeff(blk):
    """GCN ``norm="sym"``'s edge weights, written plainly: 1 / sqrt(
    d_out(u) d_in(v)) with block-local degrees, 0 on padding edges."""
    ref = segment_sum_sorted_reference
    n, dst = blk.dst_cap, blk.edge_dst
    valid = (dst < n).float()[:, None]
    deg_in = ref(valid, dst, n)[:, 0]
    deg_out = ref(valid, blk.edge_src, blk.src_cap)[:, 0]
    return valid[:, 0] * torch.rsqrt(
        deg_out[blk.edge_src.long()].clamp(min=1.0)
        * deg_in[dst.clamp(max=n - 1).long()].clamp(min=1.0))


def plain_gcn_sym_forward(model, batch, x0):
    """GCN ``norm="sym"`` written with the plain segment-sum."""
    x = x0
    for i, blk in enumerate(batch.blocks):
        msgs = x[blk.edge_src.long()].float() * sym_coeff(blk)[:, None]
        p = model.layer_params(i)
        x = segment_sum_sorted_reference(msgs, blk.edge_dst,
                                         blk.dst_cap) @ p["w"] + p["b"]
        if i != len(batch.blocks) - 1:
            x = torch.relu(x)
    return x


def run_gcn_sym(g, rate, device):
    """Single GCN with ``norm="sym"`` on split B's graph. No flag selects
    it (as in JAX), so ``train_single`` runs it with the model factory
    bound to ``norm="sym"``. First, on the batch the run samples first,
    its logits through the kernel against ``plain_gcn_sym_forward`` and
    both entries at each layer's shape with its edge weights (the path
    calls the fused one); then 3 steps: 3 launches a step. Returns the
    launches and the kernel cases by entry."""
    args = graph_args(g.num_nodes, SINGLE_B_FLAGS + ["--model-name", "gcn"])
    fanouts = [int(f) for f in args.fan_out.split(",")]
    nodes = g.train_nodes()[: args.limit_train]
    caps = measure_capacities(g, nodes, fanouts, args.batch_size,
                              seed=args.seed + 99)
    batch = next(iter(NeighborSampler(g, nodes, fanouts, args.batch_size,
                                      capacities=caps, seed=args.seed,
                                      device=device)))
    x0 = gather_features(g.features, batch.input_nodes, device)
    model = GCNModel(g.feature_dim, args.num_hidden, g.num_classes,
                     len(fanouts), norm="sym",
                     generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device).eval()
    with torch.no_grad():
        logits = model(batch, x0)
        ref = plain_gcn_sym_forward(model, batch, x0)
    scale = max(1.0, ref.abs().max().item())
    err = (logits - ref).abs().max().item()
    print(f"  first batch: GCN sym logits vs the plain forward: "
          f"max_abs_err={err:.3g} at scale {scale:.3g} (limit "
          f"{LOGITS_TOL * scale:.3g})")
    if not (torch.isfinite(logits).all() and err <= LOGITS_TOL * scale):
        raise AssertionError("GCN sym logits differ from the plain forward")
    gen = torch.Generator(device).manual_seed(3)
    cases = []
    for i, blk in enumerate(batch.blocks):
        x = x0 if i == 0 else torch.randn(blk.src_cap, args.num_hidden,
                                          generator=gen, device=device)
        cases.append(kernel_cases(f"GCN sym layer {i}", x, blk.edge_src,
                                  blk.edge_dst, blk.dst_cap, rate,
                                  weight=sym_coeff(blk)))
    del batch, x0, logits, ref, model

    built, forwards = [], []

    def sym_model(name, *a, **kw):
        model = get_model(name, *a, norm="sym", **kw)
        built.append(model)
        model.register_forward_pre_hook(
            lambda m, _: forwards.append(m.norm))
        return model

    with patched(models_pkg, "get_model", sym_model):
        launches = run_single("gcn sym", args, g, device)
    steps = launches[FUSED] // SINGLE_LAUNCHES["gcn sym"]
    if not (len(built) == 1 and len(forwards) >= steps
            and set(forwards) == {"sym"}):
        raise AssertionError(f"single GCN sym: the run trained another "
                             f"model: {len(built)} built, forwards "
                             f"{forwards} for {steps} steps")
    return launches, cases


class UnpackedNativeSampler(NativeSplitSampler):
    """The C++ feed with one copy a field (``packed=False``). ``popped``
    counts the samples it takes off the service unpacked; taking one
    packed raises."""

    popped = 0

    def __init__(self, *args, **kw):
        super().__init__(*args, packed=False, **kw)

    def _pop_unpacked(self):
        UnpackedNativeSampler.popped += 1
        return super()._pop_unpacked()

    def _pop_packed(self):
        raise AssertionError("the unpacked feed took a packed sample")


def run_unpacked(g, metrics_b, device):
    """Split B's feed unpacked: its first batch against the packed feed's
    field by field (same seed, capacities and refreshing cache), then 3
    steps through ``train_split`` on it: one fused launch and one tail
    write a step. Returns the launches."""
    args = graph_args(g.num_nodes, short_run(SPLIT_B_FLAGS))
    fanouts = [int(f) for f in args.fan_out.split(",")]
    nodes, bs = g.train_nodes(), args.batch_size
    pmap = np.zeros(g.num_nodes, np.int32)
    caps = plan_split_capacities(bs, fanouts, g.num_nodes, 1)
    batches = []
    for cls in (NativeSplitSampler, UnpackedNativeSampler):
        cache = SplitFeatureCache(
            CachePlan(g, pmap, 1, 0.25, refresh_cap=caps["frame_caps"][0]),
            device=device)
        sampler = cls(g, nodes, pmap, 1, fanouts, bs, capacities=caps,
                      seed=0, cache=cache, device=device)
        batches.append(sampler.sample_batch(nodes[:bs]))
        sampler.close()
        del cache
    packed, unpacked = batches
    fields = 0
    for lp, lu in zip(packed.layers, unpacked.layers):
        for f in dataclasses.fields(lp):
            a, b = getattr(lp, f.name), getattr(lu, f.name)
            same = (torch.equal(a, b) and a.dtype == b.dtype
                    if isinstance(a, torch.Tensor) else a == b)
            fields += isinstance(a, torch.Tensor)
            if not same:
                raise AssertionError(f"unpacked feed: field {f.name} "
                                     f"differs from the packed feed's")
    for f in ("labels", "target_nodes"):
        if not torch.equal(getattr(packed, f), getattr(unpacked, f)):
            raise AssertionError(f"unpacked feed: {f} differs")
        fields += 1
    print(f"  first batch: {fields} fields equal to the packed feed's")
    del batches, packed, unpacked
    UnpackedNativeSampler.popped = 0
    with patched(native_mod, "NativeSplitSampler", UnpackedNativeSampler):
        metrics, launches = run_split("split B unpacked", args, g, fanouts,
                                      device)
    steps = metrics["steps"]
    expect_launches("split B unpacked", launches, scaled(SPLIT_B_STEP, steps),
                    f"{steps} steps")
    if metrics["tail_batches"] != steps:
        raise AssertionError(f"split B unpacked: {metrics['tail_batches']} "
                             f"tail writes for {steps} steps")
    if UnpackedNativeSampler.popped < steps:
        raise AssertionError(f"split B unpacked: the run took "
                             f"{UnpackedNativeSampler.popped} unpacked "
                             f"samples for {steps} steps")
    print(f"  sample median {metrics['medians']['sample']:.2f} ms unpacked "
          f"against packed {metrics_b['medians']['sample']:.2f} (split B)")
    return launches


def split_nccl_only(opts, phase) -> int:
    """``--split-nccl-only``: the split P(2N)-B NCCL phase alone (N =
    ``--ranks`` processes of 2 partitions, one card each), on split B's
    graph."""
    with tempfile.TemporaryDirectory(prefix="occ_smoke_graphs_") as root:
        with phase("graphs"):
            args = graph_args(SPLIT_B_NODES, SPLIT_B_FLAGS)
            save_graph(random_graph(SPLIT_B_NODES, AVG_DEGREE, FEATURE_DIM,
                                    num_classes=NUM_CLASSES, seed=args.seed),
                       root, "split_b")
        with phase(f"split P{2 * opts.ranks}-B NCCL"):
            launches = run_nccl_ranks(root, opts.ranks)
    print(f"split P{2 * opts.ranks}-B NCCL: every check passed, "
          f"{launch_text(launches)}")
    return 0


def baselines_only(opts, phase, rate, device) -> int:
    """``--baselines-only``: step 12 alone at ``--ranks``, with what it
    needs: the products graph for ddp, and split B's graph, its 8-step
    run's checkpoint and the P = 1 inference for quiver and infer."""
    with tempfile.TemporaryDirectory(prefix="occ_smoke_graphs_") as root:
        with phase("graphs"):
            args = graph_args(opts.num_nodes, TRAIN_FLAGS)
            save_graph(random_graph(opts.num_nodes, AVG_DEGREE, FEATURE_DIM,
                                    num_classes=NUM_CLASSES, seed=args.seed),
                       root, "products")
            ck_dir = os.path.join(root, "split_b_checkpoint")
            args_b = graph_args(SPLIT_B_NODES,
                                SPLIT_B_FLAGS + ["--save-dir", ck_dir])
            g_b = random_graph(SPLIT_B_NODES, AVG_DEGREE, FEATURE_DIM,
                               num_classes=NUM_CLASSES, seed=args_b.seed)
            save_graph(g_b, root, "split_b")
        with phase("split B"):
            run_split("split B", args_b, g_b,
                      [int(f) for f in args_b.fan_out.split(",")], device)
        with phase("infer P1"):
            _, _, infer_ref = run_infer_one(
                g_b, os.path.join(ck_dir, "split_epoch.npz"), root, rate,
                device)
        del g_b
        launches = baseline_rank_phases(phase, root, opts.ranks, infer_ref)
    print(f"baselines at P = {opts.ranks}: every check passed, "
          f"{launch_text(launches)}")
    return 0


def main(argv=None) -> int:
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("--num-nodes", type=int, default=PRODUCTS_NODES)
    cli.add_argument("--ranks", type=int, default=RANKS,
                     help="processes of infer's P phase and of the NCCL "
                          "phases (several cards)")
    cli.add_argument("--split-nccl-only", action="store_true",
                     help="run only the split phase of --ranks processes "
                          "of 2 partitions over NCCL; prints no result")
    cli.add_argument("--baselines-only", action="store_true",
                     help="run only the ddp, quiver and infer phases at "
                          "--ranks (and what they need); prints no result")
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
    if opts.split_nccl_only:
        return split_nccl_only(opts, phase)
    if opts.baselines_only:
        return baselines_only(opts, phase, rate, device)

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
            main_cases.append(kernel_cases(f"layer {i}", x, blk.edge_src,
                                           blk.edge_dst, blk.dst_cap, rate))
        backward_rows = [backward_case(f"layer {i}", blk, args.num_hidden,
                                       rate, gen)
                         for i, blk in enumerate(batch.blocks) if i > 0]
        ragged = [kernel_cases(rate=rate, **c) for c in ragged_cases(device)]

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
        # The dense kernels at every layer of that batch, and at layer 0
        # on the frame in bf16 (``--dtype bfloat16``).
        dense_a = split_dense_cases(
            "split A", [syn] + [lyr.partition(0) for lyr in batch.layers[1:]],
            cache.frames[0], args_a.num_hidden, rate, device)
        dense_a_bf16 = dense_cases(
            "split A layer 0, bf16 frame", cache.frames[0].to(torch.bfloat16),
            syn.nbr_idx, rate, torch.Generator(device).manual_seed(10),
            backward=False)[DENSE_FWD]
        del csr, cache
        metrics_a, launches_a = run_split("split A", args_a, g, fan_a, device)
        check_dense_run("split A", metrics_a, launches_a, SPLIT_A_STEP)
        print_profile(metrics_a["profile"])

    # 8a. Split A's lowerings: the other device samplers, then the tiled
    # dense aggregation (3 steps).
    with phase("split A lowerings"):
        sample_rows = run_sample_lowerings(g, args_a, fan_a, rate, device)
        frames = SplitFeatureCache(
            CachePlan(g, np.zeros(g.num_nodes, np.int32), 1, 1.0,
                      refresh_cap=8), device=device).frames
        tiled_row = check_dense_tiled(syn, frames, rate)
        del frames
        launches_dt = run_dense_tiled(g, fan_a, metrics_a, device)

    # 8b. Split GAT A: the same graph and flags with GAT (hidden 32, 4
    # heads): the batched attention on every layer.
    with phase("split GAT A"):
        args_ga = graph_args(opts.num_nodes, GAT_A_FLAGS)
        cache, _, _, _ = split_vs_single(g, args_ga, 1.0, device)
        gat_rows = gat_op_times(batch, syn, cache.frames, args_ga,
                                g.num_classes, rate, device)
        del cache
        metrics_ga, launches_ga = run_split("split GAT A", args_ga, g, fan_a,
                                            device)
        check_dense_run("split GAT A", metrics_ga, launches_ga, {})
        print_profile(metrics_ga["profile"])

    # 8c. Split GAT A's lowerings: online, tiled, fma and remat dots.
    with phase("split GAT A lowerings"):
        frames = SplitFeatureCache(
            CachePlan(g, np.zeros(g.num_nodes, np.int32), 1, 1.0,
                      refresh_cap=8), device=device).frames
        gat_variant_rows = check_gat_variants(g, args_ga, batch, syn, frames,
                                              rate, device)
        del batch, syn, frames
        launches_gv = run_gat_variants(g, fan_a, metrics_ga, device)
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
        frame = cache.frames[0]
        split_case = kernel_cases("split B layer 0", frame, lyr.edge_src,
                                  lyr.edge_dst, lyr.dst_cap, rate)
        split_bf16_case = kernel_cases(
            "split B layer 0, bf16 frame", frame.to(torch.bfloat16),
            lyr.edge_src, lyr.edge_dst, lyr.dst_cap, rate,
            entries=(FUSED,))[FUSED]
        # Split GAT's COO layer 0 sends one [p, p * feat] message a head:
        # 4 x (32 + 1) floats an edge, from a frame as tall as split B's.
        gat_split_case = kernel_cases(
            "split GAT B layer 0", torch.randn(
                frame.shape[0], 4 * 33, device=device), lyr.edge_src,
            lyr.edge_dst, lyr.dst_cap, rate)
        dense_b = split_dense_cases(
            "split B", [lyr.partition(0) for lyr in batch.layers], frame,
            args_b.num_hidden, rate, device)
        del cache, sampler, fwd, batch, lyr, frame
        metrics_b, launches_b = run_split("split B", args_b, g_b, fan_b,
                                          device)
        steps_b = metrics_b["steps"]
        expect_launches("split B", launches_b, scaled(SPLIT_B_STEP, steps_b),
                        f"{steps_b} steps")
        if metrics_b["tail_batches"] != steps_b:
            raise AssertionError(f"split B: {metrics_b['tail_batches']} tail "
                                 f"writes for {steps_b} steps")
    # 9a. Split B's feed unpacked (one copy a field), 3 steps.
    with phase("split B unpacked"):
        launches_u = run_unpacked(g_b, metrics_b, device)

    # 9b. Single GAT and single GCN on split B's graph, 3 steps each.
    with phase("single GAT and GCN"):
        args_sg = graph_args(SPLIT_B_NODES, SINGLE_B_FLAGS + GAT_FLAGS)
        gat_cases = single_gat_cases(g_b, args_sg, rate, device)
        launches_sgl = sum(
            (run_single(kind, graph_args(SPLIT_B_NODES,
                                         SINGLE_B_FLAGS + extra), g_b, device)
             for kind, extra in (("gat", GAT_FLAGS),
                                 ("gcn", ["--model-name", "gcn"]))),
            Counter())
    # 9b'. Single GCN with norm="sym": the kernel on the weighted messages.
    with phase("single GCN sym"):
        launches_sym, sym_cases = run_gcn_sym(g_b, rate, device)
    # 9c. Inference of split B's checkpoint at P = 1.
    with phase("infer P1"):
        launches_i1, infer_case, infer_ref = run_infer_one(
            g_b, os.path.join(ck_dir, "split_epoch.npz"), graphs.name, rate,
            device)
    with phase("save graphs"):
        save_graph(g_b, graphs.name, "split_b")
    del g_b

    # 10-11. Split P2, split P2-B and split GAT P2-B: split A and split B
    # (SAGE and GAT) at two partitions, one process holding both; then
    # split P2-B as two processes over gloo on one card.
    launches_pb, gat_shuffle_rows, p2b = rank_phases(phase, graphs.name)
    with phase("split P2-B gloo"):
        launches_gl = run_gloo_p2b(graphs.name, p2b)
    # 11a. Split P4-B, split GAT P4-B and infer P4 in one process.
    with phase("split P4-B local"):
        launches_p4, p4_cases, p4_results = run_local_p4(
            graphs.name, INFER_FLAGS, rate)
        dense_p4 = {int(i): c
                    for i, c in p4_results[0]["dense_cases"].items()}
    # 11b. The entry points: entry() and dryrun_multichip(4).
    with phase("entry"):
        launches_en = run_entry(device)
    # 11c. Split B at 2 * --ranks partitions over NCCL, on several cards.
    launches_nc = Counter()
    if torch.cuda.device_count() > 1:
        with phase(f"split P{2 * opts.ranks}-B NCCL"):
            launches_nc = run_nccl_ranks(graphs.name, opts.ranks)
    else:
        print(f"split P{2 * opts.ranks}-B NCCL: needs {opts.ranks} cards, "
              f"this machine has 1; not run")
    # 12. ddp and quiver P2 in one process and over gloo, at P(2N) over
    # NCCL on several cards; infer at --ranks processes.
    launches_bl = baseline_rank_phases(phase, graphs.name, opts.ranks,
                                       infer_ref)
    graphs.cleanup()

    # 13. Summary. In the kernels line, the fused entry's numbers are one
    # single SAGE step's three forward shapes, the messages' entry's one
    # single GAT step's; the launches are those of every phase's main-path
    # run, by entry.
    print("split op times (split A's first batch, CUDA events over 20 "
          "eager calls; the dense aggregation through its kernels, the rest "
          "torch ops; a step runs "
          "the synthesis once, the dense aggregation 3 times forward and "
          "2 times backward, slice_owned 3 times):")
    for op, ms, bound in op_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms")
    print("GAT op times (split GAT A's first batch; a step runs each layer's "
          "batched attention once forward and once backward):")
    for op, ms, bound in gat_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms")
    print("lowering op times (split A's and split GAT A's first batch; a "
          "step runs the synthesis once, the dense aggregation once a layer "
          "forward, the attention once a layer each way):")
    for op, ms, bound in sample_rows + [tiled_row] + gat_variant_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms")
    print("baseline op times (torch ops; pa-cache: the first batch's "
          "frame, once a step; quiver: its first batch, the draw once a "
          "layer, the gather and the layer-0 mean once a step):")
    for op, ms, bound in [pc_row] + quiver_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms")
    print(f"quiver: peak device memory {quiver['peak_gib']:.3f} GiB, "
          f"profiled step idle share "
          f"{quiver_profile['device_idle_share']:.4f}")
    print("fused entry's backward, torch ops, at the single SAGE step's "
          "layers 1-2 (once a step each):")
    for op, ms, bound in backward_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms")
    print("GAT shuffle times (split GAT P2-B, one process holding both "
          "partitions, host clock; a step runs each once a layer):")
    for op, ms, bound, by in gat_shuffle_rows:
        print(f"  {op}: {ms:.4f} ms, bound {bound:.4f} ms ({by})")

    def bound(c):
        return max(c["bytes_ms"], c["ops_ms"])

    def summed(cases, key):
        return sum(bound(c) if key == "bound_ms" else c[key] for c in cases)

    keys = ("ms", "bound_ms", "plain_ms", "index_add_ms", "reduce_ms",
            "as_run_ms", "library_ms")
    sage_step = [c[FUSED] for c in main_cases]
    rows = [
        (FUSED, "single SAGE step (3 launches)", sage_step),
        (MSGS, "single SAGE step's shapes", [c[MSGS] for c in main_cases]),
        (FUSED, "GCN sym's step (3 launches)", [c[FUSED] for c in sym_cases]),
        (MSGS, "GCN sym's step's shapes", [c[MSGS] for c in sym_cases]),
        (MSGS, "single GAT's step (3 launches)", gat_cases),
        (MSGS, "single GAT's layer 0", gat_cases[:1]),
    ] + [(entry, f"{label} layer 0", [cases[entry]])
         for label, cases in (("single SAGE's", main_cases[0]),
                              ("GCN sym's", sym_cases[0]),
                              ("split B's", split_case),
                              ("split GAT B's", gat_split_case),
                              ("infer's", infer_case),
                              ("split P4-B local's", p4_cases))
         for entry in (MSGS, FUSED)] + [
        (FUSED, "split B's layer 0, bf16 frame", [split_bf16_case])]
    print("kernel times (ms; segment_reduce in the kernel's own harness; "
          "as_run: x.index_select(0, src).float() then the messages' "
          "entry):")
    for entry, label, cases in rows:
        print(f"  {entry} at {label}: " + " ".join(
            f"{'segment_reduce_ms' if k == 'reduce_ms' else k}="
            f"{summed(cases, k):.4f}" for k in keys if k in cases[0]))
    print("dense kernel times (ms; CUDA-graph harness; embedding_bag the "
          "library call on f32 frames, its index transposed ahead of the "
          "timing, its backward through torch.autograd.grad with its "
          "forward in the graph, less the forward):")
    dense_rows = [(f"split A layer {i}", c) for i, c in dense_a.items()]
    dense_rows += [("split A layer 0, bf16 frame",
                    {DENSE_FWD: dense_a_bf16})]
    dense_rows += [(f"split B layer {i}", c) for i, c in dense_b.items()]
    dense_rows += [(f"split P4-B local layer {i}, one partition", c)
                   for i, c in dense_p4.items()]
    for label, cases in dense_rows:
        for entry, c in cases.items():
            lib = c["library_ms"]
            print(f"  {entry} at {label}: ms={c['ms']:.4f} bound_ms="
                  f"{bound(c):.4f} plain_ms={c['plain_ms']:.4f} "
                  f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
                  f"max_abs_err={c['err']:.3g}")
    errs = {entry: [] for entry in ENTRIES}
    for cases in (main_cases + ragged + sym_cases
                  + [split_case, gat_split_case, infer_case, p4_cases]
                  + [c for _, c in dense_rows]):
        for entry, c in cases.items():
            errs[entry].append(c["err"])
    errs[MSGS] += [c["err"] for c in gat_cases]
    errs[FUSED].append(split_bf16_case["err"])
    launches = sum((single_launches, launches_pc, launches_a, launches_dt,
                    launches_ga, launches_gv, launches_b, launches_u,
                    launches_sgl, launches_sym, launches_i1, launches_pb,
                    launches_gl, launches_p4, launches_en, launches_nc,
                    launches_bl), Counter())
    # The dense kernels' numbers are one split A step's: the forward at
    # its three layers, the backward at layers 1-2.
    kernels = []
    for entry, cases in (
            (MSGS, gat_cases), (FUSED, sage_step),
            (DENSE_FWD, [dense_a[i][DENSE_FWD] for i in sorted(dense_a)]),
            (DENSE_BWD, [c[DENSE_BWD] for _, c in sorted(dense_a.items())
                         if DENSE_BWD in c])):
        by_bytes = summed(cases, "bytes_ms") >= summed(cases, "ops_ms")
        kernels.append({
            "name": entry,
            "route": "cuda",
            "source": KERNEL_SOURCE[entry],
            "replaces": KERNEL_REPLACES[entry],
            "launches": launches[entry],
            "max_abs_err": max(errs[entry]),
            "ms": summed(cases, "ms"),
            "plain_ms": summed(cases, "plain_ms"),
            "bound_ms": summed(cases, "bound_ms"),
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": summed(cases, "library_ms"),
        })
    print(f"total wall {time.perf_counter() - wall:.1f}s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
