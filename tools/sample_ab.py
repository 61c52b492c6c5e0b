#!/usr/bin/env python3
"""Split A, split GAT A and quiver in two checkouts on one card, in turns:
the steps the on-device samplers run on.

    python3 tools/sample_ab.py run --parent DIR [--out DIR]
    python3 tools/sample_ab.py graph ROOT
    python3 tools/sample_ab.py step ROOT --label L --out DIR

``graph`` builds the products-scale graph of ``chip_smoke.py`` and saves
it under ROOT. ``step``, run from the root of a checkout, builds that
checkout's kernels, times two of them at the main path's shapes, and
drives, each through its own entry points:

* the kernels: ``gather_mean`` at quiver's deepest frontier (a trainer
  seeded as ``train_quiver``'s, its first batch; the f32 table and a bf16
  copy) and ``synthesize_innermost`` at split A's layer 0 (the first
  batch of ``chip_smoke.check_synthesized_layer``), each in the CUDA-graph
  harness (``chip_smoke.median_ms``), and the synthesis call as split A
  makes it (``torch.randint`` and the kernel, CUDA events over 20 eager
  calls, the median of 7 such), beside the byte bound, the no-reuse
  floor and, for the gather-mean, the distinct-row floor (each output's
  distinct rows read once, in whole sectors), computed here from the
  same inputs;
* split A and split GAT A (``chip_smoke.SPLIT_A_FLAGS`` and
  ``GAT_A_FLAGS``: replicated cache, layer 0 synthesized on the card, 8
  steps, the fifth profiled) through ``train_split``;
* quiver (``chip_smoke.QUIVER_FLAGS``, 8 steps) through ``train_quiver``,
  then a trainer seeded as that run's: 8 steps with one synchronise after
  the first and one after the last (the steady ms a step of steps 2-8),
  then one steady step profiled (``chip_smoke.profile_one_step``);

and prints one JSON line a cell (the kernels one too): the medians of
steps 2-8 of
``train_step`` and of the step wall (split), quiver's ``fused_step`` a
step (its warm-up in) and steady ms a step, the peak device memory, the
launches by kernel, and the profiled step's kernels, device busy, window,
idle share and the samplers' named ranges. ``run`` does ``graph`` once,
then ``step`` in turns (``tools/ab_turns.py``: parent, change, change,
parent, the change being the checkout this script lies in), and prints
both sides' lines.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

from ab_turns import CHANGE, call, in_turns, print_tagged

QUIVER_STEPS = 8
RANGES = ("synthesize_device_innermost", "quiver_draw", "quiver_gather",
          "dense_sage_forward", "train_step")


def make_graph(root: str) -> None:
    """The products-scale graph, saved under ``root`` as ``products``."""
    sys.path.insert(0, str(CHANGE))
    import chip_smoke as cs
    from occ_gnn_tpu_torch.data import random_graph, save_graph

    args = cs.graph_args(cs.PRODUCTS_NODES, cs.TRAIN_FLAGS)
    g = random_graph(cs.PRODUCTS_NODES, cs.AVG_DEGREE, cs.FEATURE_DIM,
                     num_classes=cs.NUM_CLASSES, seed=args.seed)
    save_graph(g, root, "products")


def profile_fields(prof: dict) -> dict:
    named = {k: v["device_ms"] for k, v in prof["named_ms"].items()
             if k in RANGES}
    return {"kernels": prof["device_kernels"],
            "busy_ms": prof["device_busy_ms"], "window_ms": prof["window_ms"],
            "idle": prof["device_idle_share"], "ranges_ms": named}


def kernel_times(cs, g, device) -> dict:
    """The redesigned samplers' kernels of this checkout at the main path's
    shapes, with their bounds and floors (ms)."""
    import torch

    from occ_gnn_tpu_torch.models import get_model
    from occ_gnn_tpu_torch.ops.device_sample import (
        gather_mean,
        synthesize_innermost,
    )
    from occ_gnn_tpu_torch.parallel.split import synthesize_device_innermost
    from occ_gnn_tpu_torch.sampling.device_sampler import DeviceSampleTrainer

    rate = cs.memory_rate(torch.cuda.get_device_name(0))
    out = {}
    args = cs.graph_args(g.num_nodes, cs.QUIVER_FLAGS)
    fanouts = [int(f) for f in args.fan_out.split(",")]
    model = get_model("sage", g.feature_dim, args.num_hidden, g.num_classes,
                      len(fanouts),
                      generator=torch.Generator().manual_seed(args.seed))
    trainer = DeviceSampleTrainer(g, fanouts, args.batch_size,
                                  model.to(device), None, seed=args.seed,
                                  device=device)
    targets, _ = next(trainer.epoch_batches(
        g.train_nodes()[: args.limit_train]))
    with torch.no_grad():
        frontiers = trainer.sample(torch.from_numpy(targets[0]).to(device))
    deep, n, K = frontiers[-1], frontiers[-2].shape[0], fanouts[-1]
    # ops/device_sample.distinct_rows, inline: a parent's checkout may
    # not have it.
    ids = torch.cat([deep[:n, None], deep[n:].view(n, K)], 1)
    ids = ids.sort(dim=1).values
    distinct = int((1 + (ids[:, 1:] != ids[:, :-1]).sum(dim=1)).sum())
    rows = torch.unique(deep).numel()
    for name, table in (("f32", trainer.features),
                        ("bf16", trainer.features.to(torch.bfloat16))):
        H = table.shape[1]
        row = H * table.element_size()
        sector = -(-row // 32) * 32
        coalesced = 4 * deep.numel() + 8 * n * H
        out[f"gather_mean {name}"] = {
            "ms": cs.median_ms(lambda: gather_mean(table, deep, n, K)),
            "bound_ms": (coalesced + rows * row) / rate * 1e3,
            "floor_ms": (coalesced + deep.numel() * sector) / rate * 1e3,
            "distinct_floor_ms": (coalesced + distinct * sector) / rate * 1e3,
            "n": n, "K": K, "H": H, "rows": rows, "distinct": distinct}
    del trainer, frontiers, deep, ids, table
    args = cs.graph_args(g.num_nodes, cs.SPLIT_A_FLAGS)
    fanouts = [int(f) for f in args.fan_out.split(",")]
    batch, _, (indptr, indices) = cs.check_synthesized_layer(
        g, fanouts, args.batch_size, device)
    l0 = batch.layers[0].partition(0)
    dg, K, O, S = l0.dst_global, l0.fanout, l0.out_cap, l0.src_cap
    D = dg.shape[0]
    gen = torch.Generator(device).manual_seed(16)
    draws = torch.randint(0, 2**62, (K, D), generator=gen, device=device)
    valid = dg >= 0
    g0 = dg.clamp(min=0).long()
    deg = torch.where(valid, indptr[g0 + 1] - indptr[g0], 0)
    nvalid, drawn = int(valid.sum()), int((deg > K).sum())
    used = int(deg.clamp(max=K).sum())
    # chip_smoke.synthesis_cases' bound and floor.
    coalesced = 4 * D + 8 * K * drawn + 4 * (K + 1) * D + 13 * O + 4
    out["synthesize_innermost"] = {
        "ms": cs.median_ms(lambda: synthesize_innermost(
            dg, indptr, indices, draws, K, S, O)),
        # The call is host-bound and its host shared: the median of 7
        # measures of 20 eager calls each.
        "call_ms": statistics.median(
            cs.events_ms(lambda: synthesize_device_innermost(
                l0, indptr, indices, gen)) for _ in range(7)),
        "bound_ms": (coalesced + 8 * nvalid + 4 * used) / rate * 1e3,
        "floor_ms": (coalesced + 32 * nvalid + 32 * used) / rate * 1e3,
        "K": K, "D": D, "valid": nvalid, "drawn": drawn, "used": used}
    return out


def run_step(root: str, label: str, out: str) -> None:
    """In the checkout at the working directory: its split A, split GAT A
    and quiver runs, one JSON line each."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from occ_gnn_tpu_torch.data import load_graph
    from occ_gnn_tpu_torch.models import get_model
    from occ_gnn_tpu_torch.sampling.device_sampler import DeviceSampleTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cs.build_all()
    g = load_graph(root, "products")
    print("STEP " + json.dumps({
        "label": label, "cell": "kernels",
        **kernel_times(cs, g, device)}), flush=True)
    for cell, flags in (("split A", cs.SPLIT_A_FLAGS),
                        ("split GAT A", cs.GAT_A_FLAGS)):
        args = cs.graph_args(g.num_nodes, flags + [
            "--profile-dir",
            os.path.join(out, f"{label}_{cell.replace(' ', '_')}")])
        fanouts = [int(f) for f in args.fan_out.split(",")]
        timers = cs.StepTimers()
        cs.start_count(device)
        metrics = cs.train_split(args, g, fanouts, timers, device)
        launches = {k: v for k, v in cs.read_launches().items() if v}
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        starts = timers.starts["train_step"]
        walls = [1e3 * (b - a) for a, b in zip(starts, starts[1:])][1:]
        print("STEP " + json.dumps({
            "label": label, "cell": cell, "steps": metrics["steps"],
            "loss": metrics["loss"],
            "train_step_ms": statistics.median(timers.each["train_step"][1:]),
            "step_wall_ms": statistics.median(walls),
            "sample_ms": statistics.median(timers.each["sample"][1:]),
            "peak_gib": peak, "launches": launches,
            **profile_fields(metrics["profile"])}), flush=True)

    args = cs.graph_args(g.num_nodes, cs.QUIVER_FLAGS)
    fanouts = [int(f) for f in args.fan_out.split(",")]
    timers = cs.StepTimers()
    cs.start_count(device)
    metrics = cs.train_quiver(args, g, fanouts, timers, device)
    launches = {k: v for k, v in cs.read_launches().items() if v}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    fused = 1e3 * metrics["phases"]["fused_step"] / metrics["steps"]
    nodes = g.train_nodes()[: args.limit_train]

    def trainer():
        model = get_model("sage", g.feature_dim, args.num_hidden,
                          g.num_classes, len(fanouts),
                          generator=torch.Generator().manual_seed(args.seed))
        model = model.to(device)
        return DeviceSampleTrainer(
            g, fanouts, args.batch_size, model,
            torch.optim.Adam(model.parameters(), lr=args.lr), seed=args.seed,
            device=device)

    t = trainer()
    batches = t.epoch_batches(nodes)
    t.step(*next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(QUIVER_STEPS - 1):
        t.step(*next(batches))
    torch.cuda.synchronize()
    steady = 1e3 * (time.perf_counter() - t0) / (QUIVER_STEPS - 1)
    del t, batches
    prof = cs.profile_one_step(trainer(), nodes)
    print("STEP " + json.dumps({
        "label": label, "cell": "quiver", "steps": metrics["steps"],
        "loss": metrics["loss"], "fused_step_ms_a_step": fused,
        "steady_ms_a_step": steady, "peak_gib": peak, "launches": launches,
        **profile_fields(prof)}), flush=True)


def run_all(parent: str, out: str) -> int:
    me = str(Path(__file__).resolve())

    def setup(root):
        call([sys.executable, me, "graph", root], str(CHANGE),
             os.path.join(out, "graph.log"))

    def turn(cwd, root, tag):
        print_tagged(call([sys.executable, me, "step", root, "--label", tag,
                           "--out", out], cwd,
                          os.path.join(out, f"step_{tag}.log")), "STEP")

    return in_turns(parent, out, "sample_ab_", setup, turn)


def main(argv=None) -> int:
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = cli.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--parent", required=True,
                   help="root of the parent's checkout")
    r.add_argument("--out", default="chiprun_out/sample_ab")
    gr = sub.add_parser("graph")
    gr.add_argument("root")
    s = sub.add_parser("step")
    s.add_argument("root")
    s.add_argument("--label", required=True)
    s.add_argument("--out", required=True)
    a = cli.parse_args(argv)
    if a.cmd == "graph":
        make_graph(a.root)
        return 0
    if a.cmd == "step":
        run_step(a.root, a.label, os.path.abspath(a.out))
        return 0
    return run_all(os.path.abspath(a.parent), os.path.abspath(a.out))


if __name__ == "__main__":
    sys.exit(main())
