#!/usr/bin/env python3
"""Split A, split GAT A and quiver in two checkouts on one card, in turns:
the steps the on-device samplers run on.

    python3 tools/sample_ab.py run --parent DIR [--out DIR]
    python3 tools/sample_ab.py graph ROOT
    python3 tools/sample_ab.py step ROOT --label L --out DIR
    python3 tools/sample_ab.py variants ROOT --out DIR

``graph`` builds the products-scale graph of ``chip_smoke.py`` and saves
it under ROOT. ``step``, run from the root of a checkout, builds that
checkout's kernels, times two of them at the main path's shapes, and
drives, each through its own entry points:

* the kernels: ``draw_neighbors`` at quiver's three layers (the
  frontiers of a trainer seeded as ``train_quiver``'s, its first batch;
  fresh int32 draws from a seed), ``gather_mean`` at its deepest frontier
  (the f32 table and a bf16 copy) and ``synthesize_innermost`` at split
  A's layer 0 (the first batch of ``chip_smoke.check_synthesized_layer``),
  each in the CUDA-graph harness (``chip_smoke.median_ms``), and the
  synthesis call as split A makes it (``torch.randint`` and the kernel,
  CUDA events over 20 eager calls, the median of 7 such), beside the
  byte bound, the no-reuse floor, for the draws the run floors (each
  entry's, or each distinct node's, indptr pair and adjacency run in
  whole 32-byte sectors) and the entries that repeat a node of their
  tile of 8 (the kernel's), and for the gather-mean the distinct-row floor (each
  output's distinct rows read once, in whole sectors), computed here
  from the same inputs;
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
parent, the change being the checkout this script lies in), then
``variants`` in the change, and prints both sides' lines.

``variants``, run from the change's root, times the draw kernel's
design options (``DRAW_VARIANTS``) at quiver's three layers: libraries
built from copies of ``csrc/device_sample.cu`` with one text edit each
(the card's ``/`` and ``%`` in place of the reciprocals, other tiles,
no register cap, all the shared memory an SM gives), each checked
bit-equal to the plain version and timed in the CUDA-graph harness in
turns (forward, then backward), one JSON line a layer.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

from ab_turns import CHANGE, call, in_turns, print_tagged

QUIVER_STEPS = 8
RANGES = ("synthesize_device_innermost", "quiver_draw", "quiver_gather",
          "dense_sage_forward", "train_step")
# The draw kernel's options: (name, [(text of csrc/device_sample.cu, its
# replacement)]).
_MOD = ("mod32(static_cast<unsigned>(staged[i]), a.y, a.z)",
        "static_cast<unsigned>(staged[i]) % a.y")
_DIV = ("nodes[div32(w0 + i, K, k_recip)]", "nodes[(w0 + i) / K]")
_TILE = "constexpr int kDrawTile = 8;"
_STAGE = "  const int stage =\n      k < kDrawStage / kDrawTile"
DRAW_VARIANTS = (
    ("the source", ()),
    ("r % deg by %", (_MOD,)),
    ("w / K and r % deg by / and %", (_MOD, _DIV)),
    ("a tile of 4 entries", ((_TILE, _TILE.replace("8", "4")),)),
    ("a tile of 16 entries", ((_TILE, _TILE.replace("8", "16")),)),
    ("a tile of 32 entries", ((_TILE, _TILE.replace("8", "32")),)),
    ("no register cap", (("__launch_bounds__(kDrawThreads, kDrawBlocksAnSm)",
                          "__launch_bounds__(kDrawThreads)"),)),
    ("all the shared memory an SM gives", ((_STAGE, """\
  static const cudaError_t carveout = cudaFuncSetAttribute(
      draw_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
""" + _STAGE),)),
)


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


def quiver_frontiers(cs, g, device):
    """A trainer seeded as ``train_quiver``'s, its fan-outs and the
    frontiers of its first batch."""
    import torch

    from occ_gnn_tpu_torch.models import get_model
    from occ_gnn_tpu_torch.sampling.device_sampler import DeviceSampleTrainer

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
    return trainer, fanouts, frontiers


def run_bytes(f, indptr, distinct=False) -> int:
    """ops/device_sample.run_sectors, inline: a parent's checkout may not
    have it."""
    import torch

    f = f.long()
    if distinct:
        f = torch.unique(f)
    start, end = indptr[f].long(), indptr[f + 1].long()
    spans = torch.where(end > start, (4 * end + 31) // 32 - 4 * start // 32,
                        0)
    return 32 * (f.numel() + int(spans.sum()))


def tile_repeats(f, tile=8) -> int:
    """The frontier entries whose node came earlier in their tile (the draw
    kernel's warp tile, kDrawTile in csrc/device_sample.cu)."""
    import torch

    tiles = torch.nn.functional.pad(f.long(), (0, -f.numel() % tile),
                                    value=-1)
    tiles = tiles.view(-1, tile).sort(dim=1).values
    return int(((tiles[:, 1:] == tiles[:, :-1]) & (tiles[:, 1:] >= 0)).sum())


def draw_inputs(fanouts, frontiers, device):
    """Each quiver layer's frontier, fan-out and fresh int32 draws."""
    import torch

    gen = torch.Generator(device).manual_seed(17)
    return [(f, K, torch.randint(0, 2**31 - 1, (f.shape[0], K), generator=gen,
                                 device=device, dtype=torch.int32))
            for f, K in zip(frontiers, fanouts)]


def kernel_times(cs, g, device) -> dict:
    """The redesigned samplers' kernels of this checkout at the main path's
    shapes, with their bounds and floors (ms)."""
    import torch

    from occ_gnn_tpu_torch.ops.device_sample import (
        draw_neighbors,
        gather_mean,
        synthesize_innermost,
    )
    from occ_gnn_tpu_torch.parallel.split import synthesize_device_innermost

    rate = cs.memory_rate(torch.cuda.get_device_name(0))
    out = {}
    trainer, fanouts, frontiers = quiver_frontiers(cs, g, device)
    indptr, indices = trainer.csr
    for m, (f, K, r) in enumerate(draw_inputs(fanouts, frontiers, device)):
        n = f.shape[0]
        fl = f.long()
        live = int((indptr[fl + 1] > indptr[fl]).sum())
        # chip_smoke.quiver_sample_cases' bound and floors.
        coalesced = 4 * n + 4 * n * K + 4 * n * (1 + K)
        out[f"draw_neighbors layer {m}"] = {
            "ms": cs.median_ms(lambda: draw_neighbors(f, indptr, indices, r)),
            "bound_ms": (coalesced + 8 * n + 4 * live * K) / rate * 1e3,
            "floor_ms": (coalesced + 32 * n + 32 * live * K) / rate * 1e3,
            "run_floor_ms": (coalesced + run_bytes(f, indptr)) / rate * 1e3,
            "distinct_run_floor_ms":
                (coalesced + run_bytes(f, indptr, True)) / rate * 1e3,
            "n": n, "K": K, "tile_repeats": tile_repeats(f)}
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
    del trainer, frontiers, deep, ids, table, r
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


def draw_variant_times(cs, csr, inputs, out: str) -> list:
    """``DRAW_VARIANTS`` of this checkout's draw kernel, each built into
    ``out``, at each (frontier, fan-out, draws) of ``inputs``: checked
    bit-equal to the plain version, then timed in turns (forward, then
    backward). Returns a {name: [ms, ms]} an input."""
    import torch

    from occ_gnn_tpu_torch.ops import build
    from occ_gnn_tpu_torch.ops import device_sample as ds

    indptr, indices = csr
    text = (build.CSRC_DIR / "device_sample.cu").read_text()
    entries = {}
    for i, (name, edits) in enumerate(DRAW_VARIANTS):
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name!r}: the source has no "
                                 f"{old!r}")
            src = src.replace(old, new)
        path = Path(out) / f"draw_variant{i}.cu"
        path.write_text(src)
        lib_path = path.with_suffix(".so")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                        str(path)], check=True, stdout=subprocess.DEVNULL)
        entry = ctypes.CDLL(str(lib_path)).draw_neighbors
        entry.argtypes = ds.ARGTYPES["draw_neighbors"]
        entry.restype = ctypes.c_int
        entries[name] = entry
    out_times = []
    for f, K, r in inputs:
        want = ds.draw_neighbors_reference(f, indptr, indices, r)

        def call(entry, f=f, K=K, r=r):
            got = torch.empty(f.shape[0] * (1 + K), dtype=torch.int32,
                              device=f.device)
            err = entry(f.data_ptr(), f.shape[0], indptr.data_ptr(),
                        indptr.shape[0] - 1, indices.data_ptr(),
                        indices.shape[0], r.data_ptr(), K, got.data_ptr(),
                        f.device.index,
                        torch.cuda.current_stream(f.device).cuda_stream)
            if err:
                raise RuntimeError(f"draw variant launch failed: {err}")
            return got

        for name, entry in entries.items():
            if not torch.equal(call(entry), want):
                raise SystemExit(f"variant {name!r} differs from the plain "
                                 f"version at n={f.shape[0]}, K={K}")
        times = {name: [] for name in entries}
        for name in list(entries) + list(reversed(entries)):
            times[name].append(cs.median_ms(
                lambda entry=entries[name]: call(entry)))
        out_times.append(times)
    return out_times


def run_variants(root: str, out: str) -> None:
    """In the checkout at the working directory: its draw kernel's options
    at quiver's three layers, one JSON line a layer."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from occ_gnn_tpu_torch.data import load_graph

    device = torch.device("cuda", 0)
    g = load_graph(root, "products")
    trainer, fanouts, frontiers = quiver_frontiers(cs, g, device)
    inputs = draw_inputs(fanouts, frontiers, device)
    for m, ((f, K, _), times) in enumerate(zip(
            inputs, draw_variant_times(cs, trainer.csr, inputs, out))):
        print("VARIANTS " + json.dumps({
            "cell": f"draw_neighbors layer {m}", "n": f.shape[0], "K": K,
            "ms": times}), flush=True)


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

    def after(root):
        print_tagged(call([sys.executable, me, "variants", root, "--out",
                           out], str(CHANGE),
                          os.path.join(out, "variants.log")), "VARIANTS")

    return in_turns(parent, out, "sample_ab_", setup, turn, after)


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
    v = sub.add_parser("variants")
    v.add_argument("root")
    v.add_argument("--out", required=True)
    a = cli.parse_args(argv)
    if a.cmd == "graph":
        make_graph(a.root)
        return 0
    if a.cmd == "step":
        run_step(a.root, a.label, os.path.abspath(a.out))
        return 0
    if a.cmd == "variants":
        run_variants(a.root, os.path.abspath(a.out))
        return 0
    return run_all(os.path.abspath(a.parent), os.path.abspath(a.out))


if __name__ == "__main__":
    sys.exit(main())
