#!/usr/bin/env python3
"""GAT's attention kernels and split GAT A in two checkouts on one card,
in turns.

    python3 tools/gat_ab.py run --parent DIR [--out DIR]
    python3 tools/gat_ab.py inputs ROOT
    python3 tools/gat_ab.py cases ROOT --label L
    python3 tools/gat_ab.py step ROOT --label L --out DIR
    python3 tools/gat_ab.py routes
    python3 tools/gat_ab.py host

``inputs`` builds the products-scale graph of ``chip_smoke.py`` (saved
under ROOT) and the main path's dense neighbour matrices
(``tools/dense_ab.py``'s: split GAT A's first batch, layer 0 synthesized
on the card, layers 1-2, which split A's sampler gives alike, and GAT
P4-B partition 0's layers 1-2, split P4-B's), into ``ROOT/inputs.pt``.
``cases``, run from the root of a checkout, holds that checkout's
attention kernels and ``dense_scatter_slots`` at every matrix through its
own ``chip_smoke.gat_attention_cases`` (random f32 frames from a seed, 4
heads, Dh 32 and 47 at the last layer; layer 0 in bf16 too; and the
smoke's timed ragged case, the CLI's hidden width) and prints one JSON
line of times a case. ``step`` builds that checkout's kernels and drives
split GAT A (``chip_smoke.GAT_A_FLAGS``: hidden 32, 4 heads, replicated
cache, layer 0 synthesized on the card, 8 steps, the fifth profiled)
through its own ``train_split``, and prints one JSON line: the medians of
steps 2-8 of ``train_step`` and of the step wall (one step's launch to
the next's), the host's side beside them (the C++ service's
``cxx_sample`` and ``cxx_slice`` ms a batch, and the medians of steps 2-8
of the ``sample`` phase), the peak device memory, the launches by kernel,
and the profiled step's kernels, device busy, window, idle share and the
attention's named ranges. ``run`` does ``inputs`` once, then ``cases``
and ``step`` in turns (``tools/ab_turns.py``: parent, change, change,
parent, the change being the checkout this script lies in), and prints
both sides' lines.

``host``, in this checkout alone, measures what the scatter plans cost
the host in steady state: split GAT A's C++ sampler (the products-scale
graph, replicated cache, layer 0 on the card, the planned capacities of
``chip_smoke.check_synthesized_layer``) without and with
``scatter_plans``, in turns (off, on, on, off), each for HOST_BATCHES
batches: the workers' ``cxx_slice`` and ``cxx_sample`` ms a batch and
the median and 90th percentile of the main thread's ``next()`` (the
trainer's ``sample`` phase), all after HOST_WARM batches, when the
service's pooled buffers have been touched once; one JSON line a turn.

``routes``, in this checkout alone, first holds the attention kernels to
their plain versions at every one of the smoke's ragged cases
(``chip_smoke.gat_ragged_cases``, untimed: each takes the route its plan
gives), then times both routes of each kernel, the staged kernels (where
a column fits a block) and the ``_any`` kernels, at shapes from split GAT
A's layer 0 to the CLI's widest options (random f32 or bf16 frames and
matrices, 30 % padding, from a seed), and prints one JSON line a shape
and kernel: the staged plan's warps an SM, both routes' times, the route
the plan takes, and the largest difference between the routes' outputs
(of the output's max |.|). ``ops/gat_attention.MIN_STAGED_WARPS`` and
``MIN_STAGED_READ`` are set from these lines.
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
from dense_ab import make_inputs

HEADS = 4


def run_cases(root: str, label: str) -> None:
    """In the checkout at the working directory: its attention cases at
    every matrix, one JSON line each."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cs.build_all()
    rate = cs.memory_rate(torch.cuda.get_device_name(0))
    mats = torch.load(os.path.join(root, "inputs.pt"))
    gen = torch.Generator(device).manual_seed(21)
    args = cs.graph_args(cs.PRODUCTS_NODES, cs.GAT_A_FLAGS)
    runs = []
    for name, (nbr, S, _) in mats.items():
        if name.startswith("split B"):
            continue
        layer = int(name[-1])
        name = name.replace("split A", "split GAT A").replace(
            "split P4-B", "GAT P4-B")
        H = cs.FEATURE_DIM if layer == 0 else args.num_hidden * HEADS
        dh = cs.NUM_CLASSES if layer == 2 else args.num_hidden
        x = torch.randn(S, H, generator=gen, device=device)
        x[S - 1] = 0.0
        nbr = nbr.to(device)
        dtypes = [torch.float32] + ([torch.bfloat16] if layer == 0 else [])
        for dtype in dtypes:
            runs.append(dict(label=name, x=x.to(dtype), nbr=nbr, heads=HEADS,
                             dh=dh, gen=gen,
                             grad_x=layer > 0 and dtype == torch.float32))
    runs += [c for c in cs.gat_ragged_cases(device) if c["timed"]]
    for run in runs:
        x, nbr = run["x"], run["nbr"]
        cases = cs.gat_attention_cases(
            f"{label}: {run['label']}", x, nbr, run["heads"], run["dh"],
            rate, run["gen"], run["grad_x"])
        row = {"label": label, "case": run["label"],
               "dtype": str(x.dtype)[6:], "K": nbr.shape[0],
               "D": nbr.shape[1], "S": x.shape[0], "H": x.shape[1],
               "valid": int((nbr != x.shape[0] - 1).sum())}
        for kernel, c in cases.items():
            row[kernel] = {k: c.get(k) for k in
                           ("ms", "plain_ms", "library_ms", "bytes_ms",
                            "ops_ms", "floor_ms", "err")}
        print("AB " + json.dumps(row), flush=True)
        del run["x"]


def run_step(root: str, label: str, out: str) -> None:
    """In the checkout at the working directory: split GAT A's run."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from occ_gnn_tpu_torch.data import load_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cs.build_all()
    g = load_graph(root, "products")
    args = cs.graph_args(g.num_nodes, cs.GAT_A_FLAGS + [
        "--profile-dir", os.path.join(out, label)])
    fanouts = [int(f) for f in args.fan_out.split(",")]
    timers = cs.StepTimers()
    cs.start_count(device)
    metrics = cs.train_split(args, g, fanouts, timers, device)
    launches = dict(cs.read_launches())
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    starts = timers.starts["train_step"]
    walls = [1e3 * (b - a) for a, b in zip(starts, starts[1:])][1:]
    prof = metrics["profile"]
    named = {k: v["device_ms"] for k, v in prof["named_ms"].items()
             if "gat" in k.lower() or "Gat" in k}
    phases = metrics["phases"]
    print("STEP " + json.dumps({
        "label": label, "steps": metrics["steps"], "loss": metrics["loss"],
        "train_step_ms": statistics.median(timers.each["train_step"][1:]),
        "step_wall_ms": statistics.median(walls),
        "sample_ms": statistics.median(timers.each["sample"][1:]),
        "cxx_sample_ms": 1e3 * phases["cxx_sample"],
        "cxx_slice_ms": 1e3 * phases["cxx_slice"],
        "peak_gib": peak, "launches": launches,
        "kernels": prof["device_kernels"], "busy_ms": prof["device_busy_ms"],
        "window_ms": prof["window_ms"], "idle": prof["device_idle_share"],
        "attention_ranges_ms": named}), flush=True)


# (K, D, S, H, heads, dtype) where the routes are timed: split GAT A's
# layer 0 and layer 1, 5 and 9 heads, K = 40, bf16 rows of odd width, and
# the CLI's hidden widths (256 x 4 and, --num-hidden 128, 128 x 4).
# Past the first two, D = 8,192 columns keep each call short.
ROUTE_SHAPES = [
    (26, 123_904, 200_000, 100, 4, "float32"),
    (11, 22_528, 100_000, 128, 4, "float32"),
    (11, 8_192, 20_000, 200, 5, "float32"),
    (11, 8_192, 20_000, 300, 9, "float32"),
    (40, 8_192, 20_000, 64, 4, "float32"),
    (40, 8_192, 20_000, 100, 4, "float32"),
    (26, 8_192, 20_000, 301, 4, "bfloat16"),
    (26, 8_192, 20_000, 602, 8, "bfloat16"),
    (11, 8_192, 20_000, 512, 4, "float32"),
    (11, 8_192, 20_000, 1024, 4, "float32"),
]


def run_routes() -> None:
    """In this checkout: the ragged cases' checks, then both routes' times
    at ROUTE_SHAPES."""
    sys.path.insert(0, str(CHANGE))
    import torch

    import chip_smoke as cs
    from occ_gnn_tpu_torch.ops import gat_attention as ga

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    cs.build_all()
    rate = cs.memory_rate(torch.cuda.get_device_name(0))
    for c in cs.gat_ragged_cases(device):
        c["timed"] = False
        cs.gat_attention_cases(rate=rate, **c)
    gen = torch.Generator(device).manual_seed(22)
    sms = ga._sms(device)
    chosen = ga._plan
    for K, D, S, H, heads, dtype in ROUTE_SHAPES:
        nbr = torch.randint(0, S - 1, (K, D), generator=gen, device=device,
                            dtype=torch.int32)
        nbr[torch.rand(K, D, generator=gen, device=device) < 0.3] = S - 1
        x = torch.randn(S, H, generator=gen, device=device)
        x[S - 1] = 0.0
        x = x.to(getattr(torch, dtype))
        wl = 0.1 * torch.randn(H, heads, generator=gen, device=device)
        er = torch.randn(D, heads, generator=gen, device=device)
        ds = torch.randn(D, heads, generator=gen, device=device)
        dagg = torch.randn(D, heads, H, generator=gen, device=device)
        grad_x = dtype == "float32"
        m = ga.gat_attention_fwd(x, nbr, wl, er)[0]
        valid = (nbr != S - 1).reshape(-1)
        for backward in (False, True):
            args = (K, H, heads, x.element_size(), D, sms, backward,
                    ga._align(x))
            plans = {"staged": ga.staged_plan(*args),
                     "_any": ga.any_plan(D, sms, backward)}
            row = {"K": K, "D": D, "S": S, "H": H, "heads": heads,
                   "dtype": dtype,
                   "kernel": cs.GAT_BWD if backward else cs.GAT_FWD,
                   "takes": ("staged" if ga.attention_plan(*args).layout
                             is not None else "_any")}
            outs = {}
            for route, plan in plans.items():
                if plan is None:
                    row[f"{route}_ms"] = None
                    continue
                if route == "staged":
                    row["staged_warps_an_sm"] = plan.warps_an_sm
                ga._plan = lambda *_, plan=plan: plan
                try:
                    if backward:
                        fn = lambda: ga.gat_attention_bwd(  # noqa: E731
                            x, nbr, wl, er, m, ds, dagg, grad_x)
                    else:
                        fn = lambda: ga.gat_attention_fwd(  # noqa: E731
                            x, nbr, wl, er)
                    out = fn()
                    if backward and grad_x:
                        out = (out[0][valid],) + tuple(out[1:])
                    outs[route] = [t for t in out if t is not None]
                    row[f"{route}_ms"] = cs.median_ms(fn)
                finally:
                    ga._plan = chosen
            if len(outs) == 2:
                row["routes_differ"] = max(
                    ((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    .item() for a, b in zip(outs["staged"], outs["_any"]))
            print("ROUTE " + json.dumps(row), flush=True)


HOST_BATCHES, HOST_WARM = 64, 16


def run_host() -> None:
    """In this checkout: the plans' host cost, in turns."""
    sys.path.insert(0, str(CHANGE))
    import numpy as np
    import torch

    import chip_smoke as cs
    from occ_gnn_tpu_torch.cache import CachePlan
    from occ_gnn_tpu_torch.data import random_graph
    from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
    from occ_gnn_tpu_torch.sampling.slicer import plan_split_capacities

    print(f"card: {cs.card_line()}", flush=True)
    device = torch.device("cuda")
    args = cs.graph_args(cs.PRODUCTS_NODES, cs.GAT_A_FLAGS)
    g = random_graph(cs.PRODUCTS_NODES, cs.AVG_DEGREE, cs.FEATURE_DIM,
                     num_classes=cs.NUM_CLASSES, seed=args.seed)
    fanouts = [int(f) for f in args.fan_out.split(",")]
    bs = args.batch_size
    pmap = np.zeros(g.num_nodes, np.int32)
    caps = plan_split_capacities(bs, fanouts, g.num_nodes, 1)
    plan = CachePlan(g, pmap, 1, 1.0, refresh_cap=8)
    for turn, plans in enumerate((False, True, True, False)):
        sampler = NativeSplitSampler(
            g, g.train_nodes(), pmap, 1, fanouts, bs, capacities=caps,
            seed=turn, cache=plan, num_workers=args.num_workers,
            innermost="device", scatter_plans=plans, device=device)
        pops, stats = [], []
        batches = iter(sampler)
        for i in range(HOST_BATCHES):
            if i == HOST_WARM:
                stats.append(sampler.stats())
            t0 = time.perf_counter()
            next(batches)
            pops.append(1e3 * (time.perf_counter() - t0))
        stats.append(sampler.stats())
        sampler.close()
        torch.cuda.synchronize()
        n = stats[1]["samples"] - stats[0]["samples"]

        def per(key):
            return 1e3 * (stats[1][key] - stats[0][key]) / n

        steady = sorted(pops[HOST_WARM:])
        print("HOST " + json.dumps({
            "turn": turn, "scatter_plans": plans, "samples": n,
            "arena_words": sampler._arena_words,
            "cxx_slice_ms": per("slice_s_total"),
            "cxx_sample_ms": per("sample_s_total"),
            "pop_median_ms": statistics.median(steady),
            "pop_p90_ms": steady[int(0.9 * (len(steady) - 1))]}),
            flush=True)


def run_all(parent: str, out: str) -> int:
    me = str(Path(__file__).resolve())

    def setup(root):
        call([sys.executable, me, "inputs", root], str(CHANGE),
             os.path.join(out, "inputs.log"))

    def turn(cwd, root, tag):
        print_tagged(call([sys.executable, me, "cases", root, "--label", tag],
                          cwd, os.path.join(out, f"cases_{tag}.log")), "AB")
        print_tagged(call([sys.executable, me, "step", root, "--label", tag,
                           "--out", out], cwd,
                          os.path.join(out, f"step_{tag}.log")), "STEP")

    return in_turns(parent, out, "gat_ab_", setup, turn)


def main(argv=None) -> int:
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = cli.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--parent", required=True,
                   help="root of the parent's checkout")
    r.add_argument("--out", default="chiprun_out/gat_ab")
    i = sub.add_parser("inputs")
    i.add_argument("root")
    c = sub.add_parser("cases")
    c.add_argument("root")
    c.add_argument("--label", required=True)
    s = sub.add_parser("step")
    s.add_argument("root")
    s.add_argument("--label", required=True)
    s.add_argument("--out", required=True)
    sub.add_parser("routes")
    sub.add_parser("host")
    a = cli.parse_args(argv)
    if a.cmd == "routes":
        run_routes()
        return 0
    if a.cmd == "host":
        run_host()
        return 0
    if a.cmd == "inputs":
        make_inputs(a.root, split_b=False)
        return 0
    if a.cmd == "cases":
        run_cases(a.root, a.label)
        return 0
    if a.cmd == "step":
        run_step(a.root, a.label, os.path.abspath(a.out))
        return 0
    return run_all(os.path.abspath(a.parent), os.path.abspath(a.out))


if __name__ == "__main__":
    sys.exit(main())
