#!/usr/bin/env python3
"""Split GAT A in two checkouts on one card, in turns.

    python3 tools/gat_ab.py run --parent DIR [--out DIR]
    python3 tools/gat_ab.py graph ROOT
    python3 tools/gat_ab.py step ROOT --label L --out DIR

``graph`` builds the products-scale graph of ``chip_smoke.py`` and saves
it under ROOT. ``step``, run from the root of a checkout, builds that
checkout's kernels and drives split GAT A (``chip_smoke.GAT_A_FLAGS``:
hidden 32, 4 heads, replicated cache, layer 0 synthesized on the card, 8
steps, the fifth profiled) through its own ``train_split``, and prints
one JSON line: the medians of steps 2-8 of ``train_step`` and of the step
wall (one step's launch to the next's), the peak device memory, the
launches by kernel, and the profiled step's kernels, device busy, window,
idle share and the attention's named ranges. ``run`` does ``graph`` once,
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


def make_graph(root: str) -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from occ_gnn_tpu_torch.data import random_graph, save_graph

    args = cs.graph_args(cs.PRODUCTS_NODES, cs.GAT_A_FLAGS)
    t0 = time.perf_counter()
    g = random_graph(cs.PRODUCTS_NODES, cs.AVG_DEGREE, cs.FEATURE_DIM,
                     num_classes=cs.NUM_CLASSES, seed=args.seed)
    save_graph(g, root, "products")
    print(f"graph {g.num_nodes} nodes in {time.perf_counter() - t0:.1f}s",
          flush=True)


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
    print("AB " + json.dumps({
        "label": label, "steps": metrics["steps"], "loss": metrics["loss"],
        "train_step_ms": statistics.median(timers.each["train_step"][1:]),
        "step_wall_ms": statistics.median(walls),
        "peak_gib": peak, "launches": launches,
        "kernels": prof["device_kernels"], "busy_ms": prof["device_busy_ms"],
        "window_ms": prof["window_ms"], "idle": prof["device_idle_share"],
        "attention_ranges_ms": named}), flush=True)


def run_all(parent: str, out: str) -> int:
    me = str(Path(__file__).resolve())

    def setup(root):
        call([sys.executable, me, "graph", root], str(CHANGE),
             os.path.join(out, "graph.log"))

    def turn(cwd, root, tag):
        print_tagged(call([sys.executable, me, "step", root, "--label", tag,
                           "--out", out], cwd,
                          os.path.join(out, f"step_{tag}.log")), "AB")

    return in_turns(parent, out, "gat_ab_", setup, turn)


def main(argv=None) -> int:
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = cli.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--parent", required=True,
                   help="root of the parent's checkout")
    r.add_argument("--out", default="chiprun_out/gat_ab")
    g = sub.add_parser("graph")
    g.add_argument("root")
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
