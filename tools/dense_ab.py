#!/usr/bin/env python3
"""Time the dense gather-sum kernels of two checkouts on one card, in turns.

    python3 tools/dense_ab.py run --parent DIR [--out DIR]
    python3 tools/dense_ab.py inputs ROOT
    python3 tools/dense_ab.py cases ROOT --label L

``inputs`` builds the products-scale graph of ``chip_smoke.py`` (saved
under ROOT for the CLI) and the main path's dense neighbour matrices:
split A's first batch (layer 0 synthesized on the card, layers 1-2), and
the first batch of split B at P = 1 and of split P4-B's partition 0
(layers 1-2); it writes them to ``ROOT/inputs.pt``. ``cases``, run from
the root of a checkout, holds that checkout's kernels at every matrix
through its own ``chip_smoke.dense_cases`` (random frames from a seed:
f32, and bf16 for split A's forward), and prints one JSON line of times
a case. ``run`` does ``inputs`` once, then in turns
(``tools/ab_turns.py``: parent, change, change, parent, the change being
the checkout this script lies in) ``cases`` and split A's CLI run
(``--num-epochs 2 --json --profile-dir``) in each checkout, and prints
both sides' numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from ab_turns import CHANGE, call, in_turns, print_tagged


def make_inputs(root: str, split_b: bool = True) -> None:
    """The graph and the matrices (``split_b``: split B's at P = 1 too)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
    from occ_gnn_tpu_torch.data import random_graph, save_graph
    from occ_gnn_tpu_torch.data.partition import partition_graph
    from occ_gnn_tpu_torch.sampling.slicer import (
        SplitSampler,
        measure_split_capacities,
        plan_split_capacities,
    )

    device = torch.device("cuda")
    num_nodes = 2_450_000
    args = cs.graph_args(num_nodes, cs.SPLIT_A_FLAGS)
    t0 = time.perf_counter()
    g = random_graph(num_nodes, cs.AVG_DEGREE, cs.FEATURE_DIM,
                     num_classes=cs.NUM_CLASSES, seed=args.seed)
    save_graph(g, root, "products")
    print(f"graph {num_nodes} nodes in {time.perf_counter() - t0:.1f}s",
          flush=True)
    fan = [int(f) for f in args.fan_out.split(",")]
    batch, syn, _ = cs.check_synthesized_layer(g, fan, args.batch_size,
                                               device)
    mats = {"split A layer 0": (syn.nbr_idx, syn.src_cap, cs.FEATURE_DIM)}
    for i, lyr in enumerate(batch.layers[1:], 1):
        lyr = lyr.partition(0)
        mats[f"split A layer {i}"] = (lyr.nbr_idx, lyr.src_cap,
                                      args.num_hidden)
    del g, batch, syn
    nodes_b = min(cs.SPLIT_B_NODES, num_nodes)
    args_b = cs.graph_args(nodes_b, cs.SPLIT_B_FLAGS)
    fan_b = [int(f) for f in args_b.fan_out.split(",")]
    g_b = random_graph(nodes_b, cs.AVG_DEGREE, cs.FEATURE_DIM,
                       num_classes=cs.NUM_CLASSES, seed=args_b.seed)
    nodes, bs = g_b.train_nodes(), args_b.batch_size
    # Split B's planned capacities, as chip_smoke.split_vs_single takes
    # them; P4-B's measured, as its run trains at them.
    for P, label in ((1, "split B"), (4, "split P4-B partition 0")):
        if P == 1 and not split_b:
            continue
        pmap = (np.zeros(g_b.num_nodes, np.int32) if P == 1
                else partition_graph(g_b, P, mode="metis"))
        safe = plan_split_capacities(bs, fan_b, g_b.num_nodes, P)
        caps, refresh = dict(safe), safe["frame_caps"][0]
        if P > 1:
            probe = CachePlan(g_b, pmap, P, 0.25, refresh_cap=refresh)
            caps = measure_split_capacities(g_b, nodes, pmap, P, fan_b, bs,
                                            seed=args_b.seed + 99,
                                            cache_plan=probe, margin=1.35)
            refresh = max(caps.pop("refresh_cap", 0), 8)
        plan = CachePlan(g_b, pmap, P, 0.25, refresh_cap=refresh)
        cache = SplitFeatureCache(plan, device=device, partitions=(0, 1))
        sampler = SplitSampler(g_b, nodes, pmap, P, fan_b, bs, seed=0,
                               cache=cache, capacities=caps,
                               emit_range=(0, 1), device=device)
        b = sampler.slice_raw(sampler._sample_raw(nodes[:bs]))
        for i, lyr in enumerate(b.layers):
            lyr = lyr.partition(0)
            if lyr.nbr_idx is not None:
                mats[f"{label} layer {i}"] = (lyr.nbr_idx, lyr.src_cap,
                                              args_b.num_hidden)
    out = {k: (n.cpu(), int(s), int(h)) for k, (n, s, h) in mats.items()}
    torch.save(out, os.path.join(root, "inputs.pt"))
    for k, (n, s, h) in out.items():
        K, D = n.shape
        print(f"{k}: K={K} D={D} S={s} H={h} "
              f"valid={int((n != s - 1).sum())}", flush=True)


def run_cases(root: str, label: str) -> None:
    """In the checkout at the working directory: its dense_cases at every
    matrix, one JSON line each."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    device = torch.device("cuda")
    cs.build_all()
    rate = cs.memory_rate(torch.cuda.get_device_name(0))
    mats = torch.load(os.path.join(root, "inputs.pt"))
    gen = torch.Generator(device).manual_seed(21)
    for name, (nbr, S, H) in mats.items():
        nbr = nbr.to(device)
        x = torch.randn(S, H, generator=gen, device=device)
        layer0 = name.endswith("layer 0")
        dtypes = (torch.float32,)
        if name.startswith("split A"):
            dtypes += (torch.bfloat16,)
        for dtype in dtypes:
            xd = x.to(dtype)
            back = not layer0 and dtype == torch.float32
            cases = cs.dense_cases(f"{label}: {name}", xd, nbr, rate, gen,
                                   backward=back)
            row = {"label": label, "case": name, "dtype": str(dtype)[6:],
                   "K": nbr.shape[0], "D": nbr.shape[1], "S": S, "H": H,
                   "valid": int((nbr != S - 1).sum())}
            for kernel, c in cases.items():
                row[kernel] = {k: c.get(k) for k in
                               ("ms", "plain_ms", "library_ms", "bytes_ms",
                                "floor_ms", "err")}
            print("AB " + json.dumps(row), flush=True)
        del x


def run_all(parent: str, out: str) -> int:
    me = str(Path(__file__).resolve())
    sys.path.insert(0, str(CHANGE))
    import chip_smoke as cs

    def setup(root):
        call([sys.executable, me, "inputs", root], str(CHANGE),
             os.path.join(out, "inputs.log"))

    def turn(cwd, root, tag):
        print_tagged(call([sys.executable, me, "cases", root, "--label", tag],
                          cwd, os.path.join(out, f"cases_{tag}.log")), "AB")
        # The later flags win over SPLIT_A_FLAGS'.
        text = call([sys.executable, "-m", "occ_gnn_tpu_torch.train",
                     "--graph", "products", "--data-root", root]
                    + cs.SPLIT_A_FLAGS + ["--num-epochs", "2", "--json",
                                          "--profile-dir",
                                          os.path.join(out, tag)], cwd,
                    os.path.join(out, f"train_{tag}.log"))
        metrics = json.loads(text.strip().splitlines()[-1])
        prof = metrics["profile"]
        print("TRAIN " + json.dumps({
            "label": tag, "train_step_s": metrics["phases"]["train_step"],
            "sample_s": metrics["phases"]["sample"],
            "kernels": prof["device_kernels"],
            "busy_ms": prof["device_busy_ms"],
            "window_ms": prof["window_ms"],
            "idle": prof["device_idle_share"],
            "dense_fwd_ms": prof["named_ms"].get(
                "local_aggregate_dense", {}).get("device_ms"),
            "dense_bwd_ms": prof["named_ms"].get(
                "_DenseAggregateBackward", {}).get("device_ms")}),
            flush=True)

    return in_turns(parent, out, "dense_ab_", setup, turn)


def main(argv=None) -> int:
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = cli.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--parent", required=True,
                   help="root of the parent's checkout")
    r.add_argument("--out", default="chiprun_out/ab")
    i = sub.add_parser("inputs")
    i.add_argument("root")
    c = sub.add_parser("cases")
    c.add_argument("root")
    c.add_argument("--label", required=True)
    a = cli.parse_args(argv)
    if a.cmd == "inputs":
        make_inputs(a.root)
        return 0
    if a.cmd == "cases":
        run_cases(a.root, a.label)
        return 0
    return run_all(os.path.abspath(a.parent), os.path.abspath(a.out))


if __name__ == "__main__":
    sys.exit(main())
