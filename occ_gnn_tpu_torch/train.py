"""Training CLI of the PyTorch port — the JAX package's ``train.py`` flags.

Usage:

    python -m occ_gnn_tpu_torch.train --graph community --mode single \
        --fan-out 10,10 --batch-size 1024 --num-epochs 3

Runs on the CUDA device; ``--cpu`` runs on the CPU instead. Without
``--cpu`` and without a visible GPU it stops with an error and never falls
back to the CPU.

Ported so far: ``--mode single`` with ``--model-name sage``. The other
modes, and the flags that only they read, stop with the ROADMAP.md item
that ports them.

Graphs: a name under --data-root (binary format, see ``data``) or the
built-in synthetics ``community`` / ``random``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# Where each mode that is not ported yet stands in ROADMAP.md, queue 1.
_NOT_PORTED = {
    "split": "items 1-7 (split-parallel path)",
    "pa-cache": "item 9 (single-chip cache)",
    "ddp": "item 10 (baselines)",
    "quiver": "item 10 (baselines)",
    "infer": "item 10 (inference)",
}
# Flags of the JAX CLI that no ported path reads yet, by the item that
# ports them. Set away from its default, each one stops the CLI.
_FLAGS_NOT_PORTED = {
    "cache_per": "items 6 and 9 (feature cache)",
    "num_heads": "items 8 and 9 (GAT)",
    "partitions": "item 7 (split-parallel training at P > 1)",
    "partition_mode": "item 7 (split-parallel training at P > 1)",
    "sampler": "items 4 and 10 (split-mode samplers)",
    "innermost": "item 5 (on-device innermost sampling)",
    "caps_margin": "item 6 (split CLI)",
    "num_workers": "item 4 (C++ sampler)",
    "dtype": "item 6 (split CLI)",
    "save_dir": "item 6 (save and resume)",
    "resume": "item 6 (save and resume)",
    "eval": "item 6 (split CLI)",
    "profile_dir": "item 6 (split CLI)",
    "infer_nodes": "item 10 (inference)",
    "output": "item 10 (inference)",
    "cpu_devices": "item 7 (split-parallel training at P > 1)",
    "distributed": "item 7 (multi-process training)",
    "coordinator_address": "item 7 (multi-process training)",
    "num_processes": "item 7 (multi-process training)",
    "process_id": "item 7 (multi-process training)",
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("occ_gnn_tpu_torch trainer")
    p.add_argument("--graph", type=str, required=True)
    p.add_argument("--data-root", type=str, default="./data")
    p.add_argument("--mode", type=str, default="split",
                   choices=["split", "single", "ddp", "pa-cache", "quiver",
                            "infer"])
    p.add_argument("--model-name", type=str, default="sage",
                   choices=["sage", "gcn", "gat"])
    p.add_argument("--cache-per", type=str, default="0",
                   help="feature-cache fraction of the graph, or 'auto'")
    p.add_argument("--fan-out", type=str, default="10,10,25")
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-hidden", type=int, default=256)
    p.add_argument("--num-epochs", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--partitions", type=int, default=0,
                   help="mesh size for split/ddp; 0 = all devices")
    p.add_argument("--partition-mode", type=str, default="greedy",
                   choices=["greedy", "metis", "random", "round_robin"])
    p.add_argument("--sampler", type=str, default="native",
                   choices=["native", "numpy"],
                   help="split-mode sampler backend (native = pipelined C++)")
    p.add_argument("--innermost", type=str, default="auto",
                   choices=["auto", "host", "device"],
                   help="where the innermost fanout expansion runs "
                        "(split mode)")
    p.add_argument("--measure-caps", action="store_true",
                   help="measure padding capacities from a few batches "
                        "instead of worst-case planning")
    p.add_argument("--caps-margin", type=float, default=0.0,
                   help="headroom factor over measured capacity maxima "
                        "(split mode; 0 = auto)")
    p.add_argument("--num-workers", type=int, default=2,
                   help="C++ sampler worker threads")
    p.add_argument("--sample-without-replacement", action="store_true",
                   help="DGL sample_neighbors semantics instead of the "
                        "reference slicer's with-replacement draws")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="activation/cache storage precision (split mode)")
    p.add_argument("--save-dir", type=str, default="",
                   help="checkpoint directory (split mode)")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint file to resume from (split mode)")
    p.add_argument("--infer-nodes", type=str, default="test",
                   choices=["train", "val", "test", "all"],
                   help="node set for --mode infer")
    p.add_argument("--output", type=str, default="",
                   help="write predictions (npy) for --mode infer")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit-train", type=int, default=0,
                   help="cap the train-node set (per-epoch phase tables at "
                        "scale without paying full epochs; 0 = all)")
    p.add_argument("--num-nodes", type=int, default=10000,
                   help="synthetic graph size")
    p.add_argument("--avg-degree", type=int, default=10)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--eval", action="store_true",
                   help="evaluate on val/test masks after training "
                        "(split mode)")
    p.add_argument("--mmap-features", action="store_true",
                   help="memory-map features.bin")
    p.add_argument("--feature-pad", type=int, default=0,
                   help="zero-pad feature_dim to a multiple of this "
                        "(inert for the math)")
    p.add_argument("--profile-dir", type=str, default="",
                   help="capture a profiler trace of a few steps "
                        "(split mode)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("--cpu-devices", type=int, default=8,
                   help="virtual device count per process with --cpu "
                        "(split mode)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line of final metrics")
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process cluster (split mode)")
    p.add_argument("--coordinator-address", type=str, default="",
                   help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=-1)
    p.add_argument("--process-id", type=int, default=-1)
    return p


def resolve_device(args) -> torch.device:
    """CUDA unless ``--cpu``; no silent fallback when there is no GPU."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device is visible to torch; pass "
                         "--cpu to run on the CPU")
    return torch.device("cuda")


def resolve_graph(args):
    from occ_gnn_tpu_torch.data import block_graph, load_graph, random_graph

    if args.graph == "community":
        return block_graph(num_nodes=args.num_nodes, num_blocks=8,
                           avg_degree=args.avg_degree,
                           feature_dim=args.feature_dim, seed=args.seed)
    if args.graph == "random":
        return random_graph(num_nodes=args.num_nodes,
                            avg_degree=args.avg_degree,
                            feature_dim=args.feature_dim, seed=args.seed)
    return load_graph(args.data_root, args.graph,
                      mmap_features=args.mmap_features)


def main(argv=None):
    from occ_gnn_tpu_torch.utils import PhaseTimers

    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.mode in _NOT_PORTED:
        raise SystemExit(f"--mode {args.mode} is not ported yet: ROADMAP.md "
                         f"queue 1, {_NOT_PORTED[args.mode]}")
    for dest, item in _FLAGS_NOT_PORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag} is not ported yet: ROADMAP.md queue 1, "
                             f"{item}")
    device = resolve_device(args)
    fanouts = [int(f) for f in args.fan_out.split(",")]
    g = resolve_graph(args)
    if args.feature_pad > 1:
        g = g.pad_feature_dim(args.feature_pad)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"feat {g.feature_dim}, {g.num_classes} classes; device {device}")
    metrics = train_single(args, g, fanouts, PhaseTimers(), device)
    if args.json:
        print(json.dumps(metrics))
    return metrics


def _make_model(args, g, device: torch.device):
    from occ_gnn_tpu_torch.models import get_model

    generator = torch.Generator().manual_seed(args.seed)
    model = get_model(args.model_name, g.feature_dim, args.num_hidden,
                      g.num_classes, len(args.fan_out.split(",")),
                      dropout=args.dropout, generator=generator)
    return model.to(device)


def _train_nodes(args, g) -> np.ndarray:
    nodes = g.train_nodes()
    if args.limit_train and args.limit_train < nodes.shape[0]:
        nodes = nodes[: args.limit_train]
    return nodes


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_single(args, g, fanouts, timers, device: torch.device | None = None):
    """One-chip sampled-minibatch training (``--mode single``) on
    ``device`` (by default the one ``--cpu`` selects)."""
    from occ_gnn_tpu_torch.sampling.neighbor import (
        NeighborSampler,
        measure_capacities,
    )
    from occ_gnn_tpu_torch.training import gather_features, make_train_step

    device = device or resolve_device(args)
    model = _make_model(args, g, device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    step = make_train_step(model, opt)
    nodes = _train_nodes(args, g)
    caps = None
    if args.measure_caps:
        with timers.phase("capacity_plan"):
            caps = measure_capacities(
                g, nodes, fanouts, args.batch_size, seed=args.seed + 99,
                replace=not args.sample_without_replacement,
            )
    sampler = NeighborSampler(g, nodes, fanouts, args.batch_size,
                              capacities=caps, seed=args.seed,
                              replace=not args.sample_without_replacement,
                              device=device)
    drop_gen = torch.Generator(device).manual_seed(args.seed)
    acc = loss_v = 0.0
    steps = 0
    last_phases = {}
    for epoch in range(args.num_epochs):
        t0 = time.perf_counter()
        correct = total = 0
        for seeds in sampler.seed_batches():
            with timers.phase("sample"):
                batch = sampler.sample_batch(seeds)
            with timers.phase("feature_load"):
                x0 = gather_features(g.features, batch.input_nodes, device)
            with timers.phase("train_step"):
                loss, c, t = step(batch, x0, drop_gen)
                _synchronize(device)
            steps += 1
            correct += int(c)
            total += int(t)
        acc = correct / max(total, 1)
        loss_v = float(loss)
        dt = time.perf_counter() - t0
        print(f"epoch {epoch}: loss={loss_v:.4f} acc={acc:.4f} "
              f"time={dt:.2f}s [{timers.summary()}]")
        last_phases = {k: round(v, 4) for k, v in timers.as_dict().items()}
        timers.clear()
    return {"mode": "single", "acc": acc, "loss": loss_v, "steps": steps,
            "phases": last_phases}


if __name__ == "__main__":
    main()
