"""Training CLI of the PyTorch port — the JAX package's ``train.py`` flags.

Usage:

    python -m occ_gnn_tpu_torch.train --graph community --mode split \
        --cache-per auto --fan-out 10,10 --batch-size 1024 --num-epochs 3

Runs on the CUDA device; ``--cpu`` runs on the CPU instead. Without
``--cpu`` and without a visible GPU it stops with an error and never falls
back to the CPU.

Modes, each the JAX trainer's:
  split     split-parallel training (``SplitSAGE``, ``SplitGCN``,
            ``SplitGAT`` or ``SplitUniMP``, ``--model-name unimp``, which
            no other mode takes; the C++ or numpy sampler, the feature cache,
            on-device innermost sampling, ``--save-dir`` / ``--resume``)
  single    one-chip sampled-minibatch training, every ``--model-name``
  pa-cache  single with a PaGraph-style static cache (``--cache-per``)
  ddp       the data-parallel baseline
  quiver    the quiver baseline: sampling and features on the device
  infer     predictions of a ``--resume`` checkpoint's split model

A flag that the chosen mode does not read stops the CLI.

split and infer run P partitions over W processes, P / W each, and ddp
and quiver P shards the same way (``parallel.dist``): ``--partitions P``
starts the processes itself, one per card the partitions land on, or
``ceil(P / --cpu-devices)`` under ``--cpu`` (``--partitions 0`` is
``--cpu-devices`` partitions under ``--cpu``, as the JAX CLI's virtual
devices, and one on the card). ``--distributed`` joins a process group
started elsewhere (the JAX flags ``--coordinator-address``,
``--num-processes``, ``--process-id``, or torchrun's environment):

    python -m occ_gnn_tpu_torch.train --graph community --partitions 4 --cpu

Graphs: a name under --data-root (binary format, see ``data``) or the
built-in synthetics ``community`` / ``random``.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import time

import numpy as np
import torch

# The flags of the JAX CLI that only some modes read, each with the modes
# of the JAX trainer that read it. Set away from its default under any
# other mode (the JAX CLI would accept it there and ignore it), a flag
# stops the CLI. --cpu-devices is read under --cpu only.
_RANKS = ("split", "ddp", "quiver", "infer")
_TRAINING = ("split", "single", "pa-cache", "ddp", "quiver")
_MODES_READING = {
    "num_epochs": _TRAINING,
    "limit_train": _TRAINING,
    "dropout": _TRAINING,
    "measure_caps": ("split", "single", "pa-cache", "ddp"),
    "sample_without_replacement": ("split", "single", "pa-cache", "ddp",
                                   "infer"),
    "cache_per": ("split", "pa-cache"),
    "partitions": _RANKS,
    "partition_mode": ("split", "infer"),
    "sampler": ("split", "infer"),
    "innermost": ("split",),
    "caps_margin": ("split",),
    "num_workers": ("split", "infer"),
    "dtype": ("split", "pa-cache", "quiver", "infer"),
    "save_dir": ("split",),
    "resume": ("split", "infer"),
    "eval": ("split",),
    "profile_dir": ("split",),
    "infer_nodes": ("infer",),
    "output": ("infer",),
    "cpu_devices": _RANKS,
    "distributed": _RANKS,
    "coordinator_address": _RANKS,
    "num_processes": _RANKS,
    "process_id": _RANKS,
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("occ_gnn_tpu_torch trainer")
    p.add_argument("--graph", type=str, required=True)
    p.add_argument("--data-root", type=str, default="./data")
    p.add_argument("--mode", type=str, default="split",
                   choices=["split", "single", "ddp", "pa-cache", "quiver",
                            "infer"])
    p.add_argument("--model-name", type=str, default="sage",
                   choices=["sage", "gcn", "gat", "unimp"])
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
                   help="partitions (split, infer) or shards (ddp, quiver); "
                        "0 = the processes times --cpu-devices under --cpu, "
                        "else the processes (1 without --distributed)")
    p.add_argument("--partition-mode", type=str, default="greedy",
                   choices=["greedy", "metis", "random", "round_robin"])
    p.add_argument("--sampler", type=str, default="native",
                   choices=["native", "numpy"],
                   help="split and infer sampler backend (native = "
                        "pipelined C++)")
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
                   help="activation/cache storage precision")
    p.add_argument("--save-dir", type=str, default="",
                   help="checkpoint directory (split mode)")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint file to resume from (split mode) or "
                        "to predict with (infer mode)")
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
                   help="capture a profiler trace of one steady step "
                        "(split mode)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("--cpu-devices", type=int, default=8,
                   help="partitions or shards per process with --cpu: "
                        "the JAX CLI's virtual devices")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line of final metrics")
    p.add_argument("--distributed", action="store_true",
                   help="join a process group, one process per rank")
    p.add_argument("--coordinator-address", type=str, default="",
                   help="host:port of process 0, or a tcp:// or file:// "
                        "URL (empty = torchrun's environment)")
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


def _check_flags(parser, args) -> None:
    """Stop on a flag that ``--mode`` does not read."""
    for dest, modes in _MODES_READING.items():
        if args.mode in modes or getattr(args, dest) == parser.get_default(
                dest):
            continue
        flag = "--" + dest.replace("_", "-")
        raise SystemExit(
            f"{flag} is not ported for --mode {args.mode}: the JAX trainer's "
            f"{args.mode} mode does not read it, only --mode "
            f"{' / '.join(modes)} (ROADMAP.md queue 3: the port stops on a "
            "flag the JAX trainer would ignore)")
    if args.model_name == "unimp" and args.mode != "split":
        raise SystemExit(
            f"--model-name unimp trains in --mode split only, not --mode "
            f"{args.mode}: UniMP's graph transformer is the split path's "
            "(SplitUniMP)")
    if not args.cpu and args.cpu_devices != parser.get_default("cpu_devices"):
        raise SystemExit(
            "--cpu-devices is not ported without --cpu: it gives the "
            "partitions or shards of a process on the CPU, as the JAX "
            "CLI's virtual devices; on the card each process holds those "
            "of its card (ROADMAP.md queue 3: the port stops on a flag the "
            "JAX trainer would ignore)")


def _placement(args, world: int | None = None) -> tuple[int, int]:
    """``(P, W)`` of the flags (``parallel.dist.placement``)."""
    from occ_gnn_tpu_torch.parallel import dist

    return dist.placement(args.partitions, cpu=args.cpu,
                          cpu_devices=args.cpu_devices, world=world)


def main(argv=None):
    import sys

    from occ_gnn_tpu_torch.parallel import dist
    from occ_gnn_tpu_torch.utils import PhaseTimers

    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_argparser()
    args = parser.parse_args(argv)
    _check_flags(parser, args)
    ranks = None
    if args.distributed:
        ranks = dist.init_from_args(args)
        device = ranks.device
    else:
        # resolve_device stops a run that has no GPU and no --cpu before
        # anything starts.
        device = resolve_device(args)
        if args.mode in _RANKS:
            P, W = _placement(args)
            if W > 1:
                metrics = dist.launch(argv + ["--partitions", str(P)], W)
                if args.json:
                    print(json.dumps(metrics))
                return metrics
    try:
        fanouts = [int(f) for f in args.fan_out.split(",")]
        g = resolve_graph(args)
        if args.feature_pad > 1:
            g = g.pad_feature_dim(args.feature_pad)
        print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
              f"feat {g.feature_dim}, {g.num_classes} classes; device "
              f"{device}")
        timers = PhaseTimers()
        if args.mode in ("single", "pa-cache"):
            metrics = train_single(args, g, fanouts, timers, device,
                                   use_cache=args.mode == "pa-cache")
        else:
            run = {"split": train_split, "ddp": train_ddp,
                   "quiver": train_quiver, "infer": run_infer}[args.mode]
            metrics = run(args, g, fanouts, timers, device, ranks=ranks)
    finally:
        dist.close(ranks)
    if args.json:
        print(json.dumps(metrics))
    return metrics


def _make_model(args, g, device: torch.device):
    from occ_gnn_tpu_torch.models import get_model

    kw = dict(dropout=args.dropout)
    if args.model_name == "gat":
        kw["num_heads"] = args.num_heads
    model = get_model(args.model_name, g.feature_dim, args.num_hidden,
                      g.num_classes, len(args.fan_out.split(",")),
                      generator=torch.Generator().manual_seed(args.seed),
                      **kw)
    return model.to(device)


def _train_nodes(args, g) -> np.ndarray:
    nodes = g.train_nodes()
    if args.limit_train and args.limit_train < nodes.shape[0]:
        nodes = nodes[: args.limit_train]
    return nodes


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_single(args, g, fanouts, timers, device: torch.device | None = None,
                 use_cache: bool = False):
    """One-chip sampled-minibatch training (``--mode single``) on
    ``device`` (by default the one ``--cpu`` selects); ``use_cache`` is
    ``--mode pa-cache``: the input frames come through a ``SingleChipCache``
    of ``--cache-per`` of the graph (0 means the reference's 0.25; ``auto``
    sizes it to the device's free memory, its rows costed at ``--dtype``,
    though the frame stays f32, as in JAX)."""
    from occ_gnn_tpu_torch.sampling.neighbor import (
        NeighborSampler,
        measure_capacities,
    )
    from occ_gnn_tpu_torch.parallel.dp import make_dp_train_step
    from occ_gnn_tpu_torch.training import gather_features

    device = device or resolve_device(args)
    model = _make_model(args, g, device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    step = make_dp_train_step(model, opt)
    nodes = _train_nodes(args, g)
    caps = None
    if args.measure_caps:
        with timers.phase("capacity_plan"):
            caps = measure_capacities(
                g, nodes, fanouts, args.batch_size, seed=args.seed + 99,
                replace=not args.sample_without_replacement,
            )
    # As the JAX trainer: --sample-without-replacement applies to the
    # capacity measurement only; the sampler draws with replacement.
    sampler = NeighborSampler(g, nodes, fanouts, args.batch_size,
                              capacities=caps, seed=args.seed,
                              device=device)
    cache = None
    if use_cache:
        from occ_gnn_tpu_torch.cache import SingleChipCache
        from occ_gnn_tpu_torch.cache.autosize import resolve_cache_percentage

        pct = resolve_cache_percentage(
            args.cache_per, g, np.zeros(g.num_nodes, np.int32), 1,
            dtype_bytes=2 if args.dtype == "bfloat16" else 4,
            refresh_cap=0, device=device,
        )
        if pct <= 0:
            pct = 0.25  # the reference pa_cache default
        cache = SingleChipCache(g, min(pct, 1.0), device=device)
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
                if cache is not None:
                    x0 = cache.load_input_frame(batch.input_nodes)
                else:
                    x0 = gather_features(g.features, batch.input_nodes,
                                         device)
                _synchronize(device)
            with timers.phase("train_step"):
                loss, c, t = step(batch, x0, drop_gen)
                _synchronize(device)
            steps += 1
            correct += int(c)
            total += int(t)
        acc = correct / max(total, 1)
        loss_v = float(loss)
        dt = time.perf_counter() - t0
        hit = f" hit_rate={cache.hit_rate:.3f}" if cache is not None else ""
        print(f"epoch {epoch}: loss={loss_v:.4f} acc={acc:.4f} "
              f"time={dt:.2f}s{hit} [{timers.summary()}]")
        last_phases = {k: round(v, 4) for k, v in timers.as_dict().items()}
        timers.clear()
    out = {"mode": "pa-cache" if use_cache else "single", "acc": acc,
           "loss": loss_v, "steps": steps, "phases": last_phases}
    if cache is not None:
        out.update(hit_rate=cache.hit_rate, cache_pct=min(pct, 1.0),
                   bytes_sent=cache.bytes_sent)
    return out


def _one_partition_map(g) -> np.ndarray:
    """The partition map at P = 1: every node on partition 0, which is what
    ``partition_graph(g, 1, mode)`` gives in every mode, without its
    per-node loop over the graph."""
    if g.partition_map is not None and int(g.partition_map.max()) == 0:
        return g.partition_map
    return np.zeros(g.num_nodes, dtype=np.int32)


def _partition_map(args, g, P: int) -> np.ndarray:
    """The node -> partition map: at P > 1 the graph's own map when it has
    P partitions, else ``--partition-mode`` (attached to the graph, as
    the JAX trainer does)."""
    from occ_gnn_tpu_torch.data.partition import partition_graph

    if P == 1:
        return _one_partition_map(g)
    if g.partition_map is not None and int(g.partition_map.max()) == P - 1:
        return g.partition_map
    return partition_graph(g, P, mode=args.partition_mode)


def _make_split_model(args, g):
    from occ_gnn_tpu_torch.parallel.model import (
        SplitGAT,
        SplitGCN,
        SplitSAGE,
        SplitUniMP,
    )

    # As the JAX trainer, the split model is built without --dropout,
    # which therefore has no effect in split mode, and SplitGAT without
    # --dtype: its activations stay f32 (a bf16 cache frame still feeds
    # layer 0). SplitUniMP is built so too.
    generator = torch.Generator().manual_seed(args.seed)
    dims = (g.feature_dim, args.num_hidden, g.num_classes,
            len(args.fan_out.split(",")))
    if args.model_name in ("gat", "unimp"):
        cls = SplitGAT if args.model_name == "gat" else SplitUniMP
        return cls(*dims, num_heads=args.num_heads, generator=generator)
    cls = {"sage": SplitSAGE, "gcn": SplitGCN}[args.model_name]
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return cls(*dims, dtype=dtype, generator=generator)


def _gather_xs(g, batch, device: torch.device) -> torch.Tensor:
    """The input frames ``[L, F0_cap, H]`` of the batch's partitions,
    gathered on the host."""
    from occ_gnn_tpu_torch.training import gather_features

    ids = batch.input_nodes_host
    if ids is None:
        ids = batch.input_nodes.cpu().numpy()
    return torch.stack([gather_features(g.features, row, device)
                        for row in ids])


def _profile_window(steps: int, out_dir: str, summary: dict):
    """A profiler recording one steady step: the fifth, or the last of a
    shorter epoch. ``prof.step()`` is called as each step launches and
    once after the epoch, so the recorded window runs from that launch to
    the next, by which time the pipeline has waited for the step to
    finish. When the window closes, its Chrome trace goes to
    ``out_dir/trace.json`` and its summary into ``summary``, with the
    query-key attention kernels' launches so far
    (``ops.gat_attention.qk_attention_counts``, by path and direction)
    and UniMP's tail kernels' (``ops.unimp_tail.unimp_tail_counts``, by
    direction and form)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from occ_gnn_tpu_torch.ops.gat_attention import qk_attention_counts
    from occ_gnn_tpu_torch.ops.unimp_tail import unimp_tail_counts
    from occ_gnn_tpu_torch.utils.profile import summarize_step

    def on_ready(prof):
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        summary.update(summarize_step(prof))
        summary["qk_attention_launches"] = qk_attention_counts()
        summary["unimp_tail_launches"] = unimp_tail_counts()
        print(f"profiler trace -> {out_dir}; qk_attention launches "
              f"{summary['qk_attention_launches']}; unimp_tail launches "
              f"{summary['unimp_tail_launches']}")

    target = min(4, max(steps - 1, 0))
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   schedule=schedule(wait=target, warmup=1, active=1,
                                     repeat=1),
                   on_trace_ready=on_ready)


def _place(args, ranks, device):
    """This process's place in the run: ``ranks`` when it joined a group,
    else the one process holding every partition or shard. Under
    ``--distributed`` ``--partitions`` must be what the group holds."""
    from occ_gnn_tpu_torch.parallel import dist

    if ranks is None:
        P, _ = _placement(args, world=1)
        return dist.single_process(P, device)
    if args.partitions not in (0, ranks.num_partitions):
        raise SystemExit(f"--partitions {args.partitions} must be "
                         f"{ranks.num_partitions}, what the "
                         f"{ranks.world_size} processes hold")
    return ranks


def train_split(args, g, fanouts, timers, device: torch.device | None = None,
                init_state: dict | None = None, ranks=None):
    """Split-parallel training (``--mode split``) on ``device``, step for
    step as the JAX trainer's ``train_split``. ``init_state`` is an
    optional model state to start from (for instance
    ``utils.checkpoint.params_from_jax`` of JAX weights).

    ``ranks`` (``parallel.dist.DistContext``) makes this process one of a
    group that holds partitions ``[lo, hi)``: it partitions and plans as
    every other process does, holds those partitions' cache frames,
    samples their rows, and reports the global loss, accuracy and
    evaluation counts. Without it the process holds all P partitions
    (``--partitions``, or ``--cpu-devices`` under ``--cpu``)."""
    from torch.distributed import ReduceOp

    from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
    from occ_gnn_tpu_torch.cache.autosize import resolve_cache_percentage
    from occ_gnn_tpu_torch.parallel import dist
    from occ_gnn_tpu_torch.parallel.model import (
        make_device_csr,
        make_split_forward,
        make_split_train_step,
    )
    from occ_gnn_tpu_torch.parallel.split import (
        collective_count,
        shuffle_counts,
    )
    from occ_gnn_tpu_torch.sampling.slicer import (
        SplitSampler,
        measure_split_capacities,
        plan_split_capacities,
        scale_capacities,
    )
    from occ_gnn_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    device = device or resolve_device(args)
    ranks = _place(args, ranks, device)
    P, rank = ranks.num_partitions, ranks.rank
    emit = dist.local_partition_range(ranks)
    with timers.phase("partition"):
        pmap = _partition_map(args, g, P)
    with timers.phase("capacity_plan"):
        safe_caps = plan_split_capacities(args.batch_size, fanouts,
                                          g.num_nodes, P)
        cache_pct = resolve_cache_percentage(
            args.cache_per, g, pmap, P,
            dtype_bytes=2 if args.dtype == "bfloat16" else 4,
            refresh_cap=safe_caps["frame_caps"][0], device=device,
        )
        if ranks.grouped and args.cache_per == "auto":
            # Ranks that share a card see different free memory.
            cache_pct = float(dist.all_reduce_values(
                ranks, [cache_pct], op=ReduceOp.MIN)[0])
        if args.cache_per == "auto":
            print(f"cache auto-sized to {cache_pct:.4f} of the graph "
                  f"({'no per-batch refresh' if cache_pct >= 1.0 / P else 'refreshing'})")
        # Innermost placement must be known before capacity measurement:
        # the padding margin depends on it.
        will_device = (
            args.innermost != "host"
            and args.sampler == "native"
            and cache_pct >= 1.0
            and not args.sample_without_replacement
            and fanouts[-1] > 0
            and g.num_edges < 2**31
        )
        margin = args.caps_margin or (1.2 if will_device else 1.35)
        if args.measure_caps:
            # Measure with the cache policy active: it changes where the
            # innermost layer's edges execute, hence the maxima.
            probe_plan = None
            if cache_pct > 0:
                probe_plan = CachePlan(g, pmap, P, cache_pct,
                                       refresh_cap=safe_caps["frame_caps"][0])
            caps = measure_split_capacities(
                g, g.train_nodes(), pmap, P, fanouts, args.batch_size,
                seed=args.seed + 99, cache_plan=probe_plan, margin=margin,
            )
        else:
            caps = dict(safe_caps)
    cache = None
    if cache_pct > 0:
        refresh_cap = (max(caps.pop("refresh_cap", 0), 8)
                       if args.measure_caps else safe_caps["frame_caps"][0])
        plan = CachePlan(g, pmap, P, cache_pct, refresh_cap=refresh_cap)
        fdtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
        cache = SplitFeatureCache(plan, dtype=fdtype, device=device,
                                  partitions=emit)
    else:
        caps.pop("refresh_cap", None)

    # Device-innermost eligibility: native sampler, fully replicated
    # cache, with-replacement draws, bounded innermost fanout.
    eligible_device = (
        args.sampler == "native"
        and cache is not None
        and cache.plan.replicated
        and not args.sample_without_replacement
        and fanouts[-1] > 0
        and g.num_edges < 2**31
    )
    innermost = args.innermost
    if innermost == "auto":
        innermost = "device" if eligible_device else "host"
    elif innermost == "device" and not eligible_device:
        raise SystemExit(
            "--innermost device needs --sampler native, a fully "
            "replicated cache (--cache-per auto/1.0), with-replacement "
            "sampling, a bounded innermost fanout, and < 2^31 edges"
        )
    csr = None
    if innermost == "device":
        csr = make_device_csr(g, device)
        print("innermost layer: device-sampled from resident CSR")

    model = _make_split_model(args, g)

    # The model says whether its backward reads each dense layer's plan,
    # which the sampler builds on the host beside the matrix; the
    # evaluation takes no gradient, so its sampler builds none.
    def build_sampler(caps, nodes=None, seed=None,
                      plans=model.needs_scatter_plans):
        nodes = _train_nodes(args, g) if nodes is None else nodes
        seed = args.seed if seed is None else seed
        if args.sampler == "native":
            from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler

            return NativeSplitSampler(
                g, nodes, pmap, P, fanouts, args.batch_size,
                capacities=caps, seed=seed, cache=cache,
                num_workers=args.num_workers,
                replace=not args.sample_without_replacement,
                innermost=innermost, emit_range=emit, scatter_plans=plans,
                device=device,
            )
        return SplitSampler(g, nodes, pmap, P, fanouts, args.batch_size,
                            capacities=caps, seed=seed, cache=cache,
                            replace=not args.sample_without_replacement,
                            emit_range=emit, scatter_plans=plans,
                            device=device)

    sampler = build_sampler(caps)
    if init_state is not None:
        model.load_state_dict(init_state)
    model = model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    start_epoch = 0
    if args.resume:
        start_epoch = load_checkpoint(args.resume, model, opt)
        print(f"resumed from {args.resume} at epoch {start_epoch}")
    if ranks.grouped:
        dist.check_agreement(ranks, partition_map=pmap, capacities=caps,
                             cache_percentage=cache_pct, weights=model)
    step = make_split_train_step(model, opt, csr=csr, ranks=ranks)
    # Device-innermost sampling streams, one a partition.
    sample_gen = _partition_generators(csr, ranks, args.seed ^ 0xD0C5)
    profile = {}
    prof = None
    if args.profile_dir:
        out_dir = (os.path.join(args.profile_dir, f"rank{rank}")
                   if ranks.grouped else args.profile_dir)
        prof = _profile_window(len(sampler), out_dir, profile)
        prof.start()

    acc = loss_v = 0.0
    steps = 0
    last_phases = {}
    epoch = start_epoch
    replans = 0
    shuffles_before = shuffle_counts()
    collectives_before = collective_count()
    while epoch < args.num_epochs:
        t0 = time.perf_counter()
        correct = total = 0
        try:
            # Lag-1 pipeline: the host samples and stages batch n+1 while
            # the device runs step n; the reads of step n's counts wait
            # until batch n+1 is staged.
            pending = None  # (loss, correct, total) of the step in flight
            batches = iter(sampler)
            for _ in range(len(sampler)):
                with timers.phase("sample"):
                    batch = next(batches)
                if cache is not None:
                    xs = cache.frames
                else:
                    with timers.phase("feature_gather"):
                        xs = _gather_xs(g, batch, device)
                if pending is not None:
                    loss, c, t = pending
                    correct += int(c)
                    total += int(t)
                if prof is not None:
                    prof.step()
                with timers.phase("train_step"):
                    loss, c, t = step(batch, xs, sample_generator=sample_gen)
                steps += 1
                pending = (loss, c, t)
            if pending is not None:
                loss, c, t = pending
                correct += int(c)
                total += int(t)
        except ValueError as e:
            if "overflow" not in str(e):
                raise
            replans += 1
            if replans > 8:
                # Growing budgets is not converging: the overflow is not a
                # padding-budget problem.
                raise
            # A tail batch exceeded the measured padding budget: grow every
            # capacity 1.5x, rebuild the sampler, redo the epoch. Every
            # rank checks every partition, so all re-plan together.
            caps = scale_capacities(caps, 1.5)
            print(f"capacity overflow ({e}); re-planning with 1.5x budgets")
            if hasattr(sampler, "close"):
                sampler.close()
            sampler = build_sampler(caps)
            continue
        acc = correct / max(total, 1)
        loss_v = float(loss)
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.step()
            prof.stop()
            prof = None
        print(f"epoch {epoch}: loss={loss_v:.4f} acc={acc:.4f} "
              f"time={dt:.2f}s [{timers.summary()}]")
        last_phases = {k: round(v, 4) for k, v in timers.as_dict().items()}
        timers.clear()
        if args.save_dir and rank == 0:
            path = save_checkpoint(
                os.path.join(args.save_dir, "split_epoch.npz"), model, opt,
                epoch + 1)
            print(f"checkpoint -> {path}")
        epoch += 1

    shuffles = {k: v - shuffles_before[k]
                for k, v in shuffle_counts().items()}
    out = {"mode": "split", "acc": acc, "loss": loss_v, "partitions": P,
           "phases": last_phases,
           "peak_rss_mb": round(
               resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
           "steps": steps, "replans": replans, "cache_pct": cache_pct,
           "innermost": innermost, "sampler": args.sampler,
           "tail_batches": cache.tail_batches if cache is not None else 0}
    out.update(rank=rank, backend=ranks.backend, shuffle=shuffles,
               collectives=collective_count() - collectives_before,
               partitions_local=[ranks.lo, ranks.hi], capacities=caps)
    if profile:
        out["profile"] = profile
    if args.sampler == "native":
        st = sampler.stats()
        out["phases"]["cxx_sample"] = round(st["sample_s_per_batch"], 4)
        out["phases"]["cxx_slice"] = round(st["slice_s_per_batch"], 4)
    if hasattr(sampler, "close"):
        sampler.close()
    if args.eval and g.val_mask is not None:
        fwd = make_split_forward(model, csr=csr, ranks=ranks)
        ev_gen = _partition_generators(csr, ranks, args.seed + 13)
        for split_name, mask in (("val", g.val_mask), ("test", g.test_mask)):
            nodes = np.nonzero(mask)[0]
            # Same sampler backend and seeds as the JAX trainer's eval.
            ev = build_sampler(caps, nodes=nodes, seed=args.seed + 7,
                               plans=False)
            correct = total = 0
            for batch in ev:
                xs = cache.frames if cache is not None else _gather_xs(
                    g, batch, device)
                logits = fwd(batch, xs, sample_generator=ev_gen)
                labels = batch.labels
                valid = labels >= 0
                correct += int(((logits.argmax(-1) == labels) & valid).sum())
                total += int(valid.sum())
            if hasattr(ev, "close"):
                ev.close()
            if ranks.grouped:
                correct, total = dist.all_reduce_values(ranks,
                                                        [correct, total])
            out[f"{split_name}_acc"] = float(correct / max(total, 1))
            out[f"{split_name}_count"] = int(total)
            print(f"{split_name} accuracy: {out[f'{split_name}_acc']:.4f}")
    return out


def _partition_generators(csr, ranks, seed: int):
    """Device-draw generators of the local partitions, partition p's
    seeded ``rank_seed(seed, p)`` whichever process holds it; None
    without a device CSR."""
    from occ_gnn_tpu_torch.parallel.dist import rank_seed

    if csr is None:
        return None
    return [torch.Generator(ranks.device).manual_seed(rank_seed(seed, p))
            for p in range(ranks.lo, ranks.hi)]


def _rank_metrics(ranks, model) -> dict:
    """What a ddp or quiver process adds to its metrics: its shards
    ``[lo, hi)``, a checksum of its final weights (equal in every process
    of a healthy run) and, in a run with a process group, its rank and
    the backend."""
    from occ_gnn_tpu_torch.parallel.dist import checksum

    out = {"partitions_local": [ranks.lo, ranks.hi],
           "weights_crc32": checksum(model)}
    if ranks.grouped:
        out.update(rank=ranks.rank, backend=ranks.backend)
    return out


def train_ddp(args, g, fanouts, timers, device: torch.device | None = None,
              ranks=None):
    """The data-parallel baseline (``--mode ddp``), the JAX trainer's
    ``train_ddp``: the train nodes are split into P shards by one seeded
    permutation (the same in every process), shard p is sampled with
    seed ``seed + p`` at ``batch_size // P`` a step, dropping the ragged
    last batch, and every process takes the step count of the shortest
    of all P shards, so each enters every all-reduce. ``ranks``
    (``parallel.dist.DistContext``) makes this process one of a group
    holding shards ``[lo, hi)``; without it the process holds all P
    (``--partitions``, or ``--cpu-devices`` under ``--cpu``). A step
    samples and gathers the local shards one after the other, then runs
    one update over them. The samplers draw with replacement;
    ``--sample-without-replacement`` reaches only the capacity
    measurement, as in JAX."""
    from occ_gnn_tpu_torch.parallel import dist
    from occ_gnn_tpu_torch.parallel.dp import make_dp_train_step
    from occ_gnn_tpu_torch.parallel.model import update_collective_count
    from occ_gnn_tpu_torch.sampling.neighbor import (
        NeighborSampler,
        measure_capacities,
        plan_capacities,
    )
    from occ_gnn_tpu_torch.training import gather_features

    device = device or resolve_device(args)
    ranks = _place(args, ranks, device)
    P = ranks.num_partitions
    model = _make_model(args, g, device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    step = make_dp_train_step(model, opt, ranks)
    nodes = _train_nodes(args, g)
    per_dev = args.batch_size // P
    if args.measure_caps:
        caps = measure_capacities(
            g, nodes, fanouts, per_dev, seed=args.seed + 99,
            replace=not args.sample_without_replacement,
        )
    else:
        caps = plan_capacities(per_dev, fanouts, g.num_nodes)
    shards = np.array_split(
        np.random.default_rng(args.seed).permutation(nodes), P)
    steps_per_epoch = min(s.shape[0] // per_dev for s in shards)
    local = range(ranks.lo, ranks.hi)
    samplers = [NeighborSampler(g, shards[p], fanouts, per_dev,
                                capacities=caps, seed=args.seed + p,
                                drop_last=True, device=device)
                for p in local]
    if ranks.grouped:
        dist.check_agreement(ranks, capacities=caps, weights=model,
                             steps=steps_per_epoch)
    drop_gens = [torch.Generator(device).manual_seed(
        dist.rank_seed(args.seed ^ 0x5EED, p)) for p in local]
    acc = loss_v = 0.0
    steps = 0
    last_phases = {}
    collectives_before = update_collective_count()
    for epoch in range(args.num_epochs):
        t0 = time.perf_counter()
        correct = total = 0
        seeds = [s.seed_batches() for s in samplers]
        for _ in range(steps_per_epoch):
            with timers.phase("sample"):
                batches = [s.sample_batch(next(it))
                           for s, it in zip(samplers, seeds)]
            with timers.phase("feature_gather"):
                x0s = [gather_features(g.features, b.input_nodes, device)
                       for b in batches]
                _synchronize(device)
            with timers.phase("train_step"):
                loss, c, t = step(batches, x0s, drop_gens)
                _synchronize(device)
            steps += 1
            correct += int(c)
            total += int(t)
        acc = correct / max(total, 1)
        loss_v = float(loss) if steps_per_epoch else 0.0
        dt = time.perf_counter() - t0
        print(f"epoch {epoch}: loss={loss_v:.4f} acc={acc:.4f} "
              f"time={dt:.2f}s [{timers.summary()}]")
        last_phases = {k: round(v, 4) for k, v in timers.as_dict().items()}
        timers.clear()
    return {"mode": "ddp", "acc": acc, "loss": loss_v, "partitions": P,
            "steps": steps, "phases": last_phases,
            "collectives": update_collective_count() - collectives_before,
            **_rank_metrics(ranks, model)}


def train_quiver(args, g, fanouts, timers, device: torch.device | None = None,
                 ranks=None):
    """The quiver baseline (``--mode quiver``), the JAX trainer's
    ``train_quiver``: draws, feature gather, forward, backward and Adam on
    the device (``sampling.device_sampler``), the features held there in
    ``--dtype`` once a process, one shared permutation cut into P shards'
    rows, this process's ``[lo, hi)`` of them (``ranks``, as
    ``train_ddp``'s). SAGE only, as the reference baseline; every draw
    takes ``fanout`` neighbours with replacement, whatever the degree."""
    from occ_gnn_tpu_torch.parallel import dist
    from occ_gnn_tpu_torch.parallel.model import update_collective_count
    from occ_gnn_tpu_torch.sampling.device_sampler import DeviceSampleTrainer

    if args.model_name != "sage":
        raise SystemExit("--mode quiver supports --model-name sage "
                         "(the reference quiver baseline is SAGE-only)")
    device = device or resolve_device(args)
    ranks = _place(args, ranks, device)
    model = _make_model(args, g, device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    drv = DeviceSampleTrainer(g, fanouts, args.batch_size, model, opt,
                              seed=args.seed, dtype=dtype, device=device,
                              ranks=ranks)
    if ranks.grouped:
        dist.check_agreement(ranks, weights=model)
    nodes = _train_nodes(args, g)
    acc = loss_v = 0.0
    last_phases = {}
    collectives_before = update_collective_count()
    for epoch in range(args.num_epochs):
        t0 = time.perf_counter()
        with timers.phase("fused_step"):
            loss_v, correct, total = drv.train_epoch(nodes)
        acc = correct / max(total, 1)
        dt = time.perf_counter() - t0
        print(f"epoch {epoch}: loss={loss_v:.4f} acc={acc:.4f} "
              f"time={dt:.2f}s [{timers.summary()}]")
        last_phases = {k: round(v, 4) for k, v in timers.as_dict().items()}
        timers.clear()
    return {"mode": "quiver", "acc": acc, "loss": loss_v,
            "partitions": ranks.num_partitions, "steps": drv.steps,
            "phases": last_phases,
            "collectives": update_collective_count() - collectives_before,
            **_rank_metrics(ranks, model)}


def run_infer(args, g, fanouts, timers, device: torch.device | None = None,
              ranks=None):
    """Inference (``--mode infer``), the JAX trainer's ``run_infer``: the
    split model loads ``--resume`` (either package's checkpoint) and
    predicts the ``--infer-nodes`` set through the split forward, fed by
    the C++ or numpy sampler with worst-case capacities, no cache and the
    host feature gather. Reports the accuracy and count over every rank;
    ``--output`` gets one int32 prediction per node (-1 where none):
    the predictions of this process's partitions, which rank 0 writes
    after one MAX all-reduce of the processes' arrays (directly in a run
    of one process)."""
    from torch.distributed import ReduceOp

    from occ_gnn_tpu_torch.parallel import dist
    from occ_gnn_tpu_torch.parallel.model import make_split_forward
    from occ_gnn_tpu_torch.sampling.slicer import SplitSampler
    from occ_gnn_tpu_torch.utils.checkpoint import load_checkpoint

    if not args.resume:
        raise SystemExit("--mode infer requires --resume <checkpoint>")
    device = device or resolve_device(args)
    ranks = _place(args, ranks, device)
    P, rank = ranks.num_partitions, ranks.rank
    emit = dist.local_partition_range(ranks)
    pmap = _partition_map(args, g, P)
    model = _make_split_model(args, g)
    epoch = load_checkpoint(args.resume, model)
    model = model.to(device)
    print(f"loaded {args.resume} (epoch {epoch})")
    if ranks.grouped:
        dist.check_agreement(ranks, partition_map=pmap, weights=model)

    masks = {"train": g.train_mask, "val": g.val_mask, "test": g.test_mask}
    if args.infer_nodes == "all":
        nodes = np.arange(g.num_nodes, dtype=np.int64)
    else:
        nodes = np.nonzero(masks[args.infer_nodes])[0]
    if args.sampler == "native":
        from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler

        sampler = NativeSplitSampler(
            g, nodes, pmap, P, fanouts, args.batch_size, seed=args.seed,
            num_workers=args.num_workers,
            replace=not args.sample_without_replacement, emit_range=emit,
            device=device,
        )
    else:
        sampler = SplitSampler(g, nodes, pmap, P, fanouts, args.batch_size,
                               seed=args.seed,
                               replace=not args.sample_without_replacement,
                               emit_range=emit, device=device)
    fwd = make_split_forward(model, ranks=ranks)
    preds = np.full(g.num_nodes, -1, dtype=np.int32)
    correct = total = 0
    try:
        for batch in sampler:
            with timers.phase("infer_step"):
                logits = fwd(batch, _gather_xs(g, batch, device))
                pred = logits.argmax(-1).cpu().numpy()
            labels = batch.labels.cpu().numpy()
            tgt = batch.target_nodes.cpu().numpy()
            valid = labels >= 0
            preds[tgt[valid]] = pred[valid]
            correct += int((pred[valid] == labels[valid]).sum())
            total += int(valid.sum())
    finally:
        if hasattr(sampler, "close"):
            sampler.close()
    if ranks.grouped:
        correct, total = (int(v) for v in dist.all_reduce_values(
            ranks, [correct, total]))
        merged = torch.from_numpy(preds).to(dist.comm_device(ranks))
        torch.distributed.all_reduce(merged, op=ReduceOp.MAX)
        preds = merged.cpu().numpy()
    acc = correct / max(total, 1)
    print(f"infer accuracy ({args.infer_nodes}): {acc:.4f} over {total}")
    out = {"mode": "infer", "acc": acc, "count": total, "partitions": P,
           "partitions_local": [ranks.lo, ranks.hi], "rank": rank,
           "backend": ranks.backend, "weights_crc32": dist.checksum(model)}
    if args.output:
        if rank == 0:
            np.save(args.output, preds)
        out["output"] = args.output
    return out


if __name__ == "__main__":
    main()
