"""Run one cell of ``BENCHMARK.json`` on the CUDA card.

    python3 -m gnnbench.run --workload gat-split-b4096 --seed 7 \
        --seconds 10 --trace 0

Set-up builds the port's kernels (into its fixed ``occ_gnn_tpu_torch/
build/``, once a checkout), makes the graph and the weights from the
seed on the device, composes the port's trainer for the cell's traffic,
drives its first steps (which the reference follows) and warms it up.
The window then runs the trainer's own loop for ``--seconds`` and closes
with a synchronise. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` traces the whole window with ``torch.profiler`` and reports
its per-layer metrics. Once the window has closed and the peak memory is
read, the port's state is freed and the plain reference judges the first
steps. The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gnnbench import check, flops, models, seeds, spec, stats, trace
from gnnbench.graph import make_graph
from gnnbench.reference import train as ref_train
from gnnbench.reference.samples import GraphIndex
from gnnbench.weights import make_weights

CHECKOUT = Path(__file__).resolve().parent.parent
# Caches a library might write, at fixed paths inside the checkout; the
# port's own kernels build into its fixed occ_gnn_tpu_torch/build/.
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions"}
FORBIDDEN = ("jax", "jaxlib", "flax", "occ_gnn_tpu")
# How long rank 0 waits for the other ranks once its own run has ended.
RANK_TIMEOUT_S = 120.0


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (Linux)."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build(prog_cls, device) -> None:
    """Build what the cell's program loads, in parallel: its CUDA
    kernels on the card, and the C++ sampling service."""
    from occ_gnn_tpu_torch.ops import build as port_build

    jobs = []
    if device.type == "cuda":
        jobs += [(port_build.build_kernel, k) for k in prog_cls.buildables]
    if prog_cls.builds_sampler:
        jobs.append((lambda _: port_build.build_sampler(), None))
    with concurrent.futures.ThreadPoolExecutor(len(jobs) or 1) as pool:
        for f in [pool.submit(fn, arg) for fn, arg in jobs]:
            f.result()


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place among a cell's processes: ``world`` of them,
    one a chip unless the cell's traffic names its ``processes``, meeting
    at ``init_method`` (``tcp://localhost:<port>``; empty for one)."""
    rank: int = 0
    world: int = 1
    init_method: str = ""


SOLO = Ranks()


def processes(cell: spec.Cell) -> int:
    return int(cell.traffic.get("processes", cell.chips))


def rank_devices(cell: spec.Cell, ranks: Ranks) -> list:
    """The cards of this process: its equal share of the cell's chips."""
    per = cell.chips // ranks.world
    return [torch.device("cuda", ranks.rank * per + i) for i in range(per)]


@dataclasses.dataclass
class Started:
    prog: object
    graph: object
    initial: dict
    first: dict
    setup: dict


def start(cell: spec.Cell, seed: int, device: torch.device,
          ranks: Ranks = SOLO, counting: bool = False) -> Started:
    """Set-up up to the first steps: the builds, the graph and the weights
    from the seed, the program as the cell's driver composes it, and its
    first ``checked_steps`` through the window's own call and feed, whose
    readings the reference follows. With ``counting`` the program counts
    the rows of these and later steps until told to stop."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    driver = cell.driver()
    setup = {}
    t = time.perf_counter()
    build(driver.Program, device)
    setup["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    graph = make_graph(cfg, seeds.sub_seed(seed, "graph"), device)
    weights = make_weights(cfg, seeds.sub_seed(seed, "weights"), device)
    initial = {k: v.cpu() for k, v in weights.items()}
    setup["graph_s"] = time.perf_counter() - t

    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prog = driver.Program(cfg, traffic, graph, weights,
                          seeds.program_seed(seed),
                          seeds.sub_seed(seed, "traffic"), device, ranks)
    del weights
    setup["program_s"] = time.perf_counter() - t

    t = time.perf_counter()
    prog.counting = counting
    first = prog.checked(int(traffic["checked_steps"]))
    setup["checked_s"] = time.perf_counter() - t
    return Started(prog, graph, initial, first, setup)


def judge(cell: spec.Cell, started: Started, device: torch.device):
    """Frees the port's state, then judges the checked steps' samples
    against the graph and follows them with the float64 reference.
    Returns ``(violations, refs, labels, features, ref)``; ``ref`` and
    ``features`` are None where a sample could not be followed."""
    checked_samples = started.first.pop("samples")
    prog_judge = started.prog.judge
    started.prog.close()
    started.prog = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    graph = started.graph
    gi = GraphIndex(graph.indptr, graph.indices, device)
    found, refs, labels = prog_judge(
        gi, checked_samples, torch.from_numpy(graph.train_mask).to(device),
        torch.from_numpy(graph.labels).to(device))
    del gi
    features = ref = None
    if all(r is not None for r in refs):
        features = torch.from_numpy(graph.features).to(device)
        ref = ref_train.steps(cell.config, started.initial, refs, features,
                              labels, torch.float64)
    return found, refs, labels, features, ref


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, limits: dict,
             ranks: Ranks = SOLO) -> dict:
    """One run of ``cell`` by this process on ``device``; returns the
    result line's object (the ``checks`` key last)."""
    cfg, traffic = cell.config, cell.traffic
    s = start(cell, seed, device, ranks, counting=traced)
    prog, setup = s.prog, s.setup
    t = time.perf_counter()
    for _ in range(int(traffic["warmup_steps"]) - int(
            traffic["checked_steps"])):
        prog.step()
    prog.finish()
    # The traced run's counts come from the set-up's steps, so that the
    # window holds the program's work alone.
    prog.counting = False
    _sync(device)
    setup["warmup_s"] = time.perf_counter() - t
    setup["before_s"] = process_age_s() - sum(setup.values())
    setup["program_parts"] = prog.setup_s

    prof = None
    if traced:
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    before = prog.stats()
    events = _Events(device)
    waits, launches = [], []
    with record_function(trace.WINDOW):
        setup_s = process_age_s()
        w0 = time.perf_counter()
        events.start()
        steps = 0
        while time.perf_counter() - w0 < seconds:
            wait, launch = prog.step()
            events.step()
            steps += 1
            launches.append(launch)
            if wait is not None:
                waits.append(wait)
        counted = prog.finish()
        _sync(device)
        window_s = time.perf_counter() - w0
    setup["setup_s"] = setup_s
    if prof is not None:
        prof.stop()
    after = prog.stats()
    intervals = events.intervals_ms()
    peak = (max(torch.cuda.max_memory_allocated(d)
                for d in rank_devices(cell, ranks))
            if device.type == "cuda" else 0)
    seeds_done = steps * int(traffic["batch_size"])

    record = None
    if traced:
        tr = trace.from_profiler(prof)
        del prof
        record = {
            "trace": tr, "window_s": window_s, "steps": steps,
            "seeds": seeds_done, "intervals_ms": intervals,
            "launch_s": launches, "sample_wait_s": waits,
            **_window_counts(prog, cfg, steps),
            "kernels": flops.KERNELS, "peak_flops": flops.F32_RATE,
            "stats": {k: after[k] - before.get(k, 0) for k in after},
        }

    t = time.perf_counter()
    found, _, _, _, ref = judge(cell, s, device)
    del prog
    values = {"sample_violations": float(sum(found.values())),
              "count_gap": float(abs(counted - seeds_done))}
    if ref is not None:
        values.update(check.numbers(s.first, ref, s.initial,
                                    models.load(cfg).output_leaf(cfg)))
    check_s = time.perf_counter() - t
    correct, compared = check.decide(values, limits)

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics = {}
    if traced:
        device_info["busy_s"] = record["trace"].busy_s
        device_info["window_s"] = record["trace"].window_s
        for m in cell.per_layer:
            value = spec.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"train_seeds_per_s": stats.rate(seeds_done, window_s),
               "step_ms_p95": (stats.percentile(intervals, 95)
                               if intervals else None),
               "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        # A metric named <quantity>.<cells> is that quantity in the cells
        # it names, with a bound of its own.
        for m in cell.end_to_end:
            value = e2e.get(m["name"].split(".")[0])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": steps, "failed": 0,
           "metrics": metrics, "device": device_info,
           "setup": setup, "window_s": window_s,
           "host_ms": {"launch": 1e3 * sum(launches) / max(len(launches), 1),
                       "sample_wait": 1e3 * sum(waits) / max(len(waits), 1)},
           "check_s": check_s, "violations": found,
           "left_out_leaves": values.get("left_out_leaves", []),
           "leaves": values.get("leaves", {})}
    if traced:
        out["counted"] = record["counted"]
        out["breakdown"] = {"device_ops": record["trace"].top_ops(),
                            "idle_gaps": record["trace"].top_gaps()}
    out["checks"] = {k: [c["value"], c["limit"]] for k, c in compared.items()}
    return out


def _window_counts(prog, cfg: dict, steps: int) -> dict:
    """The window's FLOPs and kernel bound seconds: ``steps`` times the
    mean of the set-up's counted steps, which draw from the same traffic.
    ``counted`` gives the steps counted and each layer's mean rows."""
    counts = prog.counts()
    n = len(counts)
    if not n:
        return {"flops": 0.0, "kernel_bound_s": {}, "counted": {"steps": 0}}
    model = models.load(cfg)
    bounds: dict = {}
    for per_step in prog.kernel_bounds():
        for k, v in per_step.items():
            bounds[k] = bounds.get(k, 0.0) + v
    per_step_flops = sum(model.step_flops(c, cfg) for c in counts) / n
    layers = [[sum(getattr(c[i], f) for c in counts) / n
               for f in ("D", "V", "R", "S")]
              for i in range(len(counts[0]))]
    return {"flops": steps * per_step_flops,
            "kernel_bound_s": {k: steps * v / n for k, v in bounds.items()},
            "counted": {"steps": n, "flops_per_step": per_step_flops,
                        "layers_dvrs": layers}}


def merge(outs: list) -> dict:
    """One result of a cell's processes, rank 0's first: ``correct`` where
    every rank's is, each number compared at its worst rank, the peak
    memory of the fullest card, the device's busy seconds averaged over
    the ranks, and each per-layer metric averaged over the ranks that
    read it. The rest is rank 0's."""
    if len(outs) == 1:
        return outs[0]
    out = {k: v for k, v in outs[0].items() if k != "checks"}
    out["correct"] = all(o["correct"] for o in outs)
    dev = dict(out["device"])
    dev["memory_peak_bytes"] = max(o["device"]["memory_peak_bytes"]
                                   for o in outs)
    if "busy_s" in dev:
        dev["busy_s"] = statistics.fmean(o["device"]["busy_s"]
                                         for o in outs)
    out["device"] = dev
    traced = "breakdown" in out
    metrics = {}
    for name, m in outs[0]["metrics"].items():
        values = [o["metrics"][name]["value"] for o in outs
                  if name in o["metrics"]]
        if name.split(".")[0] == "peak_mem_gib":
            value = max(values)
        elif traced:
            value = statistics.fmean(values)
        else:
            value = m["value"]
        metrics[name] = {"value": value, "unit": m["unit"]}
    out["metrics"] = metrics
    out["checks"] = {
        name: max((o["checks"].get(name, [math.inf, limit]) for o in outs),
                  key=lambda c: float(c[0]))
        for name, (_, limit) in outs[0]["checks"].items()}
    return out


class _Events:
    """A CUDA event at the window's start and after each step, read once
    the window has closed; host clock readings on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self):
        self.marks = [self._mark()]

    def step(self):
        self.marks.append(self._mark())

    def intervals_ms(self) -> list[float]:
        if len(self.marks) < 2:
            return []
        if self.cuda:
            first = self.marks[0]
            done = [first.elapsed_time(e) for e in self.marks[1:]]
            return stats.intervals_ms(0.0, done)
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class _Child:
    """One rank of a cell run as its own process; its output is drained
    as it comes, so that no pipe fills."""

    def __init__(self, rank: int, cmd: list):
        self.rank = rank
        self.proc = subprocess.Popen(cmd, cwd=CHECKOUT, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
        self.stdout = self.stderr = ""
        self.thread = threading.Thread(target=self._drain, daemon=True)
        self.thread.start()

    def _drain(self):
        self.stdout, self.stderr = self.proc.communicate()


def spawn(cmds: dict) -> list:
    """``{rank: argv}``: each started as its own process."""
    return [_Child(rank, cmd) for rank, cmd in sorted(cmds.items())]


def stop(children: list) -> None:
    """Ends every child still running and waits for each."""
    for c in children:
        if c.proc.poll() is None:
            c.proc.terminate()
    for c in children:
        try:
            c.proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            c.proc.kill()
            c.proc.wait()
        c.thread.join()


def gather(children: list, timeout: float) -> list:
    """Each child's result, the JSON object of its last line of standard
    output, once every child has ended; its standard error goes on to
    this process's. A child that fails or outlasts ``timeout`` ends them
    all and raises."""
    deadline = time.monotonic() + timeout
    try:
        for c in children:
            c.thread.join(max(deadline - time.monotonic(), 0.0))
            if c.thread.is_alive():
                raise RuntimeError(f"rank {c.rank} outlasted {timeout} s")
    except BaseException:
        stop(children)
        raise
    outs = []
    for c in children:
        for line in c.stderr.splitlines()[-40:]:
            print(f"[rank {c.rank}] {line}", file=sys.stderr)
        lines = c.stdout.strip().splitlines()
        if c.proc.returncode != 0 or not lines:
            raise RuntimeError(f"rank {c.rank} exited "
                               f"{c.proc.returncode} with no result")
        outs.append(json.loads(lines[-1]))
    return outs


def main(argv=None) -> int:
    p = argparse.ArgumentParser("gnnbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A rank other than 0 of a cell of several processes, as run.py
    # itself starts it.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--init", default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CHECKOUT / ".gnnbench_cache" / sub)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("error: no CUDA device is visible to torch", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    limits = check.load_limits(cell.name)
    if args.rank is not None:
        ranks = Ranks(args.rank, args.world, args.init)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       rank_devices(cell, ranks)[0], limits, ranks)
        out = {"loaded": forbidden_modules(), **out}
        print(json.dumps(out))
        return 0

    world = processes(cell)
    ranks, children = SOLO, []
    if world > 1:
        ranks = Ranks(0, world, f"tcp://localhost:{free_port()}")
        base = [sys.executable, "-m", "gnnbench.run",
                "--workload", cell.name, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace),
                "--world", str(world), "--init", ranks.init_method]
        children = spawn({r: base + ["--rank", str(r)]
                          for r in range(1, world)})
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       rank_devices(cell, ranks)[0], limits, ranks)
        outs = [out] + gather(children, RANK_TIMEOUT_S)
    finally:
        stop(children)
    bad = sorted(set(forbidden_modules()).union(
        *(o.get("loaded", []) for o in outs)))
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    out = merge(outs)
    check.report(out["checks"])
    for name, (value, limit) in out["checks"].items():
        if not math.isfinite(value):
            out["checks"][name][0] = str(value)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
