"""Processes, and the partitions each holds, for the modes that run at P > 1.

The counterpart of the JAX package's ``parallel/multihost.py``. The JAX
step is one SPMD program over a mesh of P devices, and one process
supplies the partitions of every device it addresses. In the port W
processes share the P partitions: process k holds the contiguous range
``[k * L, (k + 1) * L)``, L = P / W, all on one device (its card, or the
CPU). In split training:

  * every process runs the same seeded sampler over the same train nodes
    and emits only its own partitions' rows (``emit_range=(lo, hi)``), so
    the processes agree on every batch without exchanging it;
  * each process holds only its own partitions' feature-cache frames;
  * the step runs its L partitions layer by layer, and the boundary
    partials cross with one all-to-all per layer between the processes
    (``parallel.split.shuffle_merge``), a copy in device memory between
    the partitions of one process; the loss terms and the gradients are
    all-reduced over the processes (SUM, as the shard_map transpose does).

The baselines (``--mode ddp`` and ``quiver``) place their P shards the
same way: process k holds shards ``[lo, hi)``, samples (ddp) or draws
(quiver) each from its own seeded stream, runs the single-chip model
once per shard, sums the shards' loss terms and gradients locally and
all-reduces them over the processes.

A run of one process (W = 1) creates no process group and issues no
collective, whatever its P.

Process k runs on ``cuda:{k % device_count}``, or on the CPU with
``--cpu``. The backend is NCCL when every process has a card of its own,
and gloo on the CPU or when processes share a card (NCCL refuses two
ranks on one card). Each process prints the choice; nothing changes it
after a failure.

``launch`` is the one-host launcher and ``placement`` its rule: on the
card one process per card the partitions land on, under ``--cpu``
``ceil(P / --cpu-devices)`` processes, as the JAX CLI drives the devices
of one host from one process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class DistContext:
    """This process's place in a run: process ``rank`` of ``world_size``
    holds partitions ``[lo, hi)`` on ``device``. ``backend`` is the
    process group's, or ``"none"`` for a run of one process, which has
    no group."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    lo: int
    hi: int

    @property
    def local(self) -> int:
        """L, the partitions this process holds."""
        return self.hi - self.lo

    @property
    def num_partitions(self) -> int:
        """P, the partitions of the run."""
        return self.world_size * self.local

    @property
    def grouped(self) -> bool:
        """Whether the run has a process group to issue collectives on."""
        return self.world_size > 1


def single_process(num_partitions: int, device) -> DistContext:
    """The context of a run of one process holding every partition."""
    return DistContext(0, 1, "none", torch.device(device), 0, num_partitions)


def local_partition_range(ranks: DistContext) -> tuple[int, int]:
    """The partitions this process supplies: ``(k * L, (k + 1) * L)``."""
    return ranks.lo, ranks.hi


def rank_seed(seed: int, part: int) -> int:
    """One device-draw stream per partition (or per shard of the
    baselines), as a JAX step folds the axis index into its key; partition
    0 keeps ``seed``, so P = 1 is unchanged, and the draws of a run do not
    depend on which process holds a partition."""
    return seed + 1_000_003 * part


def placement(partitions: int, *, cpu: bool, cpu_devices: int,
              world: int | None = None) -> tuple[int, int]:
    """``(P, W)``: the run's partitions (or the baselines' shards) and its
    processes, P / W each.

    ``world`` is the process count of a group started elsewhere
    (``--distributed``); ``None`` asks for the one-host launcher's: one
    process per card the partitions land on (``min(P, device_count)``),
    or ``ceil(P / cpu_devices)`` under ``cpu``. ``partitions`` 0 means
    ``W * cpu_devices`` under ``cpu`` and W on the card (one process
    under the launcher). Stops when P is not a multiple of W."""
    if cpu_devices < 1:
        raise SystemExit(f"--cpu-devices {cpu_devices} must be at least 1")
    if world is not None:
        W = world
        P = partitions or (W * cpu_devices if cpu else W)
    else:
        P = partitions or (cpu_devices if cpu else 1)
        W = (-(-P // cpu_devices) if cpu
             else min(P, max(torch.cuda.device_count(), 1)))
    if P % W:
        raise SystemExit(f"--partitions {P} is not a multiple of the {W} "
                         f"processes that hold them (--cpu-devices "
                         f"{cpu_devices}, {'the CPU' if cpu else 'cards'})")
    return P, W


def rank_device(rank: int, cpu: bool) -> torch.device:
    """``cuda:{rank % device_count}``, or the CPU with ``cpu``. With no
    visible GPU and no ``cpu`` it stops: it never falls back."""
    if cpu:
        return torch.device("cpu")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise SystemExit(f"error: rank {rank}: no CUDA device is visible to "
                         "torch; pass --cpu to run on the CPU")
    return torch.device("cuda", rank % count)


def choose_backend(world_size: int, cpu: bool) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    own_card = not cpu and torch.cuda.device_count() >= world_size
    return "nccl" if own_card else "gloo"


def init_distributed(init_method: str, world_size: int, rank: int,
                     cpu: bool, local: int = 1) -> DistContext:
    """Join the process group at ``init_method`` (``tcp://host:port``,
    ``file://path`` or ``env://``) as ``rank`` of ``world_size``, holding
    ``local`` partitions."""
    if not 0 <= rank < world_size:
        raise ValueError(f"process id {rank} outside [0, {world_size})")
    device = rank_device(rank, cpu)
    backend = choose_backend(world_size, cpu)
    if cpu:
        # The ranks share the host's cores.
        torch.set_num_threads(1)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)
    shared = ("" if cpu or backend == "nccl"
              else f", {world_size} ranks on {torch.cuda.device_count()} "
                   "card(s)")
    lo = rank * local
    print(f"distributed: rank {rank}/{world_size}, backend {backend}, "
          f"device {device}, partitions [{lo}, {lo + local}){shared}",
          flush=True)
    return DistContext(rank, world_size, backend, device, lo, lo + local)


def init_from_args(args) -> DistContext:
    """The process group from the JAX CLI's flag names: ``--coordinator-
    address`` (``host:port``, or a ``tcp://`` / ``file://`` URL),
    ``--num-processes`` and ``--process-id``; without the address, from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``). Each process holds P / W partitions or shards
    (``placement``)."""
    addr = args.coordinator_address
    if addr:
        if args.num_processes < 1 or args.process_id < 0:
            raise SystemExit("--coordinator-address needs --num-processes "
                             "and --process-id")
        init = addr if "://" in addr else f"tcp://{addr}"
        world, rank = args.num_processes, args.process_id
    else:
        try:
            world = int(os.environ["WORLD_SIZE"])
            rank = int(os.environ["RANK"])
        except KeyError:
            raise SystemExit("--distributed needs --coordinator-address, "
                             "--num-processes and --process-id, or "
                             "torchrun's environment") from None
        init = "env://"
    P, W = placement(args.partitions, cpu=args.cpu,
                     cpu_devices=args.cpu_devices, world=world)
    return init_distributed(init, W, rank, args.cpu, local=P // W)


def close(ranks: DistContext | None) -> None:
    if ranks is not None and ranks.backend != "none" and \
            dist.is_initialized():
        dist.destroy_process_group()


def comm_device(ranks: DistContext) -> torch.device:
    """Where a host value goes for a collective: the rank's card under
    NCCL, else the CPU."""
    return ranks.device if ranks.backend == "nccl" else torch.device("cpu")


def all_reduce_values(ranks: DistContext, values, op=dist.ReduceOp.SUM):
    """All-reduce a few host numbers in f64; returns a numpy array."""
    t = torch.tensor(np.asarray(values, dtype=np.float64),
                     device=comm_device(ranks))
    dist.all_reduce(t, op=op)
    return t.cpu().numpy()


def all_reduce_gradients(params) -> None:
    """SUM-all-reduce every parameter's gradient in one flat buffer and
    write the sums back."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g)
        offset += n


def checksum(value) -> int:
    """CRC-32 of a module's state, a numpy array or a JSON value (to
    compare what the ranks hold)."""
    if isinstance(value, torch.nn.Module):
        data = b"".join(t.detach().cpu().numpy().tobytes()
                        for t in value.state_dict().values())
    elif isinstance(value, np.ndarray):
        data = np.ascontiguousarray(value).tobytes()
    else:
        data = json.dumps(value, sort_keys=True).encode()
    return zlib.crc32(data)


def check_agreement(ranks: DistContext, **items) -> None:
    """Stop unless every rank holds the same ``items`` (numpy arrays,
    modules, or JSON values such as capacities): one all-reduce of their
    checksums, MAX over ``[c, -c]``, so max == min on every item."""
    names = list(items)
    sums = np.array([checksum(items[k]) for k in names], dtype=np.float64)
    hi_lo = all_reduce_values(ranks, np.concatenate([sums, -sums]),
                              op=dist.ReduceOp.MAX)
    n = len(names)
    differ = [k for i, k in enumerate(names) if hi_lo[i] != -hi_lo[n + i]]
    if differ:
        raise RuntimeError(f"rank {ranks.rank}: the ranks disagree on "
                           f"{', '.join(differ)} (same seed, graph and flags "
                           "on every rank?)")


# -- the one-host launcher -------------------------------------------------


def spawn(target, num_ranks: int, *args, timeout: float | None = None):
    """Run ``target(rank, num_ranks, init_method, *args)`` in ``num_ranks``
    spawned processes that meet at a ``file://`` store in a temporary
    directory, and wait for all of them. If one fails, or ``timeout``
    seconds pass, the others are stopped and this raises: a rank never
    waits forever in a collective its peer left."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="occ_ranks_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=target, daemon=True,
                             args=(r, num_ranks, store, *args))
                 for r in range(num_ranks)]
        for p in procs:
            p.start()
        failure = _wait(procs, timeout)
    if failure is not None:
        raise SystemExit(f"{failure}; the other ranks were stopped")


def _wait(procs, timeout: float | None) -> str | None:
    """Wait for every process; on the first failure, or at the timeout,
    stop the rest and say what happened."""
    deadline = None if timeout is None else time.monotonic() + timeout
    failure = None
    while failure is None:
        codes = [p.exitcode for p in procs]
        if None not in codes and not any(codes):
            return None
        bad = [r for r, code in enumerate(codes) if code not in (None, 0)]
        if bad:
            failure = (f"rank {bad[0]} of {len(procs)} exited with code "
                       f"{codes[bad[0]]}")
        elif deadline is not None and time.monotonic() > deadline:
            failure = f"the ranks were still running after {timeout} s"
        else:
            time.sleep(0.05)
    for p in procs:
        if p.exitcode is None:
            p.terminate()
        p.join()
    return failure


def _run_rank(rank: int, num_ranks: int, store: str, argv: list[str],
              out_path: str) -> None:
    from occ_gnn_tpu_torch.train import main

    metrics = main(argv + ["--distributed", "--coordinator-address", store,
                           "--num-processes", str(num_ranks),
                           "--process-id", str(rank)])
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(metrics, f)


def launch(argv: list[str], num_ranks: int) -> dict:
    """Run the CLI ``argv`` as ``num_ranks`` processes of one process
    group (``spawn``) and return rank 0's metrics."""
    argv = [a for a in argv if a != "--json"]
    with tempfile.TemporaryDirectory(prefix="occ_launch_") as tmp:
        out = os.path.join(tmp, "rank0.json")
        spawn(_run_rank, num_ranks, argv, out)
        with open(out) as f:
            return json.load(f)
