"""One process per rank: process groups for the modes that run at P > 1.

The counterpart of the JAX package's ``parallel/multihost.py``. The JAX
step is one SPMD program over a mesh of P devices; in the port rank r of a
process group of P ranks runs that program's per-device body. In split
training rank r is partition r:

  * every rank runs the same seeded sampler over the same train nodes and
    emits only its own partition's rows (``emit_range=(r, r + 1)``), so
    the ranks agree on every batch without exchanging it;
  * each rank holds only its own feature-cache frame;
  * the step exchanges boundary partials with one all-to-all per layer,
    forward and backward (``parallel.split.shuffle_merge``), all-reduces
    the loss terms, and all-reduces the gradients (SUM, as the shard_map
    transpose does) before the optimizer step.

The baselines (``--mode ddp`` and ``quiver``) and inference run the same
way: rank r takes shard r, or row r, of every batch, drawn alike on every
rank, and the ranks all-reduce the loss terms and gradients (or the
predictions).

Rank r runs on ``cuda:{r % device_count}``, or on the CPU with ``--cpu``.
The backend is NCCL when every rank has a card of its own, and gloo on
the CPU or when ranks share a card (NCCL refuses two ranks on one card).
Each rank prints the choice; nothing changes it after a failure.

``launch`` is the one-host launcher: ``--partitions P`` without
``--distributed`` spawns P ranks, as the JAX CLI drives P devices from one
command.
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
    """This process's place in the (default) process group: rank r holds
    partition r on ``device``."""

    rank: int
    world_size: int
    backend: str
    device: torch.device


def local_partition_range(ranks: DistContext) -> tuple[int, int]:
    """The partitions this process supplies: ``(rank, rank + 1)``."""
    return ranks.rank, ranks.rank + 1


def rank_seed(seed: int, rank: int) -> int:
    """One device-draw stream per rank, as a JAX step folds the axis
    index into its key; rank 0 keeps ``seed``, so P = 1 is unchanged."""
    return seed + 1_000_003 * rank


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
                     cpu: bool) -> DistContext:
    """Join the process group at ``init_method`` (``tcp://host:port``,
    ``file://path`` or ``env://``) as ``rank`` of ``world_size``."""
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
    print(f"distributed: rank {rank}/{world_size}, backend {backend}, "
          f"device {device}{shared}", flush=True)
    return DistContext(rank, world_size, backend, device)


def init_from_args(args) -> DistContext:
    """The process group from the JAX CLI's flag names: ``--coordinator-
    address`` (``host:port``, or a ``tcp://`` / ``file://`` URL),
    ``--num-processes`` and ``--process-id``; without the address, from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``)."""
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
    return init_distributed(init, world, rank, args.cpu)


def close(ranks: DistContext | None) -> None:
    if ranks is not None and dist.is_initialized():
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
    """Run the CLI ``argv`` as ``num_ranks`` ranks of one process group
    (``spawn``) and return rank 0's metrics."""
    argv = [a for a in argv if a != "--json"]
    with tempfile.TemporaryDirectory(prefix="occ_launch_") as tmp:
        out = os.path.join(tmp, "rank0.json")
        spawn(_run_rank, num_ranks, argv, out)
        with open(out) as f:
            return json.load(f)
