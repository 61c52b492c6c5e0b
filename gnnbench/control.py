"""The readings that the correctness limits are set from, at a cell's own
size on the card (the benchmark's runs do not run this).

    python3 -m gnnbench.control --workload gat-split-b4096 \
        --seeds 11 12 13 --controls 3 --out readings.jsonl

For each seed, in one process: the cell's set-up and its first steps
through the window's call, as ``run.py`` drives them; then, against the
float64 reference over the same samples,

- ``program``: the port's readings (the lower reading is their largest
  over the seeds);
- ``control`` (the first ``--controls`` seeds): the reference put in the
  port's place in the nearest precision below the configuration's,
  float32 products in TF32;
- ``half_batch`` (the same seeds): the reference's loss over half of each
  batch, the mean taken over the rest (a planted fault).

A state left unchanged reads 1 on ``change_gap`` and needs no run. One
JSON line a seed and reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gnnbench import check, models, run, spec
from gnnbench.reference import train as ref_train


def readings(cell: spec.Cell, seed: int, device, controls: bool) -> list:
    """``[(kind, numbers)]`` of one seed, through ``run.py``'s own set-up
    and judge."""
    started = run.start(cell, seed, device)
    first, initial = started.first, started.initial
    found, refs, labels, features, ref = run.judge(cell, started, device)
    cfg = cell.config
    out = models.load(cfg).output_leaf(cfg)
    got = [("program", {**check.numbers(first, ref, initial, out),
                        "sample_violations": sum(found.values())})]
    if controls:
        ctl = ref_train.steps(cfg, initial, refs, features, labels,
                              torch.float32, tf32=True)
        got.append(("control", check.numbers(ctl, ref, initial, out)))
        half = ref_train.steps(cfg, initial, refs, features, labels,
                               torch.float64, keep=0.5)
        got.append(("half_batch", check.numbers(half, ref, initial, out)))
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser("gnnbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3,
                   help="seeds, the first, that also read the control and "
                        "the half-batch fault")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device is visible to torch", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            t = time.perf_counter()
            for kind, nums in readings(cell, seed, device,
                                       i < args.controls):
                line = json.dumps({"workload": cell.name, "seed": seed,
                                   "kind": kind, **nums,
                                   "seconds": time.perf_counter() - t})
                print(line, flush=True)
                if sink:
                    print(line, file=sink, flush=True)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
