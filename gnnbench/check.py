"""The comparison that decides ``correct``.

Training readings of the port (what its first steps produced through the
window's own call) against the reference's over the same samples:

- ``loss1_gap``: the first step's ``|loss - ref| / |ref|``;
- ``loss_gap``: the largest of it over the checked steps;
- ``grad1_gap``: the first step's gradient as the optimizer got it
  (Adam's first moment after one step over ``1 - beta1``), by its worst
  leaf: ``| |g| - |g_ref| |`` over the larger of ``|g_ref|`` of that leaf
  and of the median leaf;
- ``grad1_out_gap``: the same gap at the output layer's weights, which
  no activation's kink and no long cancelling sum stand between the loss
  and: steady from seed to seed where the first layers' leaves swing;
- ``change_gap``: the weights' change after the checked steps, by its
  worst leaf, measured so.

Leaves whose reference gradient is under ``NOUGHT`` of the median leaf's
(nought to rounding, such as GAT's unread last bias) take no part in the
two leaf numbers: Adam moves them by round-off alone. Two exact counts
come beside them: ``sample_violations``, the judge's breaches of the
samples (``reference/samples.py``), and ``count_gap``, the training
targets the port counted in the window against those the benchmark
handed it. Each number compared has its limit in
``limits/<workload>.json``; a number a cell's file leaves out is not
compared there.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
from pathlib import Path

import torch

NOUGHT = 1e-3
LIMITS = Path(__file__).resolve().parent / "limits"
NUMBERS = ("loss1_gap", "loss_gap", "grad1_gap", "grad1_out_gap",
           "change_gap", "sample_violations", "count_gap")


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gap(got: dict, ref: dict, keep) -> float:
    """Worst kept leaf of ``| |got| - |ref| |`` over ``max(|ref|,
    median |ref|)``."""
    g, r = _norms(got), _norms(ref)
    med = statistics.median(r.values())
    worst = 0.0
    for k in keep:
        gap = abs(g[k] - r[k]) / max(r[k], med, 1e-300)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def kept_leaves(ref_grad1: dict) -> list[str]:
    norms = _norms(ref_grad1)
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= NOUGHT * med]


def numbers(got: dict, ref: dict, initial: dict, out_leaf: str) -> dict:
    """``got`` and ``ref``: ``{"losses", "grad1", "final"}`` (``grad1``
    None when the port's optimizer kept no state); ``initial`` the weights
    both started from; ``out_leaf`` the output layer's weights."""
    keep = kept_leaves(ref["grad1"])
    losses = got["losses"]
    if len(losses) != len(ref["losses"]):
        gaps = [math.inf]
    else:
        gaps = [(abs(a - b) / max(abs(b), 1e-300)
                 if math.isfinite(a) else math.inf)
                for a, b in zip(losses, ref["losses"])]
    grad1 = grad1_out = math.inf
    if got["grad1"] is not None:
        grad1 = leaf_gap(got["grad1"], ref["grad1"], keep)
        grad1_out = leaf_gap(got["grad1"], ref["grad1"], [out_leaf])

    def change(final):
        return {k: final[k].double().cpu() - initial[k].double().cpu()
                for k in initial}

    moved, moved_ref = change(got["final"]), change(ref["final"])
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps), "loss_gaps": gaps,
            "grad1_gap": grad1, "grad1_out_gap": grad1_out,
            "change_gap": leaf_gap(moved, moved_ref, keep),
            "left_out_leaves": sorted(set(initial) - set(keep)),
            "leaves": {k: {"grad1": (None if got["grad1"] is None else
                                     leaf_gap(got["grad1"], ref["grad1"],
                                              [k])),
                           "change": leaf_gap(moved, moved_ref, [k]),
                           "ref_grad1_norm": _norms({k: ref["grad1"][k]})[k],
                           "sign_flips": (None if got["grad1"] is None else
                                          _flips(got["grad1"][k],
                                                 ref["grad1"][k]))}
                       for k in initial}}


def _flips(got: torch.Tensor, ref: torch.Tensor) -> list:
    """Elements whose first gradient differs in sign from the reference's,
    and of those, how many the reference holds under 1e-6 of the leaf's
    largest: Adam's first step moves each element by the learning rate
    whatever its size, so a sign lost to rounding moves it the other
    way."""
    got, ref = got.double().cpu().flatten(), ref.double().cpu().flatten()
    flip = torch.sign(got) != torch.sign(ref)
    tiny = ref.abs() < 1e-6 * ref.abs().max().clamp(min=1e-300)
    return [int(flip.sum()), int((flip & tiny).sum()), ref.numel()]


def load_limits(workload: str) -> dict:
    path = LIMITS / f"{workload}.json"
    return {k: float(v) for k, v in json.loads(path.read_text()).items()
            if k in NUMBERS}


def decide(values: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and ``{number: {"value", "limit"}}`` for every number
    that has a limit; a number without a value fails."""
    out, ok = {}, True
    for name in NUMBERS:
        if name not in limits:
            continue
        v = values.get(name)
        v = math.inf if v is None or not math.isfinite(float(v)) else v
        out[name] = {"value": v, "limit": limits[name]}
        ok = ok and v <= limits[name]
    return ok, out


def report(checks: dict, stream=sys.stderr) -> None:
    """Each number beside its limit (``{name: [value, limit]}``), as the
    run's last lines."""
    for name, (value, limit) in checks.items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=stream)
