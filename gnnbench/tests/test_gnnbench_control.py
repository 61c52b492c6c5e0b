"""On the card: the control (the reference in the port's place, its
float32 products in TF32) and the half-batch fault fail the committed
limits, while the port passes them, at each cell's own size (one seed a
cell, some 30 s each)."""

from __future__ import annotations

import pytest

from gnnbench import check, control, spec
from gnnbench.tests.conftest import workloads

NUMBERS = ("loss1_gap", "loss_gap", "grad1_gap", "grad1_out_gap",
           "change_gap")  # those with a limit in the cell


@pytest.mark.card
@pytest.mark.parametrize("workload", workloads())
def test_control_and_fault_fail_the_limits(card, workload):
    cell = spec.cell(workload)
    limits = {k: v for k, v in check.load_limits(workload).items()
              if k in NUMBERS}
    got = dict(control.readings(cell, 2**32 + 17, card, controls=True))
    program = {k: got["program"][k] for k in limits}
    assert check.decide(program, limits)[0], program
    for kind in ("control", "half_batch"):
        nums = {k: got[kind][k] for k in limits}
        assert not check.decide(nums, limits)[0], (kind, nums)
