"""Whole runs on the CPU at a tiny size: each cell's run is correct, its
numbers inside the limits set at the cell's size on the card; and with
the timed path broken underneath (the harness's look for a card
skipped), ``correct`` comes out false for each fault the cells can
have."""

from __future__ import annotations

import pytest
import torch

from gnnbench import check, run
from gnnbench.tests.conftest import tiny_cell, workloads

CPU = torch.device("cpu")
SEED = 2**33 + 5


def _run(name, traced=False, seconds=0.3):
    return run.run_cell(tiny_cell(name), SEED, seconds, traced, CPU,
                        check.load_limits(name))


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", workloads())
def test_cell_is_correct_on_the_cpu(workload, traced):
    out = _run(workload, traced)
    assert out["correct"], out["checks"]
    checks = out["checks"]
    for name, (value, limit) in checks.items():
        assert value <= limit, name
    assert checks["sample_violations"][0] == 0
    assert checks["count_gap"][0] == 0
    assert out["attempted"] > 0
    assert list(out)[-1] == "checks"


def _half_ce(original):
    def half(logits, labels):
        labels = labels.clone()
        valid = torch.nonzero(labels >= 0)[:, 0]
        labels[valid[valid.numel() // 2:]] = -1
        return original(logits, labels)
    return half


def test_unchanged_state_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    for name in workloads():
        out = _run(name)
        assert not out["correct"], (name, out["checks"])


def test_half_batch_is_caught(monkeypatch):
    from occ_gnn_tpu_torch.parallel import model

    monkeypatch.setattr(model, "_local_ce", _half_ce(model._local_ce))
    for name in workloads():
        out = _run(name)
        assert not out["correct"], (name, out["checks"])
        assert out["checks"]["loss1_gap"][0] > out["checks"]["loss1_gap"][1]


def test_altered_draw_is_caught(monkeypatch):
    from occ_gnn_tpu_torch.sampling import device_sampler

    original = device_sampler.draw_neighbors

    def altered(frontier, indptr, indices, r):
        out = original(frontier, indptr, indices, r).clone()
        out[-1] = (out[-1] + 1) % (indptr.numel() - 1)
        return out

    monkeypatch.setattr(device_sampler, "draw_neighbors", altered)
    out = _run("sage-quiver-b4096")
    assert not out["correct"]
    assert out["checks"]["sample_violations"][0] > 0


def test_altered_synthesis_is_caught(monkeypatch):
    from occ_gnn_tpu_torch.parallel import split

    original = split.synthesize_innermost

    def altered(dst, indptr, indices, draws, K, src_cap, out_cap):
        f = original(dst, indptr, indices, draws, K, src_cap, out_cap)
        f.nbr[1, 0] = (f.nbr[1, 0] + 1) % (src_cap - 1)
        return f

    monkeypatch.setattr(split, "synthesize_innermost", altered)
    out = _run("gat-split-b4096")
    assert not out["correct"]
    assert out["checks"]["sample_violations"][0] > 0


def test_split_driver_runs_sage_against_the_reference():
    """The split driver with the SAGE configuration (no cell of its own
    yet): its samples judged sound and its first steps at the
    reference's."""
    cell = tiny_cell("gat-split-b4096")
    cell.config = {**tiny_cell("sage-quiver-b4096").config}
    out = run.run_cell(cell, SEED, 0.3, False, CPU,
                       {"sample_violations": 0.0, "count_gap": 0.0})
    assert out["correct"], out["checks"]
    leaves = out["leaves"]
    assert set(leaves) == {f"layer_{i}/{k}" for i in range(3)
                           for k in ("w", "b")}
    assert max(v["grad1"] for v in leaves.values()) < 1e-4
