"""A fresh process that imports the harness, its reference and control,
and drives a whole run (which loads the port), holds no module whose
top-level name, compared whole, is JAX's or the JAX package's."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import sys, torch
import gnnbench.run, gnnbench.control, gnnbench.check, gnnbench.trace
import gnnbench.reference.samples, gnnbench.reference.sage
import gnnbench.reference.gat, gnnbench.reference.train
from gnnbench import check
from gnnbench.tests.conftest import tiny_cell
out = gnnbench.run.run_cell(tiny_cell("gat-split-b4096"), 3, 0.2, False,
                            torch.device("cpu"),
                            check.load_limits("gat-split-b4096"))
assert out["correct"], out["checks"]
assert "occ_gnn_tpu_torch" in sys.modules
print("FORBIDDEN", gnnbench.run.forbidden_modules())
"""


def test_no_jax_in_a_fresh_process():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout


def test_forbidden_is_by_whole_top_level_name(monkeypatch):
    from gnnbench import run

    monkeypatch.setitem(sys.modules, "occ_gnn_tpu_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxish", object())
    assert "occ_gnn_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
