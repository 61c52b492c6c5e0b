"""The port's dataset converter (``occ_gnn_tpu_torch/data/convert.py``)
against the JAX package's: the same arguments write graphs that the JAX
``load_graph`` reads, with arrays equal to the JAX converter's; ``ogb``
stops with the same message where the package is missing.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from occ_gnn_tpu.data import load_graph
from occ_gnn_tpu.data.convert import main as jax_convert
from occ_gnn_tpu_torch.data.convert import main as port_convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = ("indptr", "indices", "features", "labels", "train_mask",
          "val_mask", "test_mask", "partition_map")


def _assert_same_graph(root_a, root_b, name):
    a, b = load_graph(root_a, name), load_graph(root_b, name)
    assert a.num_classes == b.num_classes
    for key in ARRAYS:
        x, y = getattr(a, key), getattr(b, key)
        assert x is not None and y is not None, key
        np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("mode", ["greedy", "round_robin"])
def test_synth_matches_jax_converter(tmp_path, mode):
    args = ["synth", "--name", "s1", "--num-nodes", "500", "--avg-degree",
            "5", "--feature-dim", "16", "--partitions", "4",
            "--partition-mode", mode]
    jax_convert(args + ["--root", str(tmp_path / "jax")])
    port_convert(args + ["--root", str(tmp_path / "port")])
    _assert_same_graph(str(tmp_path / "jax"), str(tmp_path / "port"), "s1")
    g = load_graph(str(tmp_path / "port"), "s1")
    assert g.num_nodes == 500 and g.partition_map.max() == 3


def test_edgelist_matches_jax_converter(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "edges.txt")
    np.savetxt(path, rng.integers(0, 200, size=(1000, 2)), fmt="%d",
               header="src dst")
    args = ["edgelist", "--input", path, "--name", "el", "--feature-dim",
            "8", "--num-classes", "5", "--partitions", "2"]
    jax_convert(args + ["--root", str(tmp_path / "jax")])
    port_convert(args + ["--root", str(tmp_path / "port")])
    _assert_same_graph(str(tmp_path / "jax"), str(tmp_path / "port"), "el")
    g = load_graph(str(tmp_path / "port"), "el")
    assert g.num_edges > 0 and g.feature_dim == 8


def test_ogb_stops_with_the_jax_message(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "ogb", None)  # import fails
    monkeypatch.setitem(sys.modules, "ogb.nodeproppred", None)
    texts = []
    for convert in (jax_convert, port_convert):
        with pytest.raises(SystemExit) as err:
            convert(["ogb", "--name", "ogbn-arxiv", "--root",
                     str(tmp_path)])
        texts.append(str(err.value))
    assert texts[0] == texts[1]
    assert texts[1].startswith("ogb is not installed")


def test_module_runs_without_jax(tmp_path):
    """``python -m occ_gnn_tpu_torch.data.convert`` writes the graph and
    never imports JAX."""
    code = ("import runpy, sys\n"
            "sys.argv = ['convert', 'synth', '--name', 's2', '--root', "
            f"{str(tmp_path)!r}, '--num-nodes', '300', '--feature-dim', "
            "'8', '--partitions', '2']\n"
            "runpy.run_module('occ_gnn_tpu_torch.data.convert', "
            "run_name='__main__')\n"
            "print('jax' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "False"
    assert "wrote" in proc.stdout
    assert load_graph(str(tmp_path), "s2").num_nodes == 300
