"""The graph generator gives the configuration's sizes (at a small
scale), a sorted in-neighbour CSR with every edge both ways, no self
loops, and the same graph for the same seed."""

from __future__ import annotations

import numpy as np
import torch

from gnnbench.graph import make_graph
from gnnbench.tests.conftest import TINY_CONFIG

CFG = {**TINY_CONFIG, "popularity_exponent": 0.8}


def test_sizes_and_csr():
    g = make_graph(CFG, 7, torch.device("cpu"))
    n, m = CFG["num_nodes"], CFG["num_undirected_edges"]
    assert g.num_nodes == n and g.num_edges == 2 * m
    assert g.indptr[0] == 0 and g.indptr[-1] == 2 * m
    assert g.features.shape == (n, CFG["feature_dim"])
    assert g.features.dtype == np.float32 and g.labels.dtype == np.int32
    assert 0 <= g.labels.min() and g.labels.max() < CFG["num_classes"]
    assert g.train_mask.sum() == CFG["train_nodes"]
    assert g.val_mask.sum() == CFG["val_nodes"]
    assert g.test_mask.sum() == CFG["test_nodes"]
    assert not (g.train_mask & g.val_mask).any()
    dst = np.repeat(np.arange(n), np.diff(g.indptr))
    assert (dst != g.indices).all()
    keys = dst * n + g.indices
    assert (np.diff(keys) >= 0).all()
    back = np.sort(g.indices * n + dst)
    assert (back == keys).all()


def test_same_seed_same_graph():
    a = make_graph(CFG, 11, torch.device("cpu"))
    b = make_graph(CFG, 11, torch.device("cpu"))
    c = make_graph(CFG, 12, torch.device("cpu"))
    assert (a.indices == b.indices).all() and (a.features == b.features).all()
    assert not (a.indices == c.indices).all()
