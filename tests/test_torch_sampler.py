"""The port's data layer and sampler against the JAX package's: the same
seed gives identical graphs, capacities and batches (exact equality)."""

import numpy as np
import pytest

from occ_gnn_tpu.data import block_graph as jax_block_graph
from occ_gnn_tpu.data import random_graph as jax_random_graph
from occ_gnn_tpu.data import load_graph as jax_load_graph
from occ_gnn_tpu.data import save_graph as jax_save_graph
from occ_gnn_tpu.sampling import neighbor as jnb
from occ_gnn_tpu_torch.data import (
    block_graph,
    load_graph,
    random_graph,
    read_meta,
    save_graph,
)
from occ_gnn_tpu_torch.data.graph import Graph
from occ_gnn_tpu_torch.ops.blocks import pad_to
from occ_gnn_tpu_torch.sampling import neighbor as tnb

GRAPH_FIELDS = ("indptr", "indices", "features", "labels", "train_mask",
                "val_mask", "test_mask")


def _assert_same_graph(a, b):
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.num_classes == b.num_classes


@pytest.mark.parametrize("make_t,make_j,kw", [
    (random_graph, jax_random_graph,
     dict(num_nodes=700, avg_degree=7, feature_dim=12, num_classes=6, seed=3)),
    (block_graph, jax_block_graph,
     dict(num_nodes=600, num_blocks=5, avg_degree=9, feature_dim=10, seed=4)),
])
def test_synthetic_graphs_equal_jax(make_t, make_j, kw):
    _assert_same_graph(make_t(**kw), make_j(**kw))


def test_graph_saved_by_jax_loads_in_port(tmp_path, small_graph):
    jax_save_graph(small_graph, str(tmp_path), "g")
    g = load_graph(str(tmp_path), "g")
    _assert_same_graph(g, small_graph)
    assert read_meta(str(tmp_path), "g")["num_edges"] == small_graph.num_edges
    gm = load_graph(str(tmp_path), "g", mmap_features=True)
    np.testing.assert_array_equal(np.asarray(gm.features), g.features)


def test_graph_saved_by_port_loads_in_jax(tmp_path):
    g = random_graph(num_nodes=300, avg_degree=5, feature_dim=8, seed=5)
    save_graph(g, str(tmp_path), "g")
    _assert_same_graph(jax_load_graph(str(tmp_path), "g"), g)


def test_damaged_graph_file_is_rejected(tmp_path):
    g = random_graph(num_nodes=200, avg_degree=4, feature_dim=4, seed=6)
    d = save_graph(g, str(tmp_path), "g")
    labels = np.fromfile(f"{d}/labels.bin", dtype=np.int32)
    labels[0] += 1
    labels.tofile(f"{d}/labels.bin")
    with pytest.raises(ValueError, match="label checksum"):
        load_graph(str(tmp_path), "g")


def test_pad_feature_dim_matches_jax(small_graph):
    g = Graph(small_graph.indptr, small_graph.indices, small_graph.features,
              small_graph.labels, small_graph.num_classes)
    t, j = g.pad_feature_dim(24), small_graph.pad_feature_dim(24)
    np.testing.assert_array_equal(t.features, j.features)
    assert t.true_feature_dim == j.true_feature_dim == 16


@pytest.mark.parametrize("fanouts,batch", [([3, 4], 32), ([10, 10, 25], 64),
                                           ([-1, 2], 16)])
def test_capacities_equal_jax(small_graph, fanouts, batch):
    g = small_graph
    args = (batch, fanouts, g.num_nodes)
    assert (tnb.plan_capacities(*args, num_edges=g.num_edges)
            == jnb.plan_capacities(*args, num_edges=g.num_edges))
    nodes = g.train_nodes()
    assert (tnb.measure_capacities(g, nodes, fanouts, batch, seed=9)
            == jnb.measure_capacities(g, nodes, fanouts, batch, seed=9))


@pytest.mark.parametrize("replace", [True, False])
def test_batches_equal_jax_over_two_epochs(community_graph, replace):
    g = community_graph
    nodes = g.train_nodes()
    kw = dict(seed=11, replace=replace)
    caps = jnb.measure_capacities(g, nodes, [4, 6], 96, seed=1)
    ts = tnb.NeighborSampler(g, nodes, [4, 6], 96, capacities=caps, **kw,
                             device="cpu")
    js = jnb.NeighborSampler(g, nodes, [4, 6], 96, capacities=caps, **kw)
    n = 0
    for _ in range(2):
        for tb, jb in zip(ts, js, strict=True):
            n += 1
            np.testing.assert_array_equal(tb.input_nodes.numpy(),
                                          np.asarray(jb.input_nodes))
            np.testing.assert_array_equal(tb.labels.numpy(),
                                          np.asarray(jb.labels))
            for tk, jk in zip(tb.blocks, jb.blocks, strict=True):
                np.testing.assert_array_equal(tk.edge_src.numpy(),
                                              np.asarray(jk.edge_src))
                np.testing.assert_array_equal(tk.edge_dst.numpy(),
                                              np.asarray(jk.edge_dst))
                assert (tk.num_src, tk.num_dst, tk.num_edges,
                        tk.src_cap, tk.dst_cap) == (
                    int(jk.num_src), int(jk.num_dst), int(jk.num_edges),
                    jk.src_cap, jk.dst_cap)
                assert tk.edge_src.dtype == tk.edge_dst.dtype
                assert str(tk.edge_dst.dtype) == "torch.int32"
    assert n == 2 * len(ts)


def test_seed_batches_then_sample_batch_equal_iteration(small_graph):
    g, nodes = small_graph, small_graph.train_nodes()

    def sampler():
        return tnb.NeighborSampler(g, nodes, [3, 4], 40, seed=8, device="cpu")

    stepped = sampler()
    batches = [stepped.sample_batch(s) for s in stepped.seed_batches()]
    assert len(batches) == len(stepped)
    for tb, ib in zip(batches, sampler(), strict=True):
        np.testing.assert_array_equal(tb.input_nodes.numpy(),
                                      ib.input_nodes.numpy())
        for tk, ik in zip(tb.blocks, ib.blocks, strict=True):
            np.testing.assert_array_equal(tk.edge_src.numpy(),
                                          ik.edge_src.numpy())


@pytest.mark.parametrize("call", ["sampler", "block", "gather"])
def test_device_is_never_defaulted(small_graph, call):
    # The port runs on CUDA unless the caller asks for the CPU, so a
    # function that places tensors has no CPU default to fall back on.
    from occ_gnn_tpu_torch.ops.blocks import block_from_numpy
    from occ_gnn_tpu_torch.training import gather_features

    with pytest.raises(TypeError, match="device"):
        if call == "sampler":
            tnb.NeighborSampler(small_graph, small_graph.train_nodes(),
                                [2], 8)
        elif call == "block":
            block_from_numpy(np.zeros(2, np.int64), np.zeros(2, np.int64),
                             1, 1, 4, 2, 2)
        else:
            gather_features(small_graph.features, np.arange(3))


def test_pad_to_overflow_raises():
    np.testing.assert_array_equal(pad_to(np.arange(3), 5, -1),
                                  [0, 1, 2, -1, -1])
    with pytest.raises(ValueError, match="capacity overflow"):
        pad_to(np.arange(6), 5, -1)
