"""The port's graph partitioning against the JAX package's: every mode gives
the same map on the same graph, and the edge cut is computed the same way.
The port builds its own copy of the multilevel partitioner
(``csrc/partition.cpp``) and raises where the JAX package would fall back
to LDG."""

import numpy as np
import pytest

from occ_gnn_tpu.data import block_graph as jax_block_graph
from occ_gnn_tpu.data import partition as jax_partition
from occ_gnn_tpu_torch.data import block_graph, random_graph
from occ_gnn_tpu_torch.data import partition as port_partition

GRAPH_KW = dict(num_nodes=800, num_blocks=4, avg_degree=10,
                cross_fraction=0.05, feature_dim=16, seed=2)


@pytest.fixture(scope="module")
def graphs():
    return jax_block_graph(**GRAPH_KW), block_graph(**GRAPH_KW)


@pytest.mark.parametrize("mode", ["greedy", "metis", "random", "round_robin"])
def test_partition_map_equals_jax(graphs, mode):
    jg, tg = graphs
    expected = jax_partition.partition_graph(jg, 4, mode=mode, seed=3,
                                             attach=False)
    got = port_partition.partition_graph(tg, 4, mode=mode, seed=3)
    assert got.dtype == expected.dtype == np.int32
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(tg.partition_map, got)  # attached
    assert set(np.unique(got)) == {0, 1, 2, 3}


def test_edge_cut_fraction_equals_jax(graphs):
    jg, tg = graphs
    for mode in ("metis", "round_robin"):
        pmap = port_partition.partition_graph(tg, 4, mode=mode, attach=False)
        assert port_partition.edge_cut_fraction(tg, pmap) == \
            jax_partition.edge_cut_fraction(jg, pmap)
    metis = port_partition.partition_graph(tg, 4, mode="metis", attach=False)
    rr = port_partition.partition_graph(tg, 4, mode="round_robin",
                                        attach=False)
    assert (port_partition.edge_cut_fraction(tg, metis)
            < port_partition.edge_cut_fraction(tg, rr))


def test_metis_raises_when_the_partitioner_cannot_build(monkeypatch):
    def broken():
        raise RuntimeError("g++ failed for partition.cpp")

    monkeypatch.setattr(port_partition, "load_partitioner", broken)
    g = random_graph(num_nodes=200, avg_degree=4, feature_dim=4, seed=0)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port_partition.partition_graph(g, 2, mode="metis")
    with pytest.raises(ValueError, match="unknown partition mode"):
        port_partition.partition_graph(g, 2, mode="spectral")
