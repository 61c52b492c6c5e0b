"""On-device innermost sampling in the port.

Where every dst's in-degree <= fanout the host path takes all neighbours
in adjacency order and so does the synthesis: the synthesized layer, and
the forward through it, are bit-identical to the host-built layer of the
port and of the JAX package. Where deg > fanout the draws cannot match
JAX's (threefry against torch's generator), so they are checked
structurally and for uniformity (chi-square). The pattern of
tests/test_device_innermost.py.
"""

import numpy as np
import pytest
import torch

from occ_gnn_tpu.cache import CachePlan as JaxCachePlan
from occ_gnn_tpu.data import partition_graph
from occ_gnn_tpu.sampling.native import NativeSplitSampler as JaxNative
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.parallel.model import (
    SplitSAGE,
    make_device_csr,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.parallel.split import (
    SplitLayer,
    synthesize_device_innermost,
)
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler

GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
# chi-square critical value, 6 degrees of freedom, p = 0.001
CHI2_6DF_P001 = 22.458


@pytest.fixture(scope="module")
def graph():
    return random_graph(**GRAPH_KW)


def _samplers(g, parts, pmap, fanouts, seed=3):
    out = []
    for innermost in ("host", "device"):
        plan = CachePlan(g, pmap, parts, 1.0, refresh_cap=8)
        out.append(NativeSplitSampler(
            g, g.train_nodes(), pmap, parts, fanouts, 32, seed=seed,
            cache=plan, num_workers=1, innermost=innermost, device="cpu"))
    return out


@pytest.mark.parametrize("parts", [1, 4])
def test_synthesized_layer_bit_identical_low_degree(graph, small_graph,
                                                    parts):
    g = graph
    pmap = (np.zeros(g.num_nodes, np.int32) if parts == 1 else
            partition_graph(small_graph, parts, mode="greedy", attach=False))
    fanouts = [int(np.diff(g.indptr).max())] * 2
    host, dev = _samplers(g, parts, pmap, fanouts)
    jax_host = JaxNative(small_graph, small_graph.train_nodes(), pmap, parts,
                         fanouts, 32, seed=3,
                         cache=JaxCachePlan(small_graph, pmap, parts, 1.0,
                                            refresh_cap=8),
                         num_workers=1, innermost="host")
    nodes = g.train_nodes()[:32]
    bh, bd, bj = (s.sample_batch(nodes) for s in (host, dev, jax_host))
    csr = make_device_csr(g, "cpu")
    l0h, l0d = bh.layers[0], bd.layers[0]
    assert l0d.device_sampled and l0d.dst_global.dtype == torch.int32
    gen = torch.Generator().manual_seed(0)  # unused when deg <= fanout
    for p in range(parts):
        syn = synthesize_device_innermost(l0d.partition(p), csr[0], csr[1],
                                          gen)
        D = syn.nbr_idx.shape[1]
        host_nbr = l0h.nbr_idx[p].numpy()
        # The device sampler shrinks dst_cap to the owned cap; the host's
        # extra columns are pure zero-row padding.
        assert (host_nbr[:, D:] == l0h.src_cap - 1).all()
        np.testing.assert_array_equal(syn.nbr_idx.numpy(), host_nbr[:, :D])
        np.testing.assert_array_equal(
            syn.nbr_idx.numpy(), np.asarray(bj.layers[0].nbr_idx[p])[:, :D])
        for f in ("owned_idx", "owned_deg", "self_idx", "owned_mask"):
            a = getattr(syn, f).numpy()
            np.testing.assert_array_equal(a, getattr(l0h, f)[p].numpy(),
                                          err_msg=f)
            assert a.dtype == getattr(l0h, f).numpy().dtype, f
        assert int(syn.num_owned) == int(l0h.num_owned[p])
    for lh, ld in zip(bh.layers[1:], bd.layers[1:]):
        np.testing.assert_array_equal(lh.nbr_idx.numpy(), ld.nbr_idx.numpy())
    for s in (host, dev, jax_host):
        s.close()


def test_forward_bit_identical_low_degree(graph):
    g = graph
    pmap = np.zeros(g.num_nodes, np.int32)
    fanouts = [int(np.diff(g.indptr).max())] * 2
    host, dev = _samplers(g, 1, pmap, fanouts, seed=5)
    nodes = g.train_nodes()[:32]
    bh, bd = host.sample_batch(nodes), dev.sample_batch(nodes)
    model = SplitSAGE(g.feature_dim, 16, g.num_classes, 2,
                      generator=torch.Generator().manual_seed(1))
    frames = SplitFeatureCache(host.cache_plan, device="cpu").frames
    lh = make_split_forward(model)(bh, frames)
    ld = make_split_forward(model, csr=make_device_csr(g, "cpu"))(
        bd, frames, sample_generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(lh.numpy(), ld.numpy())
    host.close()
    dev.close()


def test_sampled_draws_structurally_valid(graph):
    """deg > fanout: every used slot is a neighbour of its dst, unused
    slots hold the zero row, and owned_deg is min(deg, fanout) + 1."""
    g = graph
    pmap = np.zeros(g.num_nodes, np.int32)
    _, dev = _samplers(g, 1, pmap, [3, 3], seed=11)
    l0 = dev.sample_batch(g.train_nodes()[:32]).layers[0].partition(0)
    csr = make_device_csr(g, "cpu")
    syn = synthesize_device_innermost(l0, csr[0], csr[1],
                                      torch.Generator().manual_seed(2))
    deg = np.diff(g.indptr)
    nbr, odeg = syn.nbr_idx.numpy(), syn.owned_deg.numpy()
    dg = l0.dst_global.numpy()
    zero = l0.src_cap - 1
    assert (deg[dg[dg >= 0]] > 3).any()
    for d, v in enumerate(dg):
        if v < 0:
            assert (nbr[:, d] == zero).all()
            continue
        take = min(deg[v], 3)
        assert nbr[0, d] == v
        adj = set(g.indices[g.indptr[v]:g.indptr[v + 1]])
        assert all(nbr[k, d] in adj for k in range(1, take + 1))
        assert (nbr[take + 1:, d] == zero).all()
        if d < odeg.shape[0]:
            assert odeg[d] == take + 1
    dev.close()


def test_draws_are_uniform_over_the_adjacency_row(graph):
    """4000 dst rows of one node of degree 7, fanout 3: 12,000 draws fall
    on the 7 neighbour positions uniformly (chi-square, p = 0.001)."""
    g = graph
    deg = np.diff(g.indptr)
    v = int(np.nonzero(deg == 7)[0][0])
    row = g.indices[g.indptr[v]:g.indptr[v + 1]]
    assert np.unique(row).shape[0] == 7  # positions tell apart by value
    lyr = SplitLayer(dst_global=torch.full((4000,), v, dtype=torch.int32),
                     src_cap=g.num_nodes + 1, dst_cap=4000, out_cap=4000,
                     fanout=3)
    csr = make_device_csr(g, "cpu")
    syn = synthesize_device_innermost(lyr, csr[0], csr[1],
                                      torch.Generator().manual_seed(3))
    drawn = syn.nbr_idx[1:].numpy().ravel()
    counts = np.array([(drawn == u).sum() for u in row])
    assert counts.sum() == 12_000
    expected = 12_000 / 7
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < CHI2_6DF_P001, (counts, chi2)


def test_device_innermost_trains(graph):
    g = graph
    pmap = np.zeros(g.num_nodes, np.int32)
    cache = SplitFeatureCache(CachePlan(g, pmap, 1, 1.0, refresh_cap=8),
                              device="cpu")
    dev = NativeSplitSampler(g, g.train_nodes(), pmap, 1, [5, 5], 64, seed=2,
                             cache=cache, num_workers=1, innermost="device",
                             device="cpu")
    model = SplitSAGE(g.feature_dim, 32, g.num_classes, 2,
                      generator=torch.Generator().manual_seed(0))
    step = make_split_train_step(model, torch.optim.Adam(model.parameters(),
                                                         lr=1e-2),
                                 csr=make_device_csr(g, "cpu"))
    gen = torch.Generator().manual_seed(9)
    losses = [float(step(b, cache.frames, sample_generator=gen)[0])
              for _ in range(4) for b in dev]
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="sample_generator"):
        step(dev.sample_batch(g.train_nodes()[:64]), cache.frames)
    dev.close()


def test_device_innermost_requires_a_replicated_cache(graph):
    g = graph
    pmap = np.zeros(g.num_nodes, np.int32)
    plan = CachePlan(g, pmap, 1, 0.5, refresh_cap=8)
    with pytest.raises(ValueError, match="replicated"):
        NativeSplitSampler(g, g.train_nodes(), pmap, 1, [5, 5], 32,
                           cache=plan, innermost="device", device="cpu")
    with pytest.raises(SystemExit, match="replicated cache"):
        train.main(["--graph", "community", "--mode", "split", "--cpu",
                    "--num-nodes", "400", "--cache-per", "0.25",
                    "--innermost", "device", "--fan-out", "3,3"])


def test_device_csr_is_int32_and_bounded(graph):
    indptr, indices = make_device_csr(graph, "cpu")
    assert indptr.dtype == indices.dtype == torch.int32
    np.testing.assert_array_equal(indices.numpy(), graph.indices)

    class Huge:
        num_edges, num_nodes = 2**31, 10

    with pytest.raises(ValueError, match="2\\^31"):
        make_device_csr(Huge(), "cpu")
