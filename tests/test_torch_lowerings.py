"""The split path's lowerings in the port against the JAX package's:
``OCC_DENSE_AGG=tiled`` and the four ``OCC_DEVICE_SAMPLE`` samplers
(``randint``, ``bitsf32``, ``bitsf32_dk``, ``window`` with its doubled
CSR).

The tiled aggregation sums the same rows in the same order as the
unrolled one, so it must equal it bit for bit. The samplers' draws come
from torch's generator and JAX's threefry, which cannot agree, so they are
compared as tests/test_device_innermost.py compares JAX's: exactly where
every dst's degree is at most the fanout (every lowering then takes the
adjacency in order), structurally and for uniformity elsewhere.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occ_gnn_tpu.cache import CachePlan as JaxCachePlan
from occ_gnn_tpu.ops import config as jcfg
from occ_gnn_tpu.parallel import split as jsplit
from occ_gnn_tpu.parallel.model import make_device_csr as jax_device_csr
from occ_gnn_tpu.sampling.native import NativeSplitSampler as JaxNative
from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.ops import config as tcfg
from occ_gnn_tpu_torch.parallel import split as tsplit
from occ_gnn_tpu_torch.parallel.model import (
    SplitSAGE,
    make_device_csr,
    make_split_forward,
)
from occ_gnn_tpu_torch.parallel.split import (
    WINDOW_PAD,
    SplitLayer,
    local_aggregate_dense,
    synthesize_device_innermost,
)
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
from occ_gnn_tpu_torch.sampling.slicer import SplitSampler

GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
IMPLS = ("randint", "bitsf32", "bitsf32_dk", "window")
# chi-square critical value, 6 degrees of freedom, p = 0.001
CHI2_6DF_P001 = 22.458


@pytest.fixture(scope="module")
def graph():
    return random_graph(**GRAPH_KW)


@contextlib.contextmanager
def _impl(name, *, dense_agg=None):
    """Both packages under one device-sample (or dense-agg) lowering."""
    which = "dense_agg" if dense_agg else "device_sample"
    value = dense_agg or name
    olds = [getattr(m, f"{which}_impl")() for m in (jcfg, tcfg)]
    for m in (jcfg, tcfg):
        getattr(m, f"set_{which}_impl")(value)
    try:
        yield
    finally:
        for m, old in zip((jcfg, tcfg), olds):
            getattr(m, f"set_{which}_impl")(old)


# -- OCC_DENSE_AGG=tiled -----------------------------------------------------


def test_dense_agg_tiled_equals_unrolled_and_jax(graph, small_graph,
                                                 monkeypatch):
    """Tiles of 24 rows over a dst frame of more: the forward equals the
    unrolled one bit for bit, the backward too, and both equal JAX's
    tiled lowering."""
    g = graph
    pmap = np.zeros(g.num_nodes, np.int32)
    ts = SplitSampler(g, g.train_nodes(), pmap, 1, [4, 3], 32, seed=3,
                      device="cpu")
    lyr = next(iter(ts)).layers[0].partition(0)
    K, D = lyr.nbr_idx.shape
    assert D > 24 and D % 24  # several tiles, the last one short
    rng = np.random.default_rng(1)
    x = rng.standard_normal((lyr.src_cap, 16)).astype(np.float32)
    x[-1] = 0.0  # the reserved zero row
    w = rng.standard_normal((D, 16)).astype(np.float32)
    monkeypatch.setattr(tsplit, "DENSE_TILE", 24)
    monkeypatch.setattr(jsplit, "_DENSE_TILE", 24)
    outs, grads = {}, {}
    for impl in ("unrolled", "tiled"):
        with _impl(None, dense_agg=impl):
            xt = torch.from_numpy(x).requires_grad_()
            out = local_aggregate_dense(xt, lyr.nbr_idx)
            (out * torch.from_numpy(w)).sum().backward()
            outs[impl], grads[impl] = out.detach().numpy(), xt.grad.numpy()
            jout = np.asarray(jsplit.local_aggregate_dense(
                jnp.asarray(x), jnp.asarray(lyr.nbr_idx.numpy())))
        np.testing.assert_allclose(outs[impl], jout, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(outs["tiled"], outs["unrolled"])
    np.testing.assert_array_equal(grads["tiled"], grads["unrolled"])


# -- OCC_DEVICE_SAMPLE -------------------------------------------------------


def _device_batches(g, jg, fanouts, seed=3):
    """The first batch of both packages' native device-innermost samplers
    at P = 1, same seed."""
    pmap = np.zeros(g.num_nodes, np.int32)
    ts = NativeSplitSampler(g, g.train_nodes(), pmap, 1, fanouts, 32,
                            seed=seed, cache=CachePlan(g, pmap, 1, 1.0,
                                                       refresh_cap=8),
                            num_workers=1, innermost="device", device="cpu")
    js = JaxNative(jg, jg.train_nodes(), pmap, 1, fanouts, 32, seed=seed,
                   cache=JaxCachePlan(jg, pmap, 1, 1.0, refresh_cap=8),
                   num_workers=1, innermost="device")
    nodes = g.train_nodes()[:32]
    tb, jb = ts.sample_batch(nodes), js.sample_batch(nodes)
    ts.close()
    js.close()
    return tb, jb


@pytest.mark.parametrize("impl", IMPLS)
def test_layer_bit_identical_to_jax_low_degree(graph, small_graph, impl):
    """deg <= fanout: every lowering takes the adjacency in order, so the
    synthesized layer equals JAX's under the same lowering bit for bit
    (whatever the generators draw)."""
    fanouts = [int(np.diff(graph.indptr).max())] * 2
    tb, jb = _device_batches(graph, small_graph, fanouts)
    with _impl(impl):
        csr = make_device_csr(graph, "cpu")
        jcsr = jax_device_csr(small_graph)
        np.testing.assert_array_equal(csr[1].numpy(), np.asarray(jcsr[1]))
        l0 = tb.layers[0].partition(0)
        syn = synthesize_device_innermost(
            l0, csr[0], csr[1], torch.Generator().manual_seed(0))
        jl = jb.layers[0]
        jsyn = jsplit.synthesize_device_innermost(
            jsplit.SplitLayer(dst_global=jl.dst_global[0],
                              src_cap=jl.src_cap, dst_cap=jl.dst_cap,
                              out_cap=jl.out_cap, fanout=jl.fanout),
            jcsr[0], jcsr[1], jax.random.PRNGKey(0))
    for f in ("nbr_idx", "owned_idx", "owned_deg", "self_idx",
              "owned_mask"):
        got, want = getattr(syn, f).numpy(), np.asarray(getattr(jsyn, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert int(syn.num_owned) == int(jsyn.num_owned)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_bit_identical_to_host_low_degree(graph, impl):
    """The split forward through each lowering's synthesized layer 0
    equals the host-innermost forward at deg <= fanout."""
    g = graph
    pmap = np.zeros(g.num_nodes, np.int32)
    fanouts = [int(np.diff(g.indptr).max())] * 2
    samplers = [NativeSplitSampler(
        g, g.train_nodes(), pmap, 1, fanouts, 32, seed=5,
        cache=CachePlan(g, pmap, 1, 1.0, refresh_cap=8), num_workers=1,
        innermost=inner, device="cpu") for inner in ("host", "device")]
    nodes = g.train_nodes()[:32]
    bh, bd = (s.sample_batch(nodes) for s in samplers)
    model = SplitSAGE(g.feature_dim, 16, g.num_classes, 2,
                      generator=torch.Generator().manual_seed(1))
    frames = SplitFeatureCache(samplers[0].cache_plan, device="cpu").frames
    with _impl(impl):
        ld = make_split_forward(model, csr=make_device_csr(g, "cpu"))(
            bd, frames, sample_generator=torch.Generator().manual_seed(7))
    lh = make_split_forward(model)(bh, frames)
    np.testing.assert_array_equal(lh.numpy(), ld.numpy())
    for s in samplers:
        s.close()


def _layer(targets, g, K):
    D = len(targets)
    return SplitLayer(dst_global=torch.as_tensor(targets, dtype=torch.int32),
                      src_cap=g.num_nodes + 1, dst_cap=D, out_cap=D,
                      fanout=K)


def test_bitsf32_dk_equals_bitsf32(graph):
    """Only the order of the CSR reads differs: the same generator state
    gives the same layer."""
    deg = np.diff(graph.indptr)
    lyr = _layer(np.flatnonzero(deg > 3)[:200], graph, 3)
    layers = []
    for impl in ("bitsf32", "bitsf32_dk"):
        with _impl(impl):
            csr = make_device_csr(graph, "cpu")
            layers.append(synthesize_device_innermost(
                lyr, csr[0], csr[1], torch.Generator().manual_seed(4)))
    np.testing.assert_array_equal(layers[0].nbr_idx.numpy(),
                                  layers[1].nbr_idx.numpy())


@pytest.mark.parametrize("impl", ["bitsf32", "bitsf32_dk"])
def test_bits_draws_are_uniform_in_neighbours(graph, impl):
    """4000 dst rows of one node of degree 7, fanout 3: every draw is a
    neighbour, and the 12,000 draws fall on the 7 positions uniformly
    (chi-square, p = 0.001)."""
    g = graph
    deg = np.diff(g.indptr)
    v = int(np.nonzero(deg == 7)[0][0])
    row = g.indices[g.indptr[v]:g.indptr[v + 1]]
    assert np.unique(row).shape[0] == 7  # positions tell apart by value
    with _impl(impl):
        csr = make_device_csr(g, "cpu")
        syn = synthesize_device_innermost(_layer([v] * 4000, g, 3), csr[0],
                                          csr[1],
                                          torch.Generator().manual_seed(3))
    drawn = syn.nbr_idx[1:].numpy().ravel()
    assert np.isin(drawn, row).all()
    counts = np.array([(drawn == u).sum() for u in row])
    expected = 12_000 / 7
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < CHI2_6DF_P001, (counts, chi2)


def test_window_draws_uniform_marginals_without_repeats(graph):
    """deg > fanout under ``window``, as JAX's
    tests/test_device_innermost.py:322-370: every draw comes from the
    dst's adjacency, a window never repeats a neighbour, and each
    neighbour's frequency over 400 draws is K/deg within 5 sigma."""
    g = graph
    K = 3
    indptr, indices = g.indptr, g.indices
    deg = np.diff(indptr)
    uniq = np.array([len(set(indices[indptr[v]:indptr[v + 1]].tolist()))
                     == deg[v] for v in range(g.num_nodes)])
    targets = np.flatnonzero((deg > K) & uniq)[:8]
    assert targets.size > 0
    counts = {int(v): np.zeros(deg[v], np.int64) for v in targets}
    trials = 400
    with _impl("window"):
        csr = make_device_csr(g, "cpu")
        lyr = _layer(targets, g, K)
        gen = torch.Generator().manual_seed(0)
        for _ in range(trials):
            nbr = synthesize_device_innermost(lyr, csr[0], csr[1],
                                              gen).nbr_idx.numpy()
            for d, v in enumerate(targets):
                adj = indices[indptr[v]:indptr[v + 1]]
                drawn = nbr[1:, d]
                assert len(set(drawn.tolist())) == K
                for u in drawn:
                    pos = np.flatnonzero(adj == u)
                    assert pos.size > 0
                    counts[int(v)][pos[0]] += 1
    for v in targets:
        freq = counts[int(v)] / trials
        expect = K / deg[v]
        tol = 5 * np.sqrt(expect * (1 - expect) / trials)
        assert np.all(np.abs(freq - expect) < tol), (v, freq, expect, tol)


def test_csr_layouts_are_tagged_and_checked(graph):
    """The CSR carries its layout; a lowering refuses the other one, and
    an untagged array."""
    with _impl("randint"):
        plain = make_device_csr(graph, "cpu")
    with _impl("window"):
        doubled = make_device_csr(graph, "cpu")
    assert plain[1].csr_layout == "plain"
    assert doubled[1].csr_layout == "doubled"
    assert doubled[1].shape[0] == 2 * graph.num_edges + WINDOW_PAD
    lyr = _layer([0, 1, 2], graph, 3)
    gen = torch.Generator().manual_seed(0)
    with _impl("window"), pytest.raises(ValueError, match="doubled CSR"):
        synthesize_device_innermost(lyr, plain[0], plain[1], gen)
    for impl in ("randint", "bitsf32", "bitsf32_dk"):
        with _impl(impl), pytest.raises(ValueError, match="plain CSR"):
            synthesize_device_innermost(lyr, doubled[0], doubled[1], gen)
    with pytest.raises(ValueError, match="untagged"):
        synthesize_device_innermost(lyr, plain[0], plain[1].clone(), gen)


def test_window_fanout_above_pad_raises(graph):
    with _impl("window"):
        csr = make_device_csr(graph, "cpu")
        with pytest.raises(ValueError, match="pads the doubled CSR by 1024"):
            synthesize_device_innermost(_layer([0], graph, WINDOW_PAD + 1),
                                        csr[0], csr[1],
                                        torch.Generator().manual_seed(0))


def test_window_csr_int32_overflow_raises():
    class Big:
        num_edges, num_nodes = 2**30, 10
        indptr = np.array([0, 2**30])
        indices = np.zeros(0, np.int32)

    Big.indices = np.broadcast_to(np.int32(0), (2**30,))
    with _impl("window"), pytest.raises(ValueError, match="overflows int32"):
        make_device_csr(Big(), "cpu")
