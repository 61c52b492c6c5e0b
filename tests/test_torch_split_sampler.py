"""The port's split samplers against the JAX package's: the numpy
``SplitSampler`` and the C++ ``NativeSplitSampler`` give the same batches
field for field for one seed, the capacity plans and their measurement
are equal, overflows raise in turn with the same messages, and the P = 1
partition map is what ``partition_graph`` gives in every mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occ_gnn_tpu.cache import CachePlan as JaxCachePlan
from occ_gnn_tpu.cache import SplitFeatureCache as JaxCache
from occ_gnn_tpu.data import partition_graph
from occ_gnn_tpu.data import random_graph as jax_random_graph
from occ_gnn_tpu.sampling import slicer as jsl
from occ_gnn_tpu.sampling.native import NativeSplitSampler as JaxNative
from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.sampling import slicer as tsl
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler, _BufferPool
from occ_gnn_tpu_torch.train import _one_partition_map

P = 4
FIELDS = ("edge_src", "edge_dst", "push_idx", "recv_idx", "owned_idx",
          "owned_deg", "self_idx", "owned_mask", "num_owned", "nbr_idx",
          "dst_global")


def _np(a):
    if a is None:
        return None
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_batches_equal(jb, tb):
    """Every field of a JAX SplitBatch equals the port's, exactly."""
    assert len(jb.layers) == len(tb.layers)
    for l, (la, lb) in enumerate(zip(jb.layers, tb.layers)):
        for f in FIELDS:
            a, b = _np(getattr(la, f)), _np(getattr(lb, f))
            assert (a is None) == (b is None), (l, f)
            if a is not None:
                assert a.dtype == b.dtype, (l, f, a.dtype, b.dtype)
                np.testing.assert_array_equal(a, b, err_msg=f"{l} {f}")
        for f in ("src_cap", "dst_cap", "out_cap", "fanout"):
            assert getattr(la, f) == getattr(lb, f), (l, f)
    for f in ("input_nodes", "labels", "target_nodes"):
        a, b = _np(getattr(jb, f)), _np(getattr(tb, f))
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_nodes=400, avg_degree=4, feature_dim=8, num_classes=4,
              seed=9, power_law=10.0)
    return jax_random_graph(**kw), random_graph(**kw)


@pytest.fixture(scope="module")
def pmap(graphs):
    return partition_graph(graphs[0], P, mode="greedy", attach=False)


def _max_fanout(g):
    return int(np.diff(g.indptr).max())


@pytest.mark.parametrize("parts", [1, P])
def test_numpy_slicer_equals_jax(small_graph, parts):
    """The ``sliced`` pattern of tests/test_split_parallel.py."""
    kw = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
              seed=1)
    tg = random_graph(**kw)
    pm = (np.zeros(tg.num_nodes, np.int32) if parts == 1 else
          partition_graph(small_graph, parts, mode="greedy", attach=False))
    js = jsl.SplitSampler(small_graph, small_graph.train_nodes(), pm, parts,
                          [4, 3], 32, seed=7)
    ts = tsl.SplitSampler(tg, tg.train_nodes(), pm, parts, [4, 3], 32,
                          seed=7, device="cpu")
    assert ts.caps == js.caps
    nodes = tg.train_nodes()[:32]
    jraw, traw = js._sample_raw(nodes), ts._sample_raw(nodes)
    assert_batches_equal(js.slice_raw(jraw), ts.slice_raw(traw))
    # the iterator draws the same permutation and batches
    for jb, tb in zip(js, ts):
        assert_batches_equal(jb, tb)


def _native_pair(graphs, pmap, fanouts, parts=P, jax_cache=None,
                 cache=None, **kw):
    jg, tg = graphs
    pm = pmap if parts == P else np.zeros(tg.num_nodes, np.int32)
    nat_j = JaxNative(jg, jg.train_nodes(), pm, parts, fanouts, 32,
                      cache=jax_cache, **kw)
    nat_t = NativeSplitSampler(tg, tg.train_nodes(), pm, parts, fanouts, 32,
                               cache=cache, device="cpu", **kw)
    return nat_j, nat_t


@pytest.mark.parametrize("case", [
    dict(name="no cache, full emission", pct=None, emit_coo=True),
    dict(name="no cache, trimmed", pct=None),
    dict(name="refreshing cache", pct=0.08, emit_coo=True, emit_input=True),
    dict(name="static cache", pct=0.5),
    dict(name="replicated, host innermost", pct=1.0, emit_coo=True),
    dict(name="replicated, device innermost", pct=1.0, innermost="device"),
], ids=lambda c: c["name"])
@pytest.mark.parametrize("parts", [1, P])
def test_native_sampler_equals_jax(graphs, pmap, case, parts):
    case = dict(case)
    case.pop("name")
    pct = case.pop("pct")
    jg, tg = graphs
    pm = pmap if parts == P else np.zeros(tg.num_nodes, np.int32)
    fanouts = [_max_fanout(tg)] * 2
    caps = jsl.plan_split_capacities(32, fanouts, tg.num_nodes, parts)
    jplan = tplan = None
    if pct is not None:
        jplan = JaxCachePlan(jg, pm, parts, pct,
                             refresh_cap=caps["frame_caps"][0])
        tplan = CachePlan(tg, pm, parts, pct,
                          refresh_cap=caps["frame_caps"][0])
    nat_j, nat_t = _native_pair(graphs, pmap, fanouts, parts, jplan, tplan,
                                capacities=caps, seed=1, num_workers=2,
                                **case)
    assert nat_t.caps == nat_j.caps
    for jb, tb in zip(nat_j, nat_t):
        assert_batches_equal(jb, tb)
    assert nat_t._arena_words == nat_j._arena_words
    assert nat_t.stats()["samples"] == len(nat_t)
    nat_j.close()
    nat_t.close()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_refresh_lists_and_gathered_tails_equal_jax(graphs, pmap, bf16):
    jg, tg = graphs
    fanouts = [_max_fanout(tg)] * 2
    caps = jsl.plan_split_capacities(32, fanouts, tg.num_nodes, P)
    jcache = JaxCache(JaxCachePlan(jg, pmap, P, 0.05,
                                   refresh_cap=caps["frame_caps"][0]),
                      dtype=jnp.bfloat16 if bf16 else None)
    tcache = SplitFeatureCache(CachePlan(tg, pmap, P, 0.05,
                                         refresh_cap=caps["frame_caps"][0]),
                               dtype=torch.bfloat16 if bf16 else torch.float32,
                               device="cpu")
    nat_j, nat_t = _native_pair(graphs, pmap, fanouts, P, jcache, tcache,
                                capacities=caps, seed=4, num_workers=1)
    assert nat_j.gather_tail and nat_t.gather_tail
    nodes = tg.train_nodes()
    for i in range(3):
        batch = np.ascontiguousarray(nodes[i * 32:(i + 1) * 32])
        nat_j._submit(batch)
        nat_t._submit(batch)
        _, jb = nat_j._pop_packed()
        _, tb = nat_t._pop_packed()
        refresh = tb._refresh_nodes
        np.testing.assert_array_equal(refresh, jb._refresh_nodes)
        jt = np.asarray(jb._tail_feats)
        tt = tb._tail_feats
        for p in range(P):
            k = int((refresh[p] >= 0).sum())
            if bf16:
                np.testing.assert_array_equal(
                    tt[p, :k].view(torch.int16).numpy().view(np.uint16),
                    jt[p, :k].view(np.uint16))
            else:
                np.testing.assert_array_equal(tt[p, :k].numpy(), jt[p, :k])
                np.testing.assert_array_equal(
                    tt[p, :k].numpy(), tg.features[refresh[p, :k]])
    nat_j.close()
    nat_t.close()


def test_capacity_plans_equal_jax(graphs, pmap):
    jg, tg = graphs
    for fanouts in ([3, 3], [4, -1], [5, 2, 3]):
        for parts, skew in ((1, None), (P, None), (P, 1.5)):
            assert tsl.plan_split_capacities(
                64, fanouts, tg.num_nodes, parts, skew=skew,
                num_edges=tg.num_edges) == jsl.plan_split_capacities(
                64, fanouts, jg.num_nodes, parts, skew=skew,
                num_edges=jg.num_edges)
        assert tsl.default_deg_caps(fanouts) == jsl.default_deg_caps(fanouts)
    owner = np.random.default_rng(0).integers(0, P, 300)
    for a, b in zip(tsl.rank_within_owner(owner, P),
                    jsl.rank_within_owner(owner, P)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pct", [None, 0.1, 1.0])
def test_measured_and_scaled_capacities_equal_jax(graphs, pmap, pct):
    jg, tg = graphs
    fanouts = [3, 3]
    jplan = tplan = None
    if pct is not None:
        jplan = JaxCachePlan(jg, pmap, P, pct, refresh_cap=500)
        tplan = CachePlan(tg, pmap, P, pct, refresh_cap=500)
    tc = tsl.measure_split_capacities(tg, tg.train_nodes(), pmap, P,
                                      fanouts, 64, seed=3, cache_plan=tplan)
    jc = jsl.measure_split_capacities(jg, jg.train_nodes(), pmap, P,
                                      fanouts, 64, seed=3, cache_plan=jplan)
    assert tc == jc
    assert tsl.scale_capacities(tc, 1.5) == jsl.scale_capacities(jc, 1.5)


def test_overflow_raises_in_turn_with_jax_message(graphs, pmap):
    jg, tg = graphs
    caps = jsl.plan_split_capacities(64, [3, 3], tg.num_nodes, P, skew=0.05)
    nat_j, nat_t = _native_pair(graphs, pmap, [3, 3], P, capacities=caps,
                                seed=3, num_workers=1)
    errors = []
    for nat in (nat_j, nat_t):
        with pytest.raises(ValueError, match="capacity overflow") as e:
            nat.sample_batch(tg.train_nodes()[:64])
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    nat_j.close()
    nat_t.close()
    # The numpy slicer raises the same message as JAX's numpy slicer.
    js = jsl.SplitSampler(jg, jg.train_nodes(), pmap, P, [3, 3], 64,
                          capacities=caps, seed=3)
    ts = tsl.SplitSampler(tg, tg.train_nodes(), pmap, P, [3, 3], 64,
                          capacities=caps, seed=3, device="cpu")
    errors = []
    for s in (js, ts):
        with pytest.raises(ValueError, match="overflow") as e:
            s.sample_batch(tg.train_nodes()[:64])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_error_preserves_delivery_order(graphs, pmap):
    """Overflow on batch 1 of 4 over two workers: it raises in its turn
    and the batches after it still arrive in submission order."""
    _, tg = graphs
    caps = jsl.plan_split_capacities(16, [3, 3], tg.num_nodes, P)
    nat = NativeSplitSampler(tg, tg.train_nodes(), pmap, P, [3, 3], 16,
                             capacities=caps, seed=5, num_workers=2,
                             device="cpu")
    nodes = tg.train_nodes()
    batches = [nodes[0:16], nodes[:6 * 16], nodes[16:32], nodes[32:48]]
    for b in batches:
        nat._submit(np.ascontiguousarray(b, dtype=np.int64))
    got0 = nat._pop()
    with pytest.raises(ValueError, match="capacity overflow"):
        nat._pop()
    got2, got3 = nat._pop(), nat._pop()
    for got, sub in ((got0, batches[0]), (got2, batches[2]),
                     (got3, batches[3])):
        t = got.target_nodes.numpy()
        np.testing.assert_array_equal(np.sort(t[t >= 0]),
                                      np.sort(np.unique(sub)))
    nat.close()


@pytest.mark.parametrize("mode", ["greedy", "metis", "random",
                                  "round_robin"])
def test_one_partition_map_equals_partition_graph(graphs, mode):
    jg, tg = graphs
    expected = partition_graph(jg, 1, mode=mode, attach=False)
    got = _one_partition_map(tg)
    assert got.dtype == expected.dtype
    np.testing.assert_array_equal(got, expected)


def test_pooled_buffer_is_reused_only_after_its_copy(monkeypatch):
    """A buffer given back while its copy to the device may still be
    reading it comes out of the pool only once the event recorded after
    that copy has completed (a stand-in event here: no card)."""

    class Event:
        done = False

        def record(self):
            pass

        def query(self):
            return Event.done

    monkeypatch.setattr(torch.cuda, "Event", Event)
    pool = _BufferPool((4,), torch.int32, torch.device("cpu"))
    pool.cuda = True  # events as on CUDA; buffers stay unpinned here
    a = pool.get()
    pool.put(a)
    b = pool.get()
    assert b is not a  # a's copy is still in flight
    Event.done = True
    pool.put(b)
    assert {id(pool.get()), id(pool.get())} == {id(a), id(b)}
