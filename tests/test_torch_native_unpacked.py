"""The unpacked native feed (``NativeSplitSampler(packed=False)``, JAX
``sampling/native.py:392-433,634-712``) against the packed one: one pinned
buffer and one copy a field in place of one arena, the same batches.

Two samplers of the same seed run two epochs each, one packed and one
not: every field of every batch, its labels and host ids, and every cache
tail the workers gathered must be equal, in delivery order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import partition_graph, random_graph
from occ_gnn_tpu_torch.ops import dense_gather_sum as dgs
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler

GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
CASES = {
    # A refreshing cache: tails every batch, all P rows emitted.
    "refreshing cache, P = 2": dict(P=2, pct=0.25, emit=None,
                                    innermost="host"),
    # One process's row of a P = 2 batch.
    "rank 1 of 2": dict(P=2, pct=0.25, emit=(1, 2), innermost="host"),
    # A replicated cache with layer 0 sampled on the device: dst_global.
    "device innermost": dict(P=1, pct=1.0, emit=None, innermost="device"),
    # No cache: the input ids travel (and the COO with them).
    "no cache": dict(P=2, pct=None, emit=None, innermost="host"),
    # Split GAT's feed: the scatter plans past layer 0, host and device
    # innermost.
    "scatter plans, P = 2": dict(P=2, pct=0.25, emit=None, innermost="host",
                                 plans=True),
    "scatter plans, device innermost": dict(P=1, pct=1.0, emit=None,
                                            innermost="device", plans=True),
}


def _run(g, pmap, case, packed):
    """Every batch of two epochs with the tails the cache was given."""
    cache = None
    if case["pct"] is not None:
        cache = SplitFeatureCache(
            CachePlan(g, pmap, case["P"], case["pct"], refresh_cap=64),
            device="cpu",
            partitions=case["emit"] or (0, case["P"]))
        tails = []
        apply = cache.apply_tail_gathered

        def recording(buf, counts):
            lo = (case["emit"] or (0,))[0]
            tails.append([buf[i, :counts[lo + i]].clone()
                          for i in range(buf.shape[0])])
            apply(buf, counts)

        cache.apply_tail_gathered = recording
    sampler = NativeSplitSampler(
        g, g.train_nodes(), pmap, case["P"], [4, 3], 32, seed=3,
        cache=cache, num_workers=2, innermost=case["innermost"],
        emit_range=case["emit"], emit_coo=case["pct"] is None,
        packed=packed, scatter_plans=case.get("plans", False), device="cpu")
    batches = [b for _ in range(2) for b in sampler]
    sampler.close()
    return batches, (tails if cache is not None else None)


@pytest.mark.parametrize("name", list(CASES))
def test_unpacked_equals_packed_over_two_epochs(name):
    case = CASES[name]
    g = random_graph(**GRAPH_KW)
    pmap = (partition_graph(g, case["P"], mode="greedy") if case["P"] > 1
            else np.zeros(g.num_nodes, np.int32))
    (packed, ptails), (unpacked, utails) = (
        _run(g, pmap, case, flag) for flag in (True, False))
    assert len(packed) == len(unpacked) == 2 * -(-len(g.train_nodes())
                                                  // 32)
    for a, b in zip(packed, unpacked):
        for la, lb in zip(a.layers, b.layers):
            for f in dataclasses.fields(la):
                x, y = getattr(la, f.name), getattr(lb, f.name)
                if f.name == "plan_slots" and x is not None:
                    # Each partition's lists; the tail of slots is unread.
                    assert x.shape == y.shape
                    assert all(dgs.plans_equal(la.partition(p).scatter_plan,
                                               lb.partition(p).scatter_plan)
                               for p in range(x.shape[0]))
                elif isinstance(x, torch.Tensor):
                    assert x.dtype == y.dtype and x.shape == y.shape, f.name
                    assert torch.equal(x, y), f.name
                else:
                    assert x == y, f.name
        for f in ("labels", "target_nodes", "input_nodes"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert torch.equal(x, y), f
        if a.input_nodes_host is not None:
            np.testing.assert_array_equal(a.input_nodes_host,
                                          b.input_nodes_host)
    assert (case["innermost"] == "device") == packed[0].layers[0].device_sampled
    assert (packed[0].layers[1].plan_slots is not None) == case.get("plans",
                                                                    False)
    if case["pct"] == 0.25:
        assert len(ptails) == len(utails) == len(packed)
        assert sum(t.shape[0] for tail in ptails for t in tail) > 0
        for ta, tb in zip(ptails, utails):
            for x, y in zip(ta, tb):
                assert torch.equal(x, y)
