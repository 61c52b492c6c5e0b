"""The per-slot scatter's plan (``ops/dense_gather_sum.ScatterPlan``) as
the samplers ship it with split GAT's training batches.

The C++ service (``NativeSplitSampler(scatter_plans=True)``, packed and
unpacked, at P = 1 and P = 2 in one process) and the numpy slicer
(``SplitSampler(scatter_plans=True)``) give every dense layer past layer
0 the plan that its plain version ``slots_plan`` makes of its ``nbr``,
partition by partition, in all that the kernel reads (``slots`` up to the
valid count: its tail is unread); layer 0 gets none, and every other field
stays equal to the JAX package's samplers'. A row named by more than 256
slots is listed among the long rows. Without plans (split SAGE and GCN,
inference) the service's arena is JAX's, word for word. The trainer asks
for plans for split GAT alone, and its backward then sums through them.
"""

import numpy as np
import pytest
import torch

from occ_gnn_tpu.data import partition_graph
from occ_gnn_tpu.data import random_graph as jax_random_graph
from occ_gnn_tpu.sampling import slicer as jsl
from occ_gnn_tpu.sampling.native import NativeSplitSampler as JaxNative
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.data import Graph, random_graph
from occ_gnn_tpu_torch.ops import dense_gather_sum as dgs
from occ_gnn_tpu_torch.ops import gat_attention as ga
from occ_gnn_tpu_torch.sampling import native
from occ_gnn_tpu_torch.sampling import slicer as tsl
from test_torch_split_sampler import assert_batches_equal

GRAPH_KW = dict(num_nodes=400, avg_degree=4, feature_dim=8, num_classes=4,
                seed=9, power_law=10.0)
FANOUTS = [3, 3, 3]
BATCH = 32
PLAN_FIELDS = ("plan_offsets", "plan_slots", "plan_long", "plan_num_long")


@pytest.fixture(scope="module")
def graphs():
    return jax_random_graph(**GRAPH_KW), random_graph(**GRAPH_KW)


def _pmap(graphs, parts):
    if parts == 1:
        return np.zeros(GRAPH_KW["num_nodes"], np.int32)
    return partition_graph(graphs[0], parts, mode="greedy", attach=False)


def assert_plans(batch, plans=True):
    """Every dense layer past layer 0 carries, for each partition, the
    plain version's plan of its nbr (and, without ``plans``, none does);
    returns the plans."""
    out = []
    for l, lyr in enumerate(batch.layers):
        fields = [getattr(lyr, f) for f in PLAN_FIELDS]
        if not plans or l == 0 or lyr.nbr_idx is None:
            assert all(f is None for f in fields), l
            continue
        for p in range(lyr.nbr_idx.shape[0]):
            part = lyr.partition(p)
            got = part.scatter_plan
            want = dgs.slots_plan(part.nbr_idx, part.src_cap)
            for name, a, b in zip(dgs.ScatterPlan._fields, got, want):
                assert a.dtype == torch.int32, (l, p, name)
                assert a.shape == b.shape, (l, p, name)
            assert dgs.plans_equal(got, want), (l, p)
            out.append((l, p, got))
    assert out or not plans
    return out


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("parts", [1, 2])
def test_service_plan_equals_plain_version(graphs, parts, packed):
    jg, tg = graphs
    pm = _pmap(graphs, parts)
    caps = jsl.plan_split_capacities(BATCH, FANOUTS, tg.num_nodes, parts)
    kw = dict(capacities=caps, seed=2, num_workers=2)
    nat_j = JaxNative(jg, jg.train_nodes(), pm, parts, FANOUTS, BATCH, **kw)
    nat_t = native.NativeSplitSampler(tg, tg.train_nodes(), pm, parts,
                                      FANOUTS, BATCH, packed=packed,
                                      scatter_plans=True, device="cpu", **kw)
    try:
        n = 0
        for jb, tb in zip(nat_j, nat_t):
            assert_batches_equal(jb, tb)
            n += len(assert_plans(tb))
        assert n == 2 * parts * len(nat_t)  # layers 1 and 2, every batch
    finally:
        nat_j.close()
        nat_t.close()


@pytest.mark.parametrize("parts", [1, 2])
def test_numpy_slicer_plan_equals_plain_version(graphs, parts):
    jg, tg = graphs
    pm = _pmap(graphs, parts)
    js = jsl.SplitSampler(jg, jg.train_nodes(), pm, parts, FANOUTS, BATCH,
                          seed=5)
    ts = tsl.SplitSampler(tg, tg.train_nodes(), pm, parts, FANOUTS, BATCH,
                          seed=5, scatter_plans=True, device="cpu")
    for jb, tb in zip(js, ts):
        assert_batches_equal(jb, tb)
        assert len(assert_plans(tb)) == 2 * parts


def _hub_graph(n=700):
    """Node 0 and one other node are the in-neighbours of every other
    node: a batch of all of them names node 0's row from every column."""
    rng = np.random.default_rng(3)
    indptr = np.zeros(n + 1, np.int64)
    indices = []
    for v in range(n):
        nb = [int(rng.integers(1, n))] if v == 0 else [
            0, int(rng.integers(1, n))]
        indices += nb
        indptr[v + 1] = len(indices)
    return Graph(indptr=indptr, indices=np.asarray(indices, np.int64),
                 features=rng.standard_normal((n, 4)).astype(np.float32),
                 labels=rng.integers(0, 2, n).astype(np.int32),
                 num_classes=2, train_mask=np.ones(n, bool))


@pytest.mark.parametrize("sampler", ["native", "numpy"])
def test_a_row_past_the_span_is_listed(sampler):
    """Without replacement a node of two in-neighbours takes both, so the
    hub's row at layer 1 is named by every column but its own: far more
    than 256 slots, listed as the plan's long row."""
    g = _hub_graph()
    pm = np.zeros(g.num_nodes, np.int32)
    nodes = np.arange(1, g.num_nodes)
    caps = tsl.plan_split_capacities(len(nodes), [2, 2], g.num_nodes, 1)
    # Frames of every node and the zero row: the planner's estimate is
    # for graphs larger than the batch.
    caps["frame_caps"] = [max(c, g.num_nodes + 1) for c in caps["frame_caps"]]
    kw = dict(capacities=caps, seed=0, replace=False, scatter_plans=True,
              device="cpu")
    if sampler == "native":
        s = native.NativeSplitSampler(g, nodes, pm, 1, [2, 2], len(nodes),
                                      num_workers=1, **kw)
    else:
        s = tsl.SplitSampler(g, nodes, pm, 1, [2, 2], len(nodes), **kw)
    batch = s.sample_batch(nodes)
    if sampler == "native":
        s.close()
    (_, _, plan), = assert_plans(batch)
    lyr = batch.layers[1].partition(0)
    counts = torch.bincount(lyr.nbr_idx.reshape(-1).long(),
                            minlength=lyr.src_cap)[:-1]
    hot = torch.nonzero(counts > dgs.SPAN).reshape(-1)
    assert hot.numel() == 1 and counts[hot].item() >= len(nodes) - 1
    assert int(plan.num_long) == 1
    assert plan.long_rows[0].item() == hot.item()
    assert (plan.long_rows[1:] == -1).all()


def test_no_plan_leaves_the_arena_as_jax(graphs):
    """Split SAGE's and GCN's feed: no plan field, JAX's arena words; the
    plans add their four fields a dense layer past layer 0, and nothing
    else."""
    jg, tg = graphs
    pm = _pmap(graphs, 2)
    caps = jsl.plan_split_capacities(BATCH, FANOUTS, tg.num_nodes, 2)
    kw = dict(capacities=caps, seed=2, num_workers=1)
    nat_j = JaxNative(jg, jg.train_nodes(), pm, 2, FANOUTS, BATCH, **kw)
    plain = native.NativeSplitSampler(tg, tg.train_nodes(), pm, 2, FANOUTS,
                                      BATCH, device="cpu", **kw)
    planned = native.NativeSplitSampler(tg, tg.train_nodes(), pm, 2,
                                        FANOUTS, BATCH, scatter_plans=True,
                                        device="cpu", **kw)
    try:
        nodes = tg.train_nodes()[:BATCH]
        assert_batches_equal(nat_j.sample_batch(nodes),
                             plain.sample_batch(nodes))
        assert plain._arena_words == nat_j._arena_words  # JAX's, once used
        assert not any(name.startswith("plan_") for name, _ in plain._layout)
        assert_plans(plain.sample_batch(nodes), plans=False)
        extra = {key: v for key, v in planned._layout.items()
                 if key not in plain._layout}
        assert sorted(extra) == sorted((f, l) for f in PLAN_FIELDS
                                       for l in (1, 2))
        words = sum(int(np.prod(shape)) for _, shape, _ in extra.values())
        assert planned._arena_words == plain._arena_words + words
    finally:
        for s in (nat_j, plain, planned):
            s.close()


TINY = ["--graph", "community", "--mode", "split", "--fan-out", "3,3",
        "--batch-size", "64", "--num-nodes", "400", "--num-epochs", "1",
        "--limit-train", "128", "--cpu", "--cpu-devices", "1"]


@pytest.mark.parametrize("sampler", ["native", "numpy"])
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_trainer_asks_for_plans_for_split_gat_alone(monkeypatch, model,
                                                    sampler):
    """The trainer's sampler ships plans for split GAT only, and split
    GAT's backward hands each dense layer's plan past layer 0 to the
    per-slot scatter: one call a layer and step, each with a plan."""
    asked, scattered = [], []
    cls = (native.NativeSplitSampler if sampler == "native"
           else tsl.SplitSampler)

    class Asking(cls):
        def __init__(self, *a, **kw):
            asked.append(kw.get("scatter_plans", False))
            super().__init__(*a, **kw)

    real = ga.dense_scatter_slots

    def scatter(rows, nbr, num_rows, plan=None):
        scattered.append(plan is not None)
        return real(rows, nbr, num_rows, plan)

    monkeypatch.setattr(native if sampler == "native" else tsl,
                        cls.__name__, Asking)
    monkeypatch.setattr(ga, "dense_scatter_slots", scatter)
    flags = ["--model-name", model] + (["--num-heads", "2"]
                                       if model == "gat" else [])
    metrics = train.main(TINY + flags + ["--sampler", sampler])
    assert asked == [model == "gat"]
    steps = metrics["steps"]
    assert steps > 0
    assert scattered == ([True] * steps if model == "gat" else [])
