"""The port's feature cache against the JAX package's: the same cache plan
(maps, frame layout), the same frames after a sequence of tails through
each of the three tail paths, the same auto-sizing, and a tail written in
place only after the step that reads the old one."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from occ_gnn_tpu.cache import CachePlan as JaxCachePlan
from occ_gnn_tpu.cache import SplitFeatureCache as JaxCache
from occ_gnn_tpu.cache import auto_cache_percentage as jax_auto
from occ_gnn_tpu.cache import resolve_cache_percentage as jax_resolve
from occ_gnn_tpu.data import partition_graph
from occ_gnn_tpu.data import random_graph as jax_random_graph
from occ_gnn_tpu.parallel.model import SplitSAGE as JaxSplitSAGE
from occ_gnn_tpu.parallel.model import make_split_train_step as jax_step
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling.slicer import SplitSampler as JaxSplitSampler
from occ_gnn_tpu_torch.cache import (
    CachePlan,
    SplitFeatureCache,
    auto_cache_percentage,
    hbm_budget_bytes,
    resolve_cache_percentage,
)
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.parallel.model import SplitSAGE, make_split_train_step
from occ_gnn_tpu_torch.sampling.slicer import SplitSampler
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax

P = 4
GRAPH_KW = dict(num_nodes=600, avg_degree=6, feature_dim=12, num_classes=5,
                seed=3)
PLAN_FIELDS = ("owner_local", "static_owner_local", "static_sizes",
               "foreign_offsets", "foreign_nodes_flat", "foreign_local_flat")


@pytest.fixture(scope="module")
def graphs():
    return jax_random_graph(**GRAPH_KW), random_graph(**GRAPH_KW)


@pytest.fixture(scope="module")
def pmap(graphs):
    return partition_graph(graphs[0], P, mode="greedy", attach=False)


def _frames(cache):
    f = cache.frames
    if isinstance(f, torch.Tensor):
        return f.float().numpy()
    return np.asarray(f.astype(jnp.float32))


@pytest.mark.parametrize("parts", [1, P])
@pytest.mark.parametrize("pct", [0.05, 0.3, 0.6, 1.0])
def test_cache_plan_equals_jax(graphs, pmap, parts, pct):
    jg, tg = graphs
    pm = pmap if parts == P else np.zeros(tg.num_nodes, np.int32)
    jp = JaxCachePlan(jg, pm, parts, pct, refresh_cap=64)
    tp = CachePlan(tg, pm, parts, pct, refresh_cap=64)
    for f in ("replicated", "needs_refresh", "refresh_cap", "frame_cap",
              "tail_start", "static_size"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    for a, b in zip(tp.static_nodes, jp.static_nodes):
        np.testing.assert_array_equal(a, b)
    nodes = np.arange(tg.num_nodes)
    for p in range(parts):
        np.testing.assert_array_equal(tp.cached_on(nodes, p),
                                      jp.cached_on(nodes, p))
        np.testing.assert_array_equal(tp.local_rows(nodes, p),
                                      jp.local_rows(nodes, p))
    np.testing.assert_array_equal(tp.static_features(), jp.static_features())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_frames_after_tails_equal_jax(graphs, pmap, dtype):
    """apply_tail (host gather) and apply_tail_gathered (worker buffers)
    over a sequence of refresh lists give JAX's frames, in the storage
    dtype, with the 16-step bucket ladder."""
    jg, tg = graphs
    bf16 = dtype == "bf16"
    jp = JaxCachePlan(jg, pmap, P, 0.05, refresh_cap=100)
    tp = CachePlan(tg, pmap, P, 0.05, refresh_cap=100)
    jc = JaxCache(jp, dtype=jnp.bfloat16 if bf16 else None)
    tc = SplitFeatureCache(tp, dtype=torch.bfloat16 if bf16 else torch.float32,
                           device="cpu")
    tg2 = SplitFeatureCache(CachePlan(tg, pmap, P, 0.05, refresh_cap=100),
                            dtype=tc.dtype, device="cpu")
    assert tc.frames.dtype == tc.dtype and not tc.frames.requires_grad
    np.testing.assert_array_equal(_frames(tc), _frames(jc))
    rng = np.random.default_rng(0)
    Ht = tg.feature_dim
    for fill in (3, 40, 100, 17):
        refresh = np.full((P, 100), -1, np.int32)
        counts = rng.integers(0, fill + 1, P)
        counts[0] = fill
        for p in range(P):
            refresh[p, :counts[p]] = rng.choice(tg.num_nodes, counts[p],
                                                replace=False)
        jc.apply_tail(refresh)
        tc.apply_tail(refresh)
        # The gathered path: the buffer the workers would have filled.
        buf = torch.zeros((P, 100, Ht), dtype=tc.dtype)
        for p in range(P):
            buf[p, :counts[p]] = torch.from_numpy(
                tg.features[refresh[p, :counts[p]]]).to(tc.dtype)
        tg2.apply_tail_gathered(buf, counts)
        np.testing.assert_array_equal(_frames(tc), _frames(jc))
        np.testing.assert_array_equal(_frames(tg2), _frames(jc))
        # the reserved zero row that nbr padding reads stays zero
        assert (tc.frames[:, -1] == 0).all() and (tg2.frames[:, -1] == 0).all()
        assert tc.tail_rows_last == jc.tail_rows_last
        assert tc.tail_bytes_total == jc.tail_bytes_total
    assert tc.tail_batches == jc.tail_batches == 4


def test_numpy_sampler_refresh_frames_equal_jax(graphs, pmap):
    jg, tg = graphs
    jcache = JaxCache(JaxCachePlan(jg, pmap, P, 0.05, refresh_cap=300))
    tcache = SplitFeatureCache(CachePlan(tg, pmap, P, 0.05, refresh_cap=300),
                               device="cpu")
    js = JaxSplitSampler(jg, jg.train_nodes(), pmap, P, [3, 3], 32, seed=2,
                         cache=jcache)
    ts = SplitSampler(tg, tg.train_nodes(), pmap, P, [3, 3], 32, seed=2,
                      cache=tcache, device="cpu")
    for _, jb, tb in zip(range(3), js, ts):
        np.testing.assert_array_equal(tb.layers[0].edge_src.numpy(),
                                      np.asarray(jb.layers[0].edge_src))
        np.testing.assert_array_equal(_frames(tcache), _frames(jcache))


def test_auto_cache_percentage_equals_jax(graphs, pmap):
    jg, tg = graphs
    for parts in (1, P):
        pm = pmap if parts == P else np.zeros(tg.num_nodes, np.int32)
        for budget in (0, 5_000, 40_000, 150_000, 16 * 1024**3):
            for dtype_bytes in (2, 4):
                assert auto_cache_percentage(
                    tg, pm, parts, dtype_bytes, 64, budget_bytes=budget
                ) == jax_auto(jg, pm, parts, dtype_bytes, 64,
                              budget_bytes=budget)
        for spec in ("auto", "0.25"):
            assert resolve_cache_percentage(
                spec, tg, pm, parts, 4, 64, device="cpu"
            ) == jax_resolve(spec, jg, pm, parts, 4, 64)


def test_budget_on_the_cpu_is_the_jax_default(monkeypatch):
    monkeypatch.delenv("OCC_HBM_BYTES", raising=False)
    assert hbm_budget_bytes("cpu") == hbm_budget_bytes() == 16 * 1024**3
    monkeypatch.setenv("OCC_HBM_BYTES", "1e6")
    assert hbm_budget_bytes("cpu") == 1_000_000


def test_step_launched_before_a_tail_write_reads_the_old_tail(graphs):
    """Step n runs on the frames, then batch n+1's tail is written in
    place: step n's loss and update are JAX's with the old frames, the
    write lands in the same storage, and the frames then equal JAX's
    frames after the same tail (JAX's update is functional)."""
    jg, tg = graphs
    pm = np.zeros(tg.num_nodes, np.int32)
    jcache = JaxCache(JaxCachePlan(jg, pm, 1, 0.1, refresh_cap=400))
    tcache = SplitFeatureCache(CachePlan(tg, pm, 1, 0.1, refresh_cap=400),
                               device="cpu")
    js = JaxSplitSampler(jg, jg.train_nodes(), pm, 1, [3, 3], 32, seed=4,
                         cache=jcache)
    ts = SplitSampler(tg, tg.train_nodes(), pm, 1, [3, 3], 32, seed=4,
                      cache=tcache, device="cpu")
    jm = JaxSplitSAGE(tg.feature_dim, 16, tg.num_classes, 2)
    params = jm.init(jax.random.PRNGKey(0))
    tm = SplitSAGE(tg.feature_dim, 16, tg.num_classes, 2)
    tm.load_state_dict(params_from_jax(params))
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    jstep = jax_step(jm, opt, make_mesh(1))
    tstep = make_split_train_step(tm, torch.optim.Adam(tm.parameters(),
                                                       lr=1e-2))
    ptr = tcache.frames.data_ptr()
    jit, tit = iter(js), iter(ts)
    jb, tb = next(jit), next(tit)
    for _ in range(3):
        j_frames = jcache.frames  # the version step n was launched with
        params, opt_state, jloss, _, _ = jstep(params, opt_state, jb,
                                               j_frames)
        tloss, _, _ = tstep(tb, tcache.frames)
        jb, tb = next(jit), next(tit)  # writes batch n+1's tail
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert tcache.frames.data_ptr() == ptr
        np.testing.assert_array_equal(_frames(tcache), _frames(jcache))
        assert not np.array_equal(np.asarray(j_frames), _frames(jcache))
