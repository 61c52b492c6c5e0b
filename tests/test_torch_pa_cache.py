"""``--mode pa-cache`` in the port against the JAX package: the single-chip
static cache (``SingleChipCache``) and the CLI on top of it.

Both packages' samplers are the same numpy code, so one seed gives the
same batches and the cache's counts must be equal, not close. The frame
is assembled by copies alone, so it must equal JAX's and the port's
``gather_features`` bit for bit (tolerance 0).
"""

import numpy as np
import pytest
import torch

from occ_gnn_tpu import train as jax_train
from occ_gnn_tpu.cache import SingleChipCache as JaxSingleChipCache
from occ_gnn_tpu.cache.autosize import (
    resolve_cache_percentage as jax_resolve,
)
from occ_gnn_tpu.data import block_graph as jax_block_graph
from occ_gnn_tpu.sampling.neighbor import NeighborSampler as JaxSampler
from occ_gnn_tpu.utils import PhaseTimers as JaxTimers
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.cache import SingleChipCache
from occ_gnn_tpu_torch.cache.autosize import resolve_cache_percentage
from occ_gnn_tpu_torch.data import block_graph, random_graph
from occ_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from occ_gnn_tpu_torch.training import gather_features

GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
FANOUTS, BATCH, SEED, PCT = [4, 3], 48, 5, 0.3
CLI = ["--graph", "community", "--num-nodes", "1500", "--fan-out", "4,4",
       "--batch-size", "128", "--num-hidden", "16", "--num-epochs", "2",
       "--feature-dim", "16", "--cpu", "--mode", "pa-cache"]
COMMUNITY = dict(num_nodes=1500, num_blocks=8, avg_degree=10,
                 feature_dim=16, seed=0)


def _jax_cache(jg):
    """JAX's cache, its dense miss buffer sized to the sampler's frame."""
    cap = JaxSampler(jg, jg.train_nodes(), FANOUTS, BATCH).caps[
        "frame_caps"][0]
    return JaxSingleChipCache(jg, PCT, cap)


@pytest.fixture(scope="module")
def caches(small_graph):
    tg = random_graph(**GRAPH_KW)
    return (tg, SingleChipCache(tg, PCT, device="cpu"),
            _jax_cache(small_graph))


def _batches(tg, jg, num):
    """The first ``num`` batches of both packages' samplers (same seed)."""
    ts = NeighborSampler(tg, tg.train_nodes(), FANOUTS, BATCH, seed=SEED,
                         device="cpu")
    js = JaxSampler(jg, jg.train_nodes(), FANOUTS, BATCH, seed=SEED)
    return list(zip(range(num), ts, js))


def test_cached_nodes_equal_jax(caches):
    _, port, jax_cache = caches
    assert port.num_cached == jax_cache.num_cached == int(PCT * 500)
    np.testing.assert_array_equal(port.cached_nodes, jax_cache.cached_nodes)
    np.testing.assert_array_equal(port.global_to_local,
                                  jax_cache.global_to_local)
    assert port.frame.dtype == torch.float32


def test_frame_equals_jax_and_gather_features(small_graph, caches):
    tg, port, jax_cache = caches
    for _, tb, jb in _batches(tg, small_graph, 4):
        ids = tb.input_nodes.numpy()
        np.testing.assert_array_equal(ids, np.asarray(jb.input_nodes))
        frame = port.load_input_frame(tb.input_nodes)
        jframe = np.asarray(jax_cache.load_input_frame(np.asarray(
            jb.input_nodes)))
        ref = gather_features(tg.features, ids, "cpu")
        assert frame.dtype == torch.float32 and frame.shape == ref.shape
        # Bit-identical: the same bytes, not merely equal values.
        assert frame.numpy().tobytes() == ref.numpy().tobytes()
        np.testing.assert_array_equal(frame.numpy(), jframe)
        assert (ids < 0).any() and not frame[ids < 0].any()


def test_hit_and_miss_counts_equal_jax(small_graph):
    tg = random_graph(**GRAPH_KW)
    port = SingleChipCache(tg, PCT, device="cpu")
    jax_cache = _jax_cache(small_graph)
    sent = 0
    for _, tb, jb in _batches(tg, small_graph, 6):
        port.load_input_frame(tb.input_nodes)
        jax_cache.load_input_frame(np.asarray(jb.input_nodes))
        ids = tb.input_nodes.numpy()
        hits = int(np.isin(ids[ids >= 0], port.cached_nodes).sum())
        misses = int((ids >= 0).sum()) - hits
        # Only the misses' rows and the frame positions travel.
        sent += 4 * misses * tg.feature_dim + 8 * (2 * hits + misses)
    assert (port.hits, port.misses) == (jax_cache.hits, jax_cache.misses)
    assert port.hits > 0 and port.misses > 0
    assert port.hit_rate == jax_cache.hit_rate
    assert port.bytes_sent == sent


def test_pads_are_neither_hit_nor_miss():
    tg = random_graph(**GRAPH_KW)
    cache = SingleChipCache(tg, 1.0, device="cpu")
    frame = cache.load_input_frame(np.array([-1, 3, -1, 7], np.int32))
    assert (cache.hits, cache.misses) == (2, 0)
    np.testing.assert_array_equal(frame[[0, 2]].numpy(), 0.0)
    np.testing.assert_array_equal(frame[[1, 3]].numpy(), tg.features[[3, 7]])


def test_cli_hit_rate_equals_jax():
    """The CLI at --cache-per 0.25 reports the JAX CLI's hit rate exactly,
    a finite loss and acc > 0.5 (JAX tests/test_cli.py:13-23)."""
    argv = CLI + ["--cache-per", "0.25"]
    metrics = train.main(argv)
    jm = jax_train.train_single(
        jax_train.build_argparser().parse_args(argv),
        jax_block_graph(**COMMUNITY), [4, 4], JaxTimers(), use_cache=True)
    assert metrics["mode"] == "pa-cache" and metrics["steps"] == 20
    assert metrics["hit_rate"] == jm["hit_rate"]
    assert 0.0 < metrics["hit_rate"] < 1.0
    assert np.isfinite(metrics["loss"]) and metrics["acc"] > 0.5, metrics


@pytest.mark.parametrize("spec,dtype,budget", [
    ("0", "float32", None),
    ("auto", "float32", 60_000),
    ("auto", "bfloat16", 60_000),
    ("auto", "float32", 10**9),
])
def test_cache_fraction_as_jax(spec, dtype, budget, monkeypatch):
    """--cache-per 0 caches the reference's 0.25; auto sizes to the
    OCC_HBM_BYTES budget as JAX does (the rows costed at --dtype, the
    frame f32 all the same), capped at the whole graph."""
    if budget is not None:
        monkeypatch.setenv("OCC_HBM_BYTES", str(budget))
    tg = block_graph(**COMMUNITY)
    jg = jax_block_graph(**COMMUNITY)
    zeros = np.zeros(tg.num_nodes, np.int32)
    nbytes = 2 if dtype == "bfloat16" else 4
    jpct = jax_resolve(spec, jg, zeros, 1, dtype_bytes=nbytes, refresh_cap=0)
    pct = resolve_cache_percentage(spec, tg, zeros, 1, dtype_bytes=nbytes,
                                   refresh_cap=0, device="cpu")
    assert pct == jpct
    want = min(pct, 1.0) if pct > 0 else 0.25
    metrics = train.main(CLI + ["--cache-per", spec, "--dtype", dtype,
                                "--num-epochs", "1"])
    assert metrics["cache_pct"] == want
    if budget == 60_000:
        assert 0.0 < want < 1.0
    assert np.isfinite(metrics["loss"])
