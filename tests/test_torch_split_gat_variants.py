"""Split GAT's attention lowerings in the port against the JAX package's.

``OCC_GAT_ATTENTION=online`` and ``tiled`` and ``OCC_GAT_AGG=fma``, each
against the same lowering in JAX (not against ``batched``: under bf16
``online`` takes its leaves in f32): logits and every gradient at P = 1,
and ``online`` at P = 2 over gloo. ``OCC_GAT_REMAT=dots`` recomputes the
local attention in the backward: the same gradients as without it, and
at P = 2 the same all-to-alls. The batched form's residual warning.

Weights are JAX's (``params_from_jax``); both slicers get the same seed
and partition map, which gives the same batches.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from occ_gnn_tpu.data import partition_graph
from occ_gnn_tpu.ops import config as jcfg
from occ_gnn_tpu.parallel.model import _local_ce as jax_local_ce
from occ_gnn_tpu.parallel.model import _unstack
from occ_gnn_tpu.parallel.model import make_split_forward as jax_forward
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling.slicer import SplitSampler as JaxSplitSampler
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.ops import config as tcfg
from occ_gnn_tpu_torch.ops import gat_attention as ga
from occ_gnn_tpu_torch.parallel import model as tmodel
from occ_gnn_tpu_torch.parallel.model import make_split_forward
from occ_gnn_tpu_torch.sampling.slicer import SplitSampler
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_split_gat import (
    BATCH,
    FANOUTS,
    GRAPH_KW,
    HEADS,
    HIDDEN,
    _coo,
    _jax_loss_grads,
    _jax_model,
    _jax_xs,
    _port_loss_grads,
    _port_model,
    _torch_xs,
)
from torch_ranks import gat_variant_rank, run_ranks

# f32 on the CPU in both packages, sums taken in another order.
TOL = dict(rtol=1e-5, atol=1e-5)
# With and without recomputation the same ops run on the same inputs.
REMAT_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=1e-3, atol=1e-3)
# (attention, agg): the lowerings held against JAX's.
VARIANTS = [("online", "einsum"), ("tiled", "einsum"), ("batched", "fma")]
VARIANT_IDS = ["online", "tiled", "fma"]
P2, SEED = 2, 7


@contextlib.contextmanager
def _lowering(attention="batched", agg="einsum", remat="none"):
    """Both packages under one GAT lowering, restored afterwards."""
    names = ("gat_attention", "gat_agg", "gat_remat")
    olds = [[getattr(m, f"{n}_impl")() for n in names] for m in (jcfg, tcfg)]
    for m in (jcfg, tcfg):
        for n, v in zip(names, (attention, agg, remat)):
            getattr(m, f"set_{n}_impl")(v)
    try:
        yield
    finally:
        for m, old in zip((jcfg, tcfg), olds):
            for n, v in zip(names, old):
                getattr(m, f"set_{n}_impl")(v)


@pytest.fixture(scope="module")
def params():
    return _jax_model().init(jax.random.PRNGKey(11))


@pytest.fixture(scope="module")
def p1(small_graph):
    """The first batch of both packages' slicers at P = 1, same seed."""
    tg = random_graph(**GRAPH_KW)
    pmap = np.zeros(tg.num_nodes, np.int32)
    jb = next(iter(JaxSplitSampler(small_graph, small_graph.train_nodes(),
                                   pmap, 1, FANOUTS, BATCH, seed=3)))
    plans = tmodel.SplitGAT.needs_scatter_plans
    tb = next(iter(SplitSampler(tg, tg.train_nodes(), pmap, 1, FANOUTS,
                                BATCH, seed=3, scatter_plans=plans,
                                device="cpu")))
    assert all(l.nbr_idx is not None for l in tb.layers)
    assert all(l.scatter_plan is not None for l in tb.layers[1:])
    return tg, jb, tb, _jax_xs(small_graph, jb), _torch_xs(tg, tb)


def _grads(model):
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("attention,agg", VARIANTS, ids=VARIANT_IDS)
def test_variant_matches_jax_at_one_partition(p1, params, monkeypatch,
                                              attention, agg):
    tg, jb, tb, jxs, txs = p1
    monkeypatch.setenv("OCC_GAT_TILE", "48")  # several tiles, a short last
    assert tb.layers[0].nbr_idx.shape[1] % 48
    with _lowering(attention, agg):
        jloss, jlogits, jgrads = _jax_loss_grads(_jax_model(), params, jb,
                                                 jxs)
        model = _port_model(params)
        loss, logits = _port_loss_grads(model, tb, txs)
    np.testing.assert_allclose(logits, jlogits, **TOL)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    grads = _grads(model)
    assert len(grads) == len(list(model.parameters())) - 1  # last b: none
    for name, g in grads.items():
        layer, leaf = name.split("/")
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(jgrads[layer][leaf]),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("attention,agg", VARIANTS, ids=VARIANT_IDS)
def test_variant_bf16_storage_matches_jax(p1, params, attention, agg):
    """A bf16 frame at layer 0: each lowering rounds what JAX's does."""
    tg, jb, tb, jxs, txs = p1
    with _lowering(attention, agg):
        jlogits = np.asarray(jax_forward(_jax_model(), make_mesh(1))(
            params, jb, jxs.astype(jnp.bfloat16)))
        tlogits = make_split_forward(_port_model(params))(
            tb, txs.to(torch.bfloat16))
    np.testing.assert_allclose(tlogits.numpy(), jlogits, **BF16_TOL)


@pytest.mark.parametrize("attention", ["batched", "online", "tiled", "coo"])
def test_remat_dots_gradients_equal_no_remat(p1, params, monkeypatch,
                                             attention):
    tg, _, tb, _, txs = p1
    monkeypatch.setenv("OCC_GAT_TILE", "48")
    if attention == "coo":
        tb, attention = _coo(tb), "batched"
    out = {}
    for remat in ("none", "dots"):
        with _lowering(attention, remat=remat):
            model = _port_model(params)
            out[remat] = _port_loss_grads(model, tb, txs), _grads(model)
    (loss_n, logits_n), grads_n = out["none"]
    (loss_d, logits_d), grads_d = out["dots"]
    np.testing.assert_array_equal(logits_d, logits_n)
    assert loss_d == loss_n
    assert grads_d.keys() == grads_n.keys()
    for name in grads_n:
        np.testing.assert_allclose(grads_d[name], grads_n[name],
                                   err_msg=name, **REMAT_TOL)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_backward_scatters_through_the_batch_plan(p1, params, monkeypatch,
                                                  remat):
    """The batched form's gradient to each layer's frame past layer 0 goes
    through the per-slot scatter with that layer's plan, under the
    selective checkpoint too."""
    _, _, tb, _, txs = p1
    layers = [l.partition(0) for l in tb.layers]
    plans = {l.nbr_idx.data_ptr(): l.scatter_plan for l in layers[1:]}
    assert len(plans) == len(FANOUTS) - 1
    seen = []
    real = ga.dense_scatter_slots

    def scatter(rows, nbr, num_rows, plan=None):
        want = plans[nbr.data_ptr()]
        seen.append(all(a is b for a, b in zip(plan, want)))
        return real(rows, nbr, num_rows, plan)

    monkeypatch.setattr(ga, "dense_scatter_slots", scatter)
    with _lowering(remat=remat):
        _port_loss_grads(_port_model(params), tb, txs, layers)
    assert seen == [True] * (len(FANOUTS) - 1)


def test_residual_warning_once_a_shape(p1, params, monkeypatch):
    """The batched form warns with JAX's estimate and text above
    ``OCC_GAT_RESID_WARN_GB``, once for each distinct shape."""
    tg, _, tb, _, txs = p1
    monkeypatch.setattr(tmodel, "_WARNED_SHAPES", set())
    fwd = make_split_forward(_port_model(params))
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        fwd(tb, txs)
    assert not [w for w in got if "residuals" in str(w.message)]
    monkeypatch.setenv("OCC_GAT_RESID_WARN_GB", "1e-9")
    for _ in range(2):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            fwd(tb, txs)
        texts = [str(w.message) for w in got]
        if _ == 0:
            # One warning a layer: each has its own shape.
            assert len(texts) == len(FANOUTS), texts
            lyr, x = tb.layers[0], txs[0]
            K, D = lyr.nbr_idx.shape[1:]
            gb = K * D * (x.shape[-1] * 4 + 2 * HEADS * 4) / 1e9
            assert texts[0] == (
                f"batched GAT attention materializes ~{gb:.1f} GB of "
                "residuals; if this OOMs, set OCC_GAT_ATTENTION=online "
                "(flash-style streaming, O(D*H) residents)")
        else:
            assert texts == []


# -- P = 2 -------------------------------------------------------------------


@pytest.fixture(scope="module")
def p2_setup(small_graph):
    pmap = partition_graph(small_graph, P2, mode="greedy", attach=False)
    return dict(graph=GRAPH_KW, pmap=pmap, fanouts=FANOUTS, batch=BATCH,
                seed=SEED, hidden=HIDDEN, heads=HEADS)


@pytest.fixture(scope="module")
def p2_ranks(p2_setup, params):
    state = {n: t.numpy() for n, t in params_from_jax(params).items()}
    variants = [("online", "none"), ("batched", "none"), ("batched", "dots")]
    return run_ranks(gat_variant_rank, P2, p2_setup, state, variants)


def _jax_p2(small_graph, p2_setup, params):
    """JAX's logits, global loss and gradients at P = 2 on the first
    batch, under the lowering set at the call."""
    js = JaxSplitSampler(small_graph, small_graph.train_nodes(),
                         p2_setup["pmap"], P2, FANOUTS, BATCH, seed=SEED)
    jb = js.slice_raw(js._sample_raw(small_graph.train_nodes()[:BATCH]))
    jxs = _jax_xs(small_graph, jb)
    jm = _jax_model()
    logits = np.asarray(jax_forward(jm, make_mesh(P2))(params, jb, jxs))

    def body(prm, layers, labels, xs):
        out = jm.forward_local(prm, [_unstack(l) for l in layers], xs[0])
        nll, cnt, _ = jax_local_ce(out, labels[0])
        return jax.lax.psum(nll, "p") / jnp.maximum(jax.lax.psum(cnt, "p"), 1)

    mapped = jax.shard_map(body, mesh=make_mesh(P2),
                           in_specs=(PS(), PS("p"), PS("p"), PS("p")),
                           out_specs=PS(), check_vma=False)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda prm: mapped(prm, jb.layers, jb.labels, jxs)))(params)
    return logits, float(loss), grads


def test_online_two_partitions_matches_jax(small_graph, p2_setup, params,
                                           p2_ranks):
    with _lowering("online"):
        jlogits, jloss, jgrads = _jax_p2(small_graph, p2_setup, params)
    for r in range(P2):
        got = p2_ranks[r]["online", "none"]
        np.testing.assert_allclose(got["logits"], jlogits[r], **TOL)
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        for name, g in got["grads"].items():
            layer, leaf = name.split("/")
            assert np.isfinite(g).all(), name
            np.testing.assert_allclose(g, np.asarray(jgrads[layer][leaf]),
                                       err_msg=name, **TOL)


def test_remat_two_partitions_same_gradients_and_exchanges(p2_ranks):
    """Recomputation stays between the shuffles: the same all-to-alls a
    step (two a layer each way) and the same bytes."""
    for r in range(P2):
        plain = p2_ranks[r]["batched", "none"]
        remat = p2_ranks[r]["batched", "dots"]
        assert remat["shuffles"] == plain["shuffles"]
        assert plain["shuffles"]["forward"] == 2 * len(FANOUTS)
        assert remat["loss"] == plain["loss"]
        for name, g in plain["grads"].items():
            np.testing.assert_allclose(remat["grads"][name], g,
                                       err_msg=name, **REMAT_TOL)
