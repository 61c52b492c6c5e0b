"""The port's split layer ops and split models against the JAX package's.

Layers: ``local_aggregate`` (COO, through the segment-sum kernel's plain
version on the CPU), ``local_aggregate_dense`` and ``slice_owned``,
forward and input gradients, per partition of a 4-way sliced batch
(the pattern of tests/test_split_parallel.py).

Models: ``SplitSAGE`` and ``SplitGCN`` at P = 1 against JAX's
``make_split_train_step`` on a one-device mesh, with the JAX weights
carried across by ``params_from_jax``. Both samplers get the same seed,
which gives the same batches (tests/test_torch_split_sampler.py).
Tolerances are those of tests/test_torch_sage.py.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from occ_gnn_tpu.data import partition_graph
from occ_gnn_tpu.parallel import split as jsplit
from occ_gnn_tpu.parallel.model import SplitGCN as JaxSplitGCN
from occ_gnn_tpu.parallel.model import SplitSAGE as JaxSplitSAGE
from occ_gnn_tpu.parallel.model import _local_ce as jax_local_ce
from occ_gnn_tpu.parallel.model import make_split_forward as jax_forward
from occ_gnn_tpu.parallel.model import make_split_train_step as jax_step
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling.slicer import SplitSampler as JaxSplitSampler
from occ_gnn_tpu.training import gather_features as jax_gather
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.models import SAGEModel
from occ_gnn_tpu_torch.parallel import split as tsplit
from occ_gnn_tpu_torch.parallel.model import (
    SplitGCN,
    SplitSAGE,
    _local_ce,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.parallel.split import count_layer_edges
from occ_gnn_tpu_torch.sampling.slicer import SplitSampler, raw_to_single_batch
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-5)
# Layer ops: f32 sums of at most a few dozen terms in another order.
OP_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 storage: activations rounded to 8 mantissa bits between layers.
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
FANOUTS, BATCH, HIDDEN = [4, 3], 32, 16


@pytest.fixture(scope="module")
def sliced4(small_graph):
    """One batch sliced 4 ways, in both packages (same seed)."""
    tg = random_graph(**GRAPH_KW)
    pmap = partition_graph(small_graph, 4, mode="greedy", attach=False)
    js = JaxSplitSampler(small_graph, small_graph.train_nodes(), pmap, 4,
                         FANOUTS, BATCH, seed=7)
    ts = SplitSampler(tg, tg.train_nodes(), pmap, 4, FANOUTS, BATCH, seed=7,
                      device="cpu")
    nodes = tg.train_nodes()[:BATCH]
    return (js.slice_raw(js._sample_raw(nodes)),
            ts.slice_raw(ts._sample_raw(nodes)))


def _frame(rng, rows, h=16):
    x = rng.standard_normal((rows, h)).astype(np.float32)
    x[rows - 1] = 0.0  # the reserved zero row
    return x


@pytest.mark.parametrize("op", ["coo", "dense"])
def test_aggregation_forward_and_input_grad_match_jax(sliced4, op):
    jb, tb = sliced4
    rng = np.random.default_rng(0)
    for jl, tl in zip(jb.layers, tb.layers):
        for p in range(4):
            x = _frame(rng, tl.src_cap)
            w = rng.standard_normal((tl.dst_cap, 16)).astype(np.float32)
            jlp = jax.tree_util.tree_map(lambda a: a[p], jl)
            tlp = tl.partition(p)
            if op == "coo":
                def jfn(xx):
                    return jsplit.local_aggregate(xx, jlp.edge_src,
                                                  jlp.edge_dst, jl.dst_cap)

                def tfn(xx):
                    return tsplit.local_aggregate(xx, tlp.edge_src,
                                                  tlp.edge_dst, tl.dst_cap)
            else:
                def jfn(xx):
                    return jsplit.local_aggregate_dense(xx, jlp.nbr_idx)

                def tfn(xx):
                    return tsplit.local_aggregate_dense(xx, tlp.nbr_idx)
            jout = jfn(jnp.asarray(x))
            jgrad = jax.grad(lambda xx: jnp.sum(jfn(xx) * w))(jnp.asarray(x))
            tx = torch.from_numpy(x).requires_grad_()
            tout = tfn(tx)
            (tout * torch.from_numpy(w)).sum().backward()
            assert tout.dtype == torch.float32
            np.testing.assert_allclose(tout.detach().numpy(),
                                       np.asarray(jout), **OP_TOL)
            np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                                       **OP_TOL)


def test_dense_and_coo_sums_agree_and_count_edges(sliced4):
    _, tb = sliced4
    rng = np.random.default_rng(1)
    for tl in tb.layers:
        x = torch.from_numpy(_frame(rng, tl.src_cap))
        for p in range(4):
            tlp = tl.partition(p)
            np.testing.assert_allclose(
                tsplit.local_aggregate_dense(x, tlp.nbr_idx).numpy(),
                tsplit.local_aggregate(x, tlp.edge_src, tlp.edge_dst,
                                       tl.dst_cap).numpy(), **OP_TOL)
        nbr_only = tsplit.SplitLayer(nbr_idx=tl.nbr_idx, src_cap=tl.src_cap,
                                     dst_cap=tl.dst_cap)
        assert count_layer_edges(tl) == count_layer_edges(nbr_only)
        np.testing.assert_array_equal(
            count_layer_edges(tl, per_partition=True),
            jsplit.count_layer_edges(
                jsplit.SplitLayer(edge_dst=jnp.asarray(tl.edge_dst.numpy()),
                                  dst_cap=tl.dst_cap), per_partition=True))


def test_slice_owned_matches_jax(sliced4):
    jb, tb = sliced4
    rng = np.random.default_rng(2)
    for jl, tl in zip(jb.layers, tb.layers):
        for p in range(4):
            merged = rng.standard_normal((tl.dst_cap, 16)).astype(np.float32)
            x = _frame(rng, tl.src_cap)
            w = rng.standard_normal((tl.out_cap, 32)).astype(np.float32)
            jlp = jax.tree_util.tree_map(lambda a: a[p], jl)

            def jloss(m, xx):
                s, n, mask = jsplit.slice_owned(m, jlp, xx)
                return jnp.sum(jnp.concatenate([s, n], -1) * mask * w)

            js_, jn, jm = jsplit.slice_owned(jnp.asarray(merged), jlp,
                                             jnp.asarray(x))
            jgm, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(merged),
                                                        jnp.asarray(x))
            tm = torch.from_numpy(merged).requires_grad_()
            tx = torch.from_numpy(x).requires_grad_()
            ts_, tn, tmask = tsplit.slice_owned(tm, tl.partition(p), tx)
            (torch.cat([ts_, tn], -1) * tmask * torch.from_numpy(w)
             ).sum().backward()
            for a, b in ((ts_, js_), (tn, jn)):
                np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                           **OP_TOL)
            np.testing.assert_array_equal(tmask.numpy(), np.asarray(jm))
            np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgm),
                                       **OP_TOL)
            np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                                       **OP_TOL)


# -- models at P = 1 -------------------------------------------------------


def _p1(small_graph, seed=3, batch=BATCH):
    tg = random_graph(**GRAPH_KW)
    pmap = np.zeros(tg.num_nodes, np.int32)
    js = JaxSplitSampler(small_graph, small_graph.train_nodes(), pmap, 1,
                         FANOUTS, batch, seed=seed)
    ts = SplitSampler(tg, tg.train_nodes(), pmap, 1, FANOUTS, batch,
                      seed=seed, device="cpu")
    return tg, js, ts


def _jax_xs(g, batch):
    return jnp.stack([jax_gather(g.features, batch.input_nodes[0])])


def _torch_xs(g, batch):
    return gather_features(g.features, batch.input_nodes[0], "cpu")[None]


def _models(g, kind, dtype=None, seed=0):
    jcls, tcls = {"sage": (JaxSplitSAGE, SplitSAGE),
                  "gcn": (JaxSplitGCN, SplitGCN)}[kind]
    jm = jcls(g.feature_dim, HIDDEN, g.num_classes, len(FANOUTS),
              dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = tcls(g.feature_dim, HIDDEN, g.num_classes, len(FANOUTS),
              dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def test_masked_rows_are_zero_so_the_zero_row_stays_zero(small_graph):
    """Each layer's output rows past the owned count are zero, so the next
    layer's reserved zero row (src_cap - 1) reads zeros."""
    tg, _, ts = _p1(small_graph)
    batch = next(iter(ts))
    model = SplitSAGE(tg.feature_dim, HIDDEN, tg.num_classes, 2,
                      generator=torch.Generator().manual_seed(0))
    lyr0 = batch.layers[0].partition(0)
    with torch.no_grad():
        h = model.layer(0, lyr0, _torch_xs(tg, batch)[0])
    owned = int(lyr0.num_owned)
    assert h.shape[0] == batch.layers[1].src_cap > owned
    assert (h[owned:] == 0).all()


@pytest.mark.parametrize("kind", ["sage", "gcn"])
def test_split_logits_and_gradients_match_jax(small_graph, kind):
    tg, js, ts = _p1(small_graph)
    jm, params, tm = _models(tg, kind)
    assert set(tm.state_dict()) == {f"{l}/{k}" for l in params
                                    for k in params[l]}
    jb, tb = next(iter(js)), next(iter(ts))
    jxs, txs = _jax_xs(small_graph, jb), _torch_xs(tg, tb)
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    mesh = make_mesh(1)
    jlogits = np.asarray(jax_forward(jm, mesh)(params, jb, jxs))
    tlogits = make_split_forward(tm)(tb, txs)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, **LOGIT_TOL)

    layers = [jax.tree_util.tree_map(lambda a: a[0], l) for l in jb.layers]

    def jloss(prm):
        logits = jm.forward_local(prm, layers, jxs[0])
        nll, cnt, _ = jax_local_ce(logits, jb.labels[0])
        return nll / jnp.maximum(cnt, 1)

    jgrads = jax.grad(jloss)(params)
    logits = tm.forward_local([l.partition(0) for l in tb.layers], txs[0])
    nll, cnt, correct = _local_ce(logits, tb.labels[0])
    (nll / cnt.clamp(min=1)).backward()
    jnll, jcnt, jcorrect = jax_local_ce(np.asarray(jlogits[0]), jb.labels[0])
    np.testing.assert_allclose(float(nll.detach()), float(jnll), rtol=1e-5)
    assert (int(cnt), int(correct)) == (int(jcnt), int(jcorrect))
    for name, p in tm.named_parameters():
        layer, leaf = name.split("/")
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgrads[layer][leaf]),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("num_steps", [1, 3])
@pytest.mark.parametrize("kind", ["sage", "gcn"])
def test_adam_steps_match_jax(small_graph, kind, num_steps):
    tg, js, ts = _p1(small_graph, seed=4)
    jm, params, tm = _models(tg, kind, seed=1)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    jstep = jax_step(jm, opt, make_mesh(1))
    tstep = make_split_train_step(tm, torch.optim.Adam(tm.parameters(),
                                                       lr=1e-2))
    for _, jb, tb in zip(range(num_steps), js, ts):
        params, opt_state, jloss, jc, jt = jstep(params, opt_state, jb,
                                                 _jax_xs(small_graph, jb))
        tloss, tc, tt = tstep(tb, _torch_xs(tg, tb))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert (int(tc), int(tt)) == (int(jc), int(jt))
    for name, p in tm.named_parameters():
        layer, leaf = name.split("/")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[layer][leaf]),
                                   err_msg=name, **WEIGHT_TOL)


def test_bf16_storage_matches_jax(small_graph):
    tg, js, ts = _p1(small_graph, seed=5)
    jm, params, tm = _models(tg, "sage", dtype="bf16", seed=2)
    jb, tb = next(iter(js)), next(iter(ts))
    jxs = _jax_xs(small_graph, jb).astype(jnp.bfloat16)
    txs = _torch_xs(tg, tb).to(torch.bfloat16)
    jlogits = np.asarray(jax_forward(jm, make_mesh(1))(params, jb, jxs))
    tlogits = make_split_forward(tm)(tb, txs)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), jlogits, **BF16_TOL)


def test_split_logits_equal_single_chip_logits(small_graph):
    """P = 1: the split batch and raw_to_single_batch of the same raw
    sample give the same logits through SplitSAGE and the port's
    single-chip SAGE with the same weights."""
    tg, _, ts = _p1(small_graph, seed=6)
    raw = ts._sample_raw(tg.train_nodes()[:BATCH])
    split_batch = ts.slice_raw(raw)
    single = raw_to_single_batch(raw, tg, ts.caps, "cpu")
    split_model = SplitSAGE(tg.feature_dim, HIDDEN, tg.num_classes, 2,
                            generator=torch.Generator().manual_seed(4))
    single_model = SAGEModel(tg.feature_dim, HIDDEN, tg.num_classes, 2)
    single_model.load_state_dict(split_model.state_dict())
    split_logits = make_split_forward(split_model)(
        split_batch, _torch_xs(tg, split_batch))[0]
    with torch.no_grad():
        single_logits = single_model.eval()(
            single, gather_features(tg.features, single.input_nodes, "cpu"))
    n = raw[0].frontier.shape[0]
    np.testing.assert_allclose(split_logits[:n].numpy(),
                               single_logits[:n].numpy(), **LOGIT_TOL)


def test_more_than_one_partition_names_its_roadmap_item(sliced4):
    """ROADMAP item 14: one process holds the batch's 4 partitions and
    steps them together; frames for another number of partitions, or a
    process placed to hold another number, stop the step."""
    from occ_gnn_tpu_torch.parallel import dist

    _, tb = sliced4
    model = SplitSAGE(16, HIDDEN, 5, 2)
    step = make_split_train_step(model, torch.optim.Adam(model.parameters()))
    x0 = torch.randn(4, tb.layers[0].src_cap, 16,
                     generator=torch.Generator().manual_seed(0))
    x0[:, -1] = 0.0  # the reserved zero rows
    loss, _, count = step(tb, x0)
    assert torch.isfinite(loss) and int(count) > 0
    with pytest.raises(ValueError, match="4 partitions but x0 has 1"):
        step(tb, x0[:1])
    two = dist.DistContext(0, 2, "gloo", torch.device("cpu"), 0, 2)
    with pytest.raises(ValueError, match="holds 4 partitions"):
        make_split_train_step(model, torch.optim.Adam(model.parameters()),
                              ranks=two)(tb, x0)


def test_dropout_needs_a_generator(small_graph):
    tg, _, ts = _p1(small_graph)
    model = SplitSAGE(tg.feature_dim, HIDDEN, tg.num_classes, 2, dropout=0.5)
    step = make_split_train_step(model, torch.optim.Adam(model.parameters()))
    batch = next(iter(ts))
    with pytest.raises(ValueError, match="dropout"):
        step(batch, _torch_xs(tg, batch))
    loss, _, _ = step(batch, _torch_xs(tg, batch),
                      generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
