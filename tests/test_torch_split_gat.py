"""Split-parallel GAT in the port against the JAX package's.

At P = 1, in this process: ``SplitGAT`` on the batched (dense) branch,
the COO branch and a device-synthesized layer 0 against JAX's
``SplitGAT`` (logits and every gradient), dense against COO, split against
the port's single-chip ``GATModel`` on one raw sample, bf16 storage, Adam
steps. At P = 4, as 4 gloo ranks spawned once for the module
(tests/torch_ranks.py): ``reverse_shuffle`` and ``shuffle_softmax_merge``
against their plain references (forward and gradients), the references
against JAX's shuffles on 4 virtual CPU devices, and ``SplitGAT``'s
logits, loss, gradients, all-to-all counts and Adam steps against JAX at
P = 4 and the port at P = 1. Then the CLI and checkpoints across packages.

Weights are JAX's, carried across with ``params_from_jax``; both slicers
get the same seed and partition map, which gives the same batches.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from occ_gnn_tpu.cache import CachePlan as JaxCachePlan
from occ_gnn_tpu.cache import SplitFeatureCache as JaxFeatureCache
from occ_gnn_tpu.data import partition_graph
from occ_gnn_tpu.parallel import split as jsplit
from occ_gnn_tpu.parallel.model import SplitGAT as JaxSplitGAT
from occ_gnn_tpu.parallel.model import _local_ce as jax_local_ce
from occ_gnn_tpu.parallel.model import _materialize_layers as jax_materialize
from occ_gnn_tpu.parallel.model import _unstack
from occ_gnn_tpu.parallel.model import make_device_csr as jax_device_csr
from occ_gnn_tpu.parallel.model import make_split_forward as jax_forward
from occ_gnn_tpu.parallel.model import make_split_train_step as jax_step
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling.native import NativeSplitSampler as JaxNative
from occ_gnn_tpu.sampling.slicer import SplitSampler as JaxSplitSampler
from occ_gnn_tpu.training import gather_features as jax_gather
from occ_gnn_tpu.utils import checkpoint as jax_ckpt
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.models import GATModel
from occ_gnn_tpu_torch.parallel.model import (
    SplitGAT,
    _local_ce,
    make_device_csr,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.parallel.split import (
    reverse_shuffle_reference,
    shuffle_softmax_merge_reference,
)
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
from occ_gnn_tpu_torch.sampling.slicer import SplitSampler, raw_to_single_batch
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils import checkpoint as port_ckpt
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_checkpoint import (
    DIMS,
    _assert_same,
    _grads,
    _jax_update,
    _port_update,
)
from torch_ranks import gat_rank, run_ranks

P = 4
GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
FANOUTS, BATCH, HIDDEN, HEADS, SEED = [4, 3], 32, 6, 2, 7
ADAM_STEPS, LR = 3, 1e-2
# f32 on the CPU in both packages: exps, products and sums of a few dozen
# terms taken in another order (the port sums s and v in one pass, JAX
# separately; the port's P > 1 merge adds the partials in rank order).
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Adam divides each gradient by its own magnitude, which amplifies the
# last-digit differences of tiny gradients.
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-5)
# The shuffles: each output element is a sum of at most P rescaled terms.
OP_TOL = dict(rtol=1e-6, atol=1e-6)
# bf16 storage: the frame's rows and the softmax weights are rounded to 8
# mantissa bits before the products, in both packages.
BF16_TOL = dict(rtol=1e-3, atol=1e-3)
SHUFFLE_DH = 3
# The port's samplers ship the plans that SplitGAT's backward reads.
PLANS = SplitGAT.needs_scatter_plans


def _jax_model():
    return JaxSplitGAT(GRAPH_KW["feature_dim"], HIDDEN,
                       GRAPH_KW["num_classes"], len(FANOUTS), num_heads=HEADS)


def _port_model(params):
    model = SplitGAT(GRAPH_KW["feature_dim"], HIDDEN, GRAPH_KW["num_classes"],
                     len(FANOUTS), num_heads=HEADS)
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.fixture(scope="module")
def params():
    return _jax_model().init(jax.random.PRNGKey(11))


def _jax_xs(g, batch):
    return jnp.stack([jax_gather(g.features, batch.input_nodes[p])
                      for p in range(batch.input_nodes.shape[0])])


def _torch_xs(g, batch):
    return gather_features(g.features, batch.input_nodes_host[0], "cpu")[None]


def _jax_loss_grads(jm, params, jb, jxs, layers=None):
    """JAX's one-device loss, logits and gradients (``layers``: the
    batch's per-device layers, when they were synthesized)."""
    layers = layers or [_unstack(l) for l in jb.layers]

    def loss(prm):
        logits = jm.forward_local(prm, layers, jxs[0])
        nll, cnt, _ = jax_local_ce(logits, jb.labels[0])
        return nll / jnp.maximum(cnt, 1), logits

    (value, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return float(value), np.asarray(logits), grads


def _port_loss_grads(model, tb, txs, layers=None):
    layers = layers or [l.partition(0) for l in tb.layers]
    model.zero_grad(set_to_none=True)
    logits = model.forward_local(layers, txs[0])
    nll, cnt, _ = _local_ce(logits, tb.labels[0])
    loss = nll / cnt.clamp(min=1)
    loss.backward()
    return float(loss.detach()), logits.detach().numpy()


def _assert_grads(model, jgrads, tol=GRAD_TOL):
    for name, p in model.named_parameters():
        layer, leaf = name.split("/")
        want = np.asarray(jgrads[layer][leaf])
        if p.grad is None:  # the last layer averages heads: no bias
            assert name == f"layer_{len(FANOUTS) - 1}/b" and not want.any()
            continue
        assert np.isfinite(p.grad.numpy()).all(), name
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=name, **tol)


# -- P = 1 -------------------------------------------------------------------


@pytest.fixture
def p1(small_graph):
    """Fresh samplers of both packages at P = 1, same seed."""
    tg = random_graph(**GRAPH_KW)
    pmap = np.zeros(tg.num_nodes, np.int32)
    js = JaxSplitSampler(small_graph, small_graph.train_nodes(), pmap, 1,
                         FANOUTS, BATCH, seed=3)
    ts = SplitSampler(tg, tg.train_nodes(), pmap, 1, FANOUTS, BATCH, seed=3,
                      scatter_plans=PLANS, device="cpu")
    return tg, js, ts


def _coo(batch):
    return dataclasses.replace(batch, layers=[
        dataclasses.replace(l, nbr_idx=None) for l in batch.layers])


@pytest.mark.parametrize("branch", ["batched", "coo"])
def test_one_partition_matches_jax(small_graph, p1, params, branch):
    tg, js, ts = p1
    jb, tb = next(iter(js)), next(iter(ts))
    assert all(l.nbr_idx is not None for l in tb.layers)
    if branch == "coo":
        jb, tb = _coo(jb), _coo(tb)
    jxs, txs = _jax_xs(small_graph, jb), _torch_xs(tg, tb)
    jloss, jlogits, jgrads = _jax_loss_grads(_jax_model(), params, jb, jxs)
    model = _port_model(params)
    loss, logits = _port_loss_grads(model, tb, txs)
    np.testing.assert_allclose(logits, jlogits, **LOGIT_TOL)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_grads(model, jgrads)
    np.testing.assert_allclose(
        make_split_forward(model)(tb, txs)[0].numpy(), jlogits, **LOGIT_TOL)


def test_device_synthesized_layer0_matches_jax(small_graph):
    """Layer 0 synthesized from the resident CSR at deg <= fanout (all
    neighbours in order, no draw, so threefry and Philox agree) feeds the
    batched branch: logits, loss and gradients against JAX's."""
    tg = random_graph(**GRAPH_KW)
    pmap = np.zeros(tg.num_nodes, np.int32)
    fanouts = [int(np.diff(tg.indptr).max())] * 2
    jplan = JaxCachePlan(small_graph, pmap, 1, 1.0, refresh_cap=8)
    jnat = JaxNative(small_graph, small_graph.train_nodes(), pmap, 1, fanouts,
                     BATCH, seed=3, cache=jplan, num_workers=1,
                     innermost="device")
    tplan = CachePlan(tg, pmap, 1, 1.0, refresh_cap=8)
    tnat = NativeSplitSampler(tg, tg.train_nodes(), pmap, 1, fanouts, BATCH,
                              seed=3, cache=tplan, num_workers=1,
                              innermost="device", scatter_plans=PLANS,
                              device="cpu")
    nodes = tg.train_nodes()[:BATCH]
    jb, tb = jnat.sample_batch(nodes), tnat.sample_batch(nodes)
    jnat.close()
    tnat.close()
    assert tb.layers[0].device_sampled
    jm = JaxSplitGAT(GRAPH_KW["feature_dim"], HIDDEN,
                     GRAPH_KW["num_classes"], 2, num_heads=HEADS)
    prm = jm.init(jax.random.PRNGKey(5))
    jcsr = jax_device_csr(small_graph)
    jlayers = jax_materialize([_unstack(l) for l in jb.layers], jcsr,
                              jax.random.PRNGKey(0))
    jxs = JaxFeatureCache(jplan).frames
    jloss, jlogits, jgrads = _jax_loss_grads(jm, prm, jb, jxs, jlayers)

    model = SplitGAT(GRAPH_KW["feature_dim"], HIDDEN,
                     GRAPH_KW["num_classes"], 2, num_heads=HEADS)
    model.load_state_dict(params_from_jax(prm))
    frames = SplitFeatureCache(tplan, device="cpu").frames
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jxs))
    step = make_split_train_step(model, torch.optim.SGD(model.parameters(),
                                                        lr=0.0),
                                 csr=make_device_csr(tg, "cpu"))
    loss, _, _ = step(tb, frames,
                      sample_generator=torch.Generator().manual_seed(0))
    logits = make_split_forward(model, csr=make_device_csr(tg, "cpu"))(
        tb, frames, sample_generator=torch.Generator().manual_seed(1))[0]
    np.testing.assert_allclose(logits.numpy(), jlogits, **LOGIT_TOL)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_grads(model, jgrads)


def test_dense_equals_coo_and_single_chip(p1):
    """The batched branch equals the COO branch on the same sliced batch,
    and both equal the port's single-chip GAT on ``raw_to_single_batch``
    of the same raw sample, with the same weights."""
    tg, _, ts = p1
    raw = ts._sample_raw(tg.train_nodes()[:BATCH])
    batch = ts.slice_raw(raw)
    model = SplitGAT(tg.feature_dim, HIDDEN, tg.num_classes, len(FANOUTS),
                     num_heads=HEADS,
                     generator=torch.Generator().manual_seed(4))
    fwd = make_split_forward(model)
    xs = _torch_xs(tg, batch)
    dense, coo = fwd(batch, xs)[0], fwd(_coo(batch), xs)[0]
    np.testing.assert_allclose(dense.numpy(), coo.numpy(), **LOGIT_TOL)
    single = raw_to_single_batch(raw, tg, ts.caps, "cpu")
    single_model = GATModel(tg.feature_dim, HIDDEN, tg.num_classes,
                            len(FANOUTS), num_heads=HEADS)
    single_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = single_model.eval()(
            single, gather_features(tg.features, single.input_nodes, "cpu"))
    n = raw[0].frontier.shape[0]
    np.testing.assert_allclose(dense[:n].numpy(), ref[:n].numpy(),
                               **LOGIT_TOL)


def test_bf16_storage_matches_jax(small_graph, p1, params):
    """A bf16 frame reaches layer 0 (split GAT's activations stay f32, as
    the JAX trainer builds it without a dtype)."""
    tg, js, ts = p1
    jb, tb = next(iter(js)), next(iter(ts))
    jxs = _jax_xs(small_graph, jb).astype(jnp.bfloat16)
    txs = _torch_xs(tg, tb).to(torch.bfloat16)
    jlogits = np.asarray(jax_forward(_jax_model(), make_mesh(1))(
        params, jb, jxs))
    tlogits = make_split_forward(_port_model(params))(tb, txs)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), jlogits, **BF16_TOL)


def test_adam_steps_match_jax_at_one_partition(small_graph, p1, params):
    tg, js, ts = p1
    opt = optax.adam(LR)
    prm, opt_state = params, opt.init(params)
    jstep = jax_step(_jax_model(), opt, make_mesh(1))
    model = _port_model(params)
    tstep = make_split_train_step(model, torch.optim.Adam(model.parameters(),
                                                          lr=LR))
    for _, jb, tb in zip(range(ADAM_STEPS), js, ts):
        prm, opt_state, jloss, jc, jt = jstep(prm, opt_state, jb,
                                              _jax_xs(small_graph, jb))
        tloss, tc, tt = tstep(tb, _torch_xs(tg, tb))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert (int(tc), int(tt)) == (int(jc), int(jt))
    for name, p in model.named_parameters():
        layer, leaf = name.split("/")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(prm[layer][leaf]),
                                   err_msg=name, **WEIGHT_TOL)


# -- P = 4 -------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(small_graph):
    pmap = partition_graph(small_graph, P, mode="greedy", attach=False)
    return dict(graph=GRAPH_KW, pmap=pmap, fanouts=FANOUTS, batch=BATCH,
                seed=SEED, hidden=HIDDEN, heads=HEADS)


@pytest.fixture(scope="module")
def port4(setup):
    """The port's P = 4 batch (all rows) and P = 1 batch of one raw
    sample, in this process."""
    tg = random_graph(**GRAPH_KW)
    s4 = SplitSampler(tg, tg.train_nodes(), setup["pmap"], P, FANOUTS, BATCH,
                      seed=SEED, scatter_plans=PLANS, device="cpu")
    raw = s4._sample_raw(tg.train_nodes()[:BATCH])
    s1 = SplitSampler(tg, tg.train_nodes(), np.zeros(tg.num_nodes, np.int32),
                      1, FANOUTS, BATCH, seed=SEED, scatter_plans=PLANS,
                      device="cpu")
    return tg, raw, s4.slice_raw(raw), s1.slice_raw(raw), s1.caps


def _shuffle_inputs(batch):
    """Per layer: attention-term frames, (m, s, v) partials with some rows
    of no edge (m = -inf, zero sums), and the loss weights."""
    rng = np.random.default_rng(0)
    frames, ms, ss, vs, weights = [], [], [], [], []
    for lyr in batch.layers:
        shape = (P, lyr.dst_cap, HEADS)
        frames.append(rng.standard_normal(shape).astype(np.float32))
        m = rng.standard_normal(shape).astype(np.float32)
        s = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        v = rng.standard_normal(shape + (SHUFFLE_DH,)).astype(np.float32)
        empty = rng.random(shape[:2]) < 0.2
        m[empty], s[empty], v[empty] = -np.inf, 0.0, 0.0
        ms.append(m), ss.append(s), vs.append(v)
        weights.append(tuple(rng.standard_normal(a.shape).astype(np.float32)
                             for a in (frames[-1], s, v)))
    return frames, ms, ss, vs, weights


@pytest.fixture(scope="module")
def ranks(setup, port4, params):
    """Every rank's results, from one spawn of 4 gloo ranks."""
    _, _, b4, _, _ = port4
    inputs = _shuffle_inputs(b4)
    state = {n: t.numpy() for n, t in params_from_jax(params).items()}
    return run_ranks(gat_rank, P, setup, inputs, state, ADAM_STEPS, LR), inputs


def _padded_shuffle(lyr):
    push, recv = lyr.push_idx.numpy(), lyr.recv_idx.numpy()
    return (push == -1).any() and (recv == lyr.dst_cap).any() and (
        push >= 0).any()


def test_reverse_shuffle_matches_reference(port4, ranks):
    _, _, b4, _, _ = port4
    out, (frames, _, _, _, weights) = ranks
    for l, lyr in enumerate(b4.layers):
        assert _padded_shuffle(lyr)
        x = torch.from_numpy(frames[l]).requires_grad_()
        ref = reverse_shuffle_reference(x, lyr.push_idx, lyr.recv_idx)
        (ref * torch.from_numpy(weights[l][0])).sum().backward()
        for r in range(P):
            got = out[r]["shuffle"][l]  # rank r's [1, ...] rows
            np.testing.assert_allclose(got["er"],
                                       ref[r:r + 1].detach().numpy(),
                                       **OP_TOL)
            np.testing.assert_allclose(got["frame_grad"],
                                       x.grad[r:r + 1].numpy(), **OP_TOL)
        # Foreign rows were written, and took no gradient through the write.
        assert not np.allclose(ref.detach().numpy(), frames[l])


def test_softmax_merge_matches_reference(port4, ranks):
    _, _, b4, _, _ = port4
    out, (_, ms, ss, vs, weights) = ranks
    for l, lyr in enumerate(b4.layers):
        s = torch.from_numpy(ss[l]).requires_grad_()
        v = torch.from_numpy(vs[l]).requires_grad_()
        rs, rv = shuffle_softmax_merge_reference(
            torch.from_numpy(ms[l]), s, v, lyr.push_idx, lyr.recv_idx)
        ((rs * torch.from_numpy(weights[l][1])).sum()
         + (rv * torch.from_numpy(weights[l][2])).sum()).backward()
        assert np.isfinite(rs.detach().numpy()).all()
        for r in range(P):
            got = out[r]["shuffle"][l]  # rank r's [1, ...] rows
            mine = slice(r, r + 1)
            for key, want in (("s", rs[mine]), ("v", rv[mine]),
                              ("s_grad", s.grad[mine]),
                              ("v_grad", v.grad[mine])):
                assert np.isfinite(got[key]).all(), key
                np.testing.assert_allclose(got[key], want.detach().numpy(),
                                           err_msg=key, **OP_TOL)


def _mapped(fn, nargs):
    return jax.shard_map(fn, mesh=make_mesh(P), in_specs=(PS("p"),) * nargs,
                         out_specs=PS("p"), check_vma=False)


@pytest.mark.parametrize("op", ["reverse_shuffle", "softmax_merge"])
def test_references_match_jax(port4, op):
    _, _, b4, _, _ = port4
    frames, ms, ss, vs, weights = _shuffle_inputs(b4)
    for l, lyr in enumerate(b4.layers):
        push = jnp.asarray(lyr.push_idx.numpy())
        recv = jnp.asarray(lyr.recv_idx.numpy())
        D = lyr.dst_cap
        if op == "reverse_shuffle":
            f = _mapped(lambda x, pu, re: jsplit.reverse_shuffle(
                x[0], pu[0], re[0], D)[None], 3)
            w = weights[l][0]
            jout = f(jnp.asarray(frames[l]), push, recv)
            jgrad = jax.grad(lambda x: jnp.sum(f(x, push, recv) * w))(
                jnp.asarray(frames[l]))
            x = torch.from_numpy(frames[l]).requires_grad_()
            ref = reverse_shuffle_reference(x, lyr.push_idx, lyr.recv_idx)
            (ref * torch.from_numpy(w)).sum().backward()
            pairs = [(ref, jout), (x.grad, jgrad)]
        else:
            def merge(m, s, v, pu, re):
                so, vo = jsplit.shuffle_softmax_merge(m[0], s[0], v[0], pu[0],
                                                      re[0], D)
                return jnp.concatenate([so, vo.reshape(D, -1)], -1)[None]

            f = _mapped(merge, 5)
            m = jnp.asarray(ms[l])
            wcat = np.concatenate(
                [weights[l][1], weights[l][2].reshape(P, D, -1)], -1)
            jout = f(m, jnp.asarray(ss[l]), jnp.asarray(vs[l]), push, recv)
            jgs, jgv = jax.grad(
                lambda s, v: jnp.sum(f(m, s, v, push, recv) * wcat),
                argnums=(0, 1))(jnp.asarray(ss[l]), jnp.asarray(vs[l]))
            s = torch.from_numpy(ss[l]).requires_grad_()
            v = torch.from_numpy(vs[l]).requires_grad_()
            rs, rv = shuffle_softmax_merge_reference(
                torch.from_numpy(ms[l]), s, v, lyr.push_idx, lyr.recv_idx)
            ref = torch.cat([rs, rv.reshape(P, D, -1)], -1)
            (ref * torch.from_numpy(wcat)).sum().backward()
            pairs = [(ref, jout), (s.grad, jgs), (v.grad, jgv)]
        for got, want in pairs:
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       **OP_TOL)


def _jax_p4_loss_and_grads(params, jb, jxs):
    jm = _jax_model()

    def body(prm, layers, labels, xs):
        logits = jm.forward_local(prm, [_unstack(l) for l in layers], xs[0])
        nll, cnt, _ = jax_local_ce(logits, labels[0])
        return jax.lax.psum(nll, "p") / jnp.maximum(jax.lax.psum(cnt, "p"), 1)

    mapped = jax.shard_map(body, mesh=make_mesh(P),
                           in_specs=(PS(), PS("p"), PS("p"), PS("p")),
                           out_specs=PS(), check_vma=False)
    return jax.jit(jax.value_and_grad(
        lambda prm: mapped(prm, jb.layers, jb.labels, jxs)))(params)


@pytest.fixture(scope="module")
def jax4(small_graph, setup):
    js = JaxSplitSampler(small_graph, small_graph.train_nodes(),
                         setup["pmap"], P, FANOUTS, BATCH, seed=SEED)
    jb = js.slice_raw(js._sample_raw(small_graph.train_nodes()[:BATCH]))
    return jb, _jax_xs(small_graph, jb)


def test_four_partitions_logits_match_jax_and_one_partition(
        setup, port4, jax4, params, ranks):
    tg, raw, b4, b1, caps1 = port4
    jb, jxs = jax4
    out, _ = ranks
    jlogits = np.asarray(jax_forward(_jax_model(), make_mesh(P))(params, jb,
                                                                  jxs))
    model = _port_model(params)
    logits1 = make_split_forward(model)(b1, _torch_xs(tg, b1))[0].numpy()
    # The port's single-chip GAT on the same raw sample.
    single = raw_to_single_batch(raw, tg, caps1, "cpu")
    single_model = GATModel(tg.feature_dim, HIDDEN, tg.num_classes,
                            len(FANOUTS), num_heads=HEADS)
    single_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        logits_single = single_model.eval()(single, gather_features(
            tg.features, single.input_nodes, "cpu")).numpy()
    targets = raw[0].frontier
    for r in range(P):
        got = out[r]["split"]["logits"]
        np.testing.assert_allclose(got, jlogits[r], **LOGIT_TOL)
        rows = np.nonzero(setup["pmap"][targets] == r)[0]
        assert rows.size > 0
        np.testing.assert_allclose(got[: rows.size], logits1[rows],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(got[: rows.size], logits_single[rows],
                                   **LOGIT_TOL)


def test_four_partitions_loss_and_grads_match_jax_and_one_partition(
        port4, jax4, params, ranks):
    """Each layer's dst frames hold rows with no valid local leaf (m = -inf
    after the mask): the gradients stay finite and equal JAX's."""
    tg, raw, b4, b1, _ = port4
    jb, jxs = jax4
    out, _ = ranks
    for lyr in b4.layers:
        no_leaf = (lyr.nbr_idx == lyr.src_cap - 1).all(dim=1)  # [P, D]
        assert no_leaf.any(dim=1).all()
    jloss, jgrads = _jax_p4_loss_and_grads(params, jb, jxs)
    model1 = _port_model(params)
    loss1, _, count1 = make_split_train_step(
        model1, torch.optim.SGD(model1.parameters(), lr=0.0))(
            b1, _torch_xs(tg, b1))
    for r in range(P):
        got = out[r]["split"]
        assert got["count"] == int(count1) == raw[0].frontier.shape[0]
        np.testing.assert_allclose(got["loss"], float(jloss), **GRAD_TOL)
        np.testing.assert_allclose(got["loss"], float(loss1), **GRAD_TOL)
        for name, p in model1.named_parameters():
            layer, leaf = name.split("/")
            g = got["grads"][name]
            assert np.isfinite(g).all(), name
            np.testing.assert_allclose(g, np.asarray(jgrads[layer][leaf]),
                                       err_msg=name, **GRAD_TOL)
            np.testing.assert_allclose(g, p.grad.numpy(), err_msg=name,
                                       **GRAD_TOL)


def test_four_partitions_count_two_all_to_alls_a_layer(port4, ranks):
    """A step runs a reverse shuffle and a merge on every layer, forward
    and backward; the bytes are the padded payloads sent to the other
    three ranks: K floats a row for the reverse shuffle both ways, K(2 +
    Dh) for the merge forward and K(1 + Dh) backward (no max)."""
    _, _, b4, _, _ = port4
    out, _ = ranks
    outs = [HIDDEN] * (len(FANOUTS) - 1) + [GRAPH_KW["num_classes"]]
    rows = [P * lyr.push_idx.shape[-1] * (P - 1) // P for lyr in b4.layers]
    fwd = sum(r * HEADS * (1 + 2 + d) * 4 for r, d in zip(rows, outs))
    bwd = sum(r * HEADS * (1 + 1 + d) * 4 for r, d in zip(rows, outs))
    for r in range(P):
        assert out[r]["split"]["shuffles"] == {
            "forward": 2 * len(FANOUTS), "backward": 2 * len(FANOUTS),
            "bytes_sent": fwd + bwd}


def test_four_partitions_adam_steps_match_jax(small_graph, setup, params,
                                              ranks):
    out, _ = ranks
    opt = optax.adam(LR)
    prm, opt_state = params, opt.init(params)
    jstep = jax_step(_jax_model(), opt, make_mesh(P))
    js = JaxSplitSampler(small_graph, small_graph.train_nodes(),
                         setup["pmap"], P, FANOUTS, BATCH, seed=SEED)
    jlosses = []
    for _, jb in zip(range(ADAM_STEPS), js):
        prm, opt_state, loss, _, _ = jstep(prm, opt_state, jb,
                                           _jax_xs(small_graph, jb))
        jlosses.append(float(loss))
    for r in range(P):
        got = out[r]["adam"]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
        for name, w in got["weights"].items():
            layer, leaf = name.split("/")
            np.testing.assert_allclose(w, np.asarray(prm[layer][leaf]),
                                       err_msg=name, **WEIGHT_TOL)
            np.testing.assert_array_equal(w, out[0]["adam"]["weights"][name])


# -- the CLI and checkpoints --------------------------------------------------


SMOKE = ["--graph", "community", "--mode", "split", "--model-name", "gat",
         "--num-heads", "2", "--fan-out", "5,5", "--batch-size", "256",
         "--num-nodes", "3000", "--num-epochs", "2", "--cpu",
         "--cpu-devices", "1"]


@pytest.mark.parametrize("variant,jax_acc", [
    (["--cache-per", "auto"], 0.9703),
    (["--cache-per", "auto", "--partitions", "2"], 0.9707),
], ids=["one-partition", "two-partitions"])
def test_cli_split_gat_converges(variant, jax_acc):
    """``jax_acc``: the JAX CLI's train accuracy with the same flags (at
    --partitions 1 and 2). The two draw different weights, so the port
    must come within 0.01."""
    m = train.main(SMOKE + variant)
    assert m["steps"] == 20 and m["innermost"] == "device"
    assert m["acc"] >= jax_acc - 0.01, m
    if "--partitions" in variant:
        # Layer 0 is synthesized (no shuffle); layer 1 runs both shuffles
        # forward and backward.
        assert m["shuffle"]["forward"] == m["shuffle"]["backward"] == 40


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_gat_checkpoint_resumes_across_packages(tmp_path, direction):
    """GAT weights (``w``, ``attn_l``, ``attn_r``, ``b``) and Adam state
    load in the other package exactly, and the next update is the same."""
    jm = JaxSplitGAT(*DIMS, num_heads=HEADS)
    path = str(tmp_path / "split_epoch.npz")
    if direction == "jax-to-port":
        params = jm.init(jax.random.PRNGKey(0))
        opt_state = optax.adam(LR).init(params)
        for seed in range(3):
            params, opt_state = _jax_update(params, opt_state,
                                            _grads(seed, params))
        jax_ckpt.save_checkpoint(path, params, opt_state, 2)
        model = SplitGAT(*DIMS, num_heads=HEADS)
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        assert port_ckpt.load_checkpoint(path, model, opt) == 2
    else:
        model = SplitGAT(*DIMS, num_heads=HEADS,
                         generator=torch.Generator().manual_seed(1))
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        like = {f"layer_{i}": {k: v.detach().numpy()
                               for k, v in model.layer_params(i).items()}
                for i in range(DIMS[3])}
        for seed in range(2):
            _port_update(model, opt, _grads(seed, like))
        port_ckpt.save_checkpoint(path, model, opt, 5)
        template = jm.init(jax.random.PRNGKey(3))
        params, opt_state, epoch = jax_ckpt.load_checkpoint(
            path, template, optax.adam(LR).init(template))
        assert epoch == 5
    assert set(params["layer_0"]) == {"w", "attn_l", "attn_r", "b"}
    _assert_same(model, opt, params, opt_state)
    g = _grads(9, params)
    params, opt_state = _jax_update(params, opt_state, g)
    _port_update(model, opt, g)
    _assert_same(model, opt, params, opt_state, exact=False)
