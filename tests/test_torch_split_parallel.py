"""Split-parallel training at P = 4 in the port against the JAX package.

The pattern of tests/test_split_parallel.py: one raw sample sliced 4 ways
by both packages' slicers (same seed, same partition map). The port runs
it as 4 gloo ranks on the CPU, each with its own partition's row
(``emit_range``), spawned once for the module (tests/torch_ranks.py);
JAX runs it on 4 virtual CPU devices.

  * ``shuffle_merge`` (the all-to-all autograd Function) against its plain
    reference over all P partitions, forward and gradients, with padded
    ``push_idx`` / ``recv_idx``; the reference against JAX's shuffle;
  * the logits of each rank against JAX's P = 4 forward and against the
    port's P = 1 forward of the same raw sample, for SAGE and GCN;
  * the global loss and all-reduced gradients of a step with lr 0 against
    JAX's P = 4 step and the port's P = 1 path (rtol 1e-4, atol 1e-5);
  * the weights after 3 Adam steps against JAX (1e-5).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from occ_gnn_tpu.data import partition_graph
from occ_gnn_tpu.parallel import split as jsplit
from occ_gnn_tpu.parallel.model import SplitGCN as JaxSplitGCN
from occ_gnn_tpu.parallel.model import SplitSAGE as JaxSplitSAGE
from occ_gnn_tpu.parallel.model import _local_ce as jax_local_ce
from occ_gnn_tpu.parallel.model import _unstack
from occ_gnn_tpu.parallel.model import make_split_forward as jax_forward
from occ_gnn_tpu.parallel.model import make_split_train_step as jax_step
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling.slicer import SplitSampler as JaxSplitSampler
from occ_gnn_tpu.training import gather_features as jax_gather
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.parallel.model import (
    SplitGCN,
    SplitSAGE,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.parallel.split import shuffle_merge_reference
from occ_gnn_tpu_torch.sampling.slicer import SplitSampler
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax
from torch_ranks import everything_rank, run_ranks

P = 4
GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
FANOUTS, BATCH, HIDDEN, SEED = [4, 3], 32, 16, 7
ADAM_STEPS, LR = 3, 1e-2
SHUFFLE_H = 8
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-5)
# The shuffle: f32 sums of at most P terms in another order.
OP_TOL = dict(rtol=1e-6, atol=1e-6)
KINDS = ("sage", "gcn")
JAX_MODELS = {"sage": JaxSplitSAGE, "gcn": JaxSplitGCN}
PORT_MODELS = {"sage": SplitSAGE, "gcn": SplitGCN}


@pytest.fixture(scope="module")
def setup(small_graph):
    pmap = partition_graph(small_graph, P, mode="greedy", attach=False)
    return dict(graph=GRAPH_KW, pmap=pmap, fanouts=FANOUTS, batch=BATCH,
                seed=SEED, hidden=HIDDEN)


@pytest.fixture(scope="module")
def params(small_graph):
    g = small_graph
    return {k: JAX_MODELS[k](g.feature_dim, HIDDEN, g.num_classes,
                             len(FANOUTS)).init(jax.random.PRNGKey(i))
            for i, k in enumerate(KINDS)}


@pytest.fixture(scope="module")
def port(setup):
    """The port's P = 4 batch (all rows) and P = 1 batch of one raw
    sample, in this process."""
    tg = random_graph(**GRAPH_KW)
    s4 = SplitSampler(tg, tg.train_nodes(), setup["pmap"], P, FANOUTS, BATCH,
                      seed=SEED, device="cpu")
    raw = s4._sample_raw(tg.train_nodes()[:BATCH])
    s1 = SplitSampler(tg, tg.train_nodes(), np.zeros(tg.num_nodes, np.int32),
                      1, FANOUTS, BATCH, seed=SEED, device="cpu")
    return tg, raw, s4.slice_raw(raw), s1.slice_raw(raw)


@pytest.fixture(scope="module")
def jax_batch(small_graph, setup):
    js = JaxSplitSampler(small_graph, small_graph.train_nodes(),
                         setup["pmap"], P, FANOUTS, BATCH, seed=SEED)
    jb = js.slice_raw(js._sample_raw(small_graph.train_nodes()[:BATCH]))
    return jb, _jax_xs(small_graph, jb)


@pytest.fixture(scope="module")
def ranks(setup, port, params):
    """Every rank's results, from one spawn of 4 gloo ranks."""
    _, _, b4, _ = port
    rng = np.random.default_rng(0)
    neighs = [rng.standard_normal((P, l.dst_cap, SHUFFLE_H)).astype(np.float32)
              for l in b4.layers]
    weights = [rng.standard_normal(n.shape).astype(np.float32)
               for n in neighs]
    states = {k: {n: t.numpy() for n, t in params_from_jax(p).items()}
              for k, p in params.items()}
    out = run_ranks(everything_rank, P, setup, neighs, weights, states,
                    ADAM_STEPS, LR)
    return out, neighs, weights


def _jax_xs(g, batch):
    return jnp.stack([jax_gather(g.features, batch.input_nodes[p])
                      for p in range(batch.input_nodes.shape[0])])


def _port_model(g, kind, params):
    model = PORT_MODELS[kind](g.feature_dim, HIDDEN, g.num_classes,
                              len(FANOUTS))
    model.load_state_dict(params_from_jax(params))
    return model


def _padded_shuffle(lyr):
    push, recv = lyr.push_idx.numpy(), lyr.recv_idx.numpy()
    return (push == -1).any() and (recv == lyr.dst_cap).any() and (
        push >= 0).any()


def test_shuffle_merge_matches_reference(port, ranks):
    _, _, b4, _ = port
    out, neighs, weights = ranks
    for l, lyr in enumerate(b4.layers):
        assert _padded_shuffle(lyr)
        x = torch.from_numpy(neighs[l]).requires_grad_()
        ref = shuffle_merge_reference(x, lyr.push_idx, lyr.recv_idx)
        (ref * torch.from_numpy(weights[l])).sum().backward()
        for r in range(P):
            # Rank r holds partition r: its [1, ...] rows.
            merged, grad = out[r]["shuffle"][l]
            np.testing.assert_allclose(merged, ref[r:r + 1].detach().numpy(),
                                       **OP_TOL)
            np.testing.assert_allclose(grad, x.grad[r:r + 1].numpy(),
                                       **OP_TOL)
        # The boundary rows did move: the merge is not the identity.
        assert not np.allclose(ref.detach().numpy(), neighs[l])


def test_shuffle_merge_reference_matches_jax(port):
    _, _, b4, _ = port
    rng = np.random.default_rng(1)
    mesh = make_mesh(P)
    for lyr in b4.layers:
        x = rng.standard_normal((P, lyr.dst_cap, SHUFFLE_H)).astype(np.float32)
        w = rng.standard_normal(x.shape).astype(np.float32)
        push, recv = jnp.asarray(lyr.push_idx.numpy()), jnp.asarray(
            lyr.recv_idx.numpy())

        def body(xx, pu, re):
            return jsplit.shuffle_merge(xx[0], pu[0], re[0])[None]

        mapped = jax.jit(jax.shard_map(body, mesh=mesh,
                                       in_specs=(PS("p"),) * 3,
                                       out_specs=PS("p"), check_vma=False))
        jout = mapped(jnp.asarray(x), push, recv)
        jgrad = jax.jit(jax.grad(
            lambda xx: jnp.sum(mapped(xx, push, recv) * w)))(jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        tout = shuffle_merge_reference(tx, lyr.push_idx, lyr.recv_idx)
        (tout * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   **OP_TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                                   **OP_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_logits_match_jax_and_one_partition(small_graph, setup, port,
                                            jax_batch, params, ranks, kind):
    tg, raw, _, b1 = port
    jb, jxs = jax_batch
    out, _, _ = ranks
    jm = JAX_MODELS[kind](tg.feature_dim, HIDDEN, tg.num_classes,
                          len(FANOUTS))
    jlogits = np.asarray(jax_forward(jm, make_mesh(P))(params[kind], jb, jxs))
    x1 = gather_features(tg.features, b1.input_nodes_host[0], "cpu")[None]
    logits1 = make_split_forward(_port_model(tg, kind, params[kind]))(
        b1, x1)[0].numpy()
    targets = raw[0].frontier
    for r in range(P):
        got = out[r]["split"][kind]["logits"]
        np.testing.assert_allclose(got, jlogits[r], **LOGIT_TOL)
        rows = np.nonzero(setup["pmap"][targets] == r)[0]
        assert rows.size > 0
        np.testing.assert_allclose(got[: rows.size], logits1[rows],
                                   **LOGIT_TOL)


def _jax_loss_and_grads(jm, params, jb, jxs):
    mesh = make_mesh(P)

    def body(prm, layers, labels, xs):
        layers_l = [_unstack(l) for l in layers]
        logits = jm.forward_local(prm, layers_l, xs[0])
        nll, cnt, _ = jax_local_ce(logits, labels[0])
        return jax.lax.psum(nll, "p") / jnp.maximum(jax.lax.psum(cnt, "p"), 1)

    mapped = jax.shard_map(body, mesh=mesh,
                           in_specs=(PS(), PS("p"), PS("p"), PS("p")),
                           out_specs=PS(), check_vma=False)
    return jax.jit(jax.value_and_grad(
        lambda prm: mapped(prm, jb.layers, jb.labels, jxs)))(params)


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_grads_match_jax_and_one_partition(port, jax_batch, params,
                                                    ranks, kind):
    tg, raw, _, b1 = port
    jb, jxs = jax_batch
    out, _, _ = ranks
    jm = JAX_MODELS[kind](tg.feature_dim, HIDDEN, tg.num_classes,
                          len(FANOUTS))
    jloss, jgrads = _jax_loss_and_grads(jm, params[kind], jb, jxs)
    model1 = _port_model(tg, kind, params[kind])
    x1 = gather_features(tg.features, b1.input_nodes_host[0], "cpu")[None]
    loss1, correct1, count1 = make_split_train_step(
        model1, torch.optim.SGD(model1.parameters(), lr=0.0))(b1, x1)
    for r in range(P):
        got = out[r]["split"][kind]
        assert got["count"] == int(count1) == raw[0].frontier.shape[0]
        assert got["correct"] == int(correct1)
        np.testing.assert_allclose(got["loss"], float(jloss), **GRAD_TOL)
        np.testing.assert_allclose(got["loss"], float(loss1), **GRAD_TOL)
        for name, p in model1.named_parameters():
            layer, leaf = name.split("/")
            np.testing.assert_allclose(got["grads"][name],
                                       np.asarray(jgrads[layer][leaf]),
                                       err_msg=name, **GRAD_TOL)
            np.testing.assert_allclose(got["grads"][name], p.grad.numpy(),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_adam_steps_match_jax(small_graph, setup, params, ranks, kind):
    out, _, _ = ranks
    jm = JAX_MODELS[kind](small_graph.feature_dim, HIDDEN,
                          small_graph.num_classes, len(FANOUTS))
    opt = optax.adam(LR)
    prm, opt_state = params[kind], opt.init(params[kind])
    jstep = jax_step(jm, opt, make_mesh(P))
    js = JaxSplitSampler(small_graph, small_graph.train_nodes(),
                         setup["pmap"], P, FANOUTS, BATCH, seed=SEED)
    jlosses = []
    for _, jb in zip(range(ADAM_STEPS), js):
        prm, opt_state, loss, _, _ = jstep(prm, opt_state, jb,
                                           _jax_xs(small_graph, jb))
        jlosses.append(float(loss))
    for r in range(P):
        got = out[r]["adam"][kind]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
        for name, w in got["weights"].items():
            layer, leaf = name.split("/")
            np.testing.assert_allclose(w, np.asarray(prm[layer][leaf]),
                                       err_msg=name, **WEIGHT_TOL)
            np.testing.assert_array_equal(
                w, out[0]["adam"][kind]["weights"][name])


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_emit_range_rows_equal_the_full_batch(setup, kind):
    """A rank's sampler (``emit_range``) and cache frame (``partitions``)
    hold exactly its row of the all-partitions batch, and the frame rows
    the batch reads, under a refreshing cache (0.1 < 1/P), for both
    samplers. (Tail rows past a partition's fill are never read and may
    hold anything, as in the JAX package.)"""
    from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
    from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler

    tg = random_graph(**GRAPH_KW)
    pmap = setup["pmap"]
    cls = NativeSplitSampler if kind == "native" else SplitSampler

    def make(rows):
        plan = CachePlan(tg, pmap, P, 0.1, refresh_cap=BATCH * 20)
        cache = SplitFeatureCache(plan, device="cpu", partitions=rows)
        sampler = cls(tg, tg.train_nodes(), pmap, P, FANOUTS, BATCH,
                      seed=SEED, cache=cache, emit_range=rows, device="cpu")
        batch = next(iter(sampler))
        if kind == "native":
            sampler.close()
        return batch, cache

    full, full_cache = make(None)
    mine, my_cache = make((2, 3))
    assert full_cache.plan.needs_refresh and my_cache.tail_batches == 1
    l0 = mine.layers[0]
    read = torch.cat([t.reshape(-1) for t in (l0.edge_src, l0.nbr_idx,
                                               l0.self_idx)
                      if t is not None]).unique()
    assert (read >= full_cache.plan.tail_start).any()  # tail rows read
    np.testing.assert_array_equal(my_cache.frames[0][read].numpy(),
                                  full_cache.frames[2][read].numpy())
    for lf, lm in zip(full.layers, mine.layers):
        for name in ("edge_src", "edge_dst", "push_idx", "recv_idx",
                     "owned_idx", "owned_deg", "self_idx", "owned_mask",
                     "num_owned", "nbr_idx"):
            a, b = getattr(lf, name), getattr(lm, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), a[2:3].numpy(),
                                              err_msg=name)
    for name in ("labels", "target_nodes"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      getattr(full, name)[2:3].numpy())
