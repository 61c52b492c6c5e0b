"""``--mode ddp`` in the port against the JAX package's data-parallel step.

The same shard batches (both packages' ``NeighborSampler`` are one numpy
code, so one seed gives one batch) and the same weights go through JAX's
``make_dp_train_step`` on a mesh of P CPU devices and through the port's
``make_dp_train_step``: in this process at P = 1, and as 4 gloo ranks
(spawned once for the module, tests/torch_ranks.py) at P = 4. For SAGE,
GCN and GAT: the global loss, correct and count, the all-reduced
gradients (at lr 0, rtol 1e-4 / atol 1e-5 as the split path's) and the
weights after one Adam step (1e-5). Then the CLI at 1 and 2 ranks.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from occ_gnn_tpu.models import get_model as jax_get_model
from occ_gnn_tpu.parallel.dp import make_dp_train_step as jax_dp_step
from occ_gnn_tpu.parallel.dp import stack_batches
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling.neighbor import NeighborSampler as JaxSampler
from occ_gnn_tpu.sampling.neighbor import plan_capacities
from occ_gnn_tpu.training import gather_features as jax_gather
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.models import get_model
from occ_gnn_tpu_torch.parallel.dp import make_dp_train_step
from occ_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax
from torch_ranks import ddp_rank, run_ranks

P = 4
GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
FANOUTS, BATCH, HIDDEN, HEADS, SEED, LR = [4, 3], 64, 16, 2, 7, 1e-2
KINDS = ("sage", "gcn", "gat")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-5)
CLI = ["--graph", "community", "--num-nodes", "1500", "--fan-out", "4,4",
       "--batch-size", "128", "--num-hidden", "16", "--num-epochs", "2",
       "--feature-dim", "16", "--cpu", "--cpu-devices", "1", "--mode",
       "ddp"]


def _kw(kind):
    return {"num_heads": HEADS} if kind == "gat" else {}


@pytest.fixture(scope="module")
def params(small_graph):
    g = small_graph
    return {k: jax_get_model(k, g.feature_dim, HIDDEN, g.num_classes,
                             len(FANOUTS), **_kw(k)).init(
                                 jax.random.PRNGKey(i))
            for i, k in enumerate(KINDS)}


def _setup(g, num_ranks):
    """The JAX trainer's shards and capacities at ``num_ranks``."""
    per_dev = BATCH // num_ranks
    shards = np.array_split(
        np.random.default_rng(SEED).permutation(g.train_nodes()), num_ranks)
    return dict(graph=GRAPH_KW, shards=shards, per_dev=per_dev,
                caps=plan_capacities(per_dev, FANOUTS, g.num_nodes),
                fanouts=FANOUTS, seed=SEED, hidden=HIDDEN, heads=HEADS)


def _grad_capture():
    """An optax transformation whose state is the last gradients it saw
    and whose update is zero: JAX's step then hands back its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_step(jg, kind, params, setup, num_ranks, opt):
    """JAX's DDP step on the first batch of each shard -> (params,
    opt_state, loss, correct, count)."""
    batches = []
    for r in range(num_ranks):
        s = JaxSampler(jg, setup["shards"][r], FANOUTS, setup["per_dev"],
                       capacities=setup["caps"], seed=SEED + r,
                       drop_last=True)
        batches.append(next(iter(s)))
    x0 = jnp.stack([jax_gather(jg.features, b.input_nodes) for b in batches])
    model = jax_get_model(kind, jg.feature_dim, HIDDEN, jg.num_classes,
                          len(FANOUTS), **_kw(kind))
    step = jax_dp_step(model, opt, make_mesh(num_ranks))
    return step(params, opt.init(params), stack_batches(batches), x0)


def _assert_tree(got: dict, tree, tol):
    for name, value in got.items():
        layer, leaf = name.split("/")
        np.testing.assert_allclose(value, np.asarray(tree[layer][leaf]),
                                   err_msg=name, **tol)


@pytest.fixture(scope="module")
def ranks(small_graph, params):
    setup = _setup(small_graph, P)
    states = {k: {n: t.numpy() for n, t in params_from_jax(p).items()}
              for k, p in params.items()}
    return setup, run_ranks(ddp_rank, P, setup, states, LR)


@pytest.mark.parametrize("kind", KINDS)
def test_one_rank_step_matches_jax(small_graph, params, kind):
    """P = 1: no collective; JAX's step on a one-device mesh."""
    setup = _setup(small_graph, 1)
    tg = random_graph(**GRAPH_KW)
    batch = next(iter(NeighborSampler(
        tg, setup["shards"][0], FANOUTS, setup["per_dev"],
        capacities=setup["caps"], seed=SEED, drop_last=True, device="cpu")))
    x0 = gather_features(tg.features, batch.input_nodes, "cpu")
    model = get_model(kind, tg.feature_dim, HIDDEN, tg.num_classes,
                      len(FANOUTS), **_kw(kind))
    model.load_state_dict(params_from_jax(params[kind]))
    loss, correct, count = make_dp_train_step(
        model, torch.optim.Adam(model.parameters(), lr=LR))(batch, x0)
    jp, _, jloss, jcorrect, jcount = _jax_step(
        small_graph, kind, params[kind], setup, 1, optax.adam(LR))
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    assert (int(correct), int(count)) == (int(jcorrect), int(jcount))
    assert int(count) == setup["per_dev"]
    _assert_tree({n: p.detach().numpy() for n, p in model.named_parameters()},
                 jp, WEIGHT_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_four_ranks_match_jax(small_graph, params, ranks, kind):
    """P = 4 gloo ranks against JAX on 4 devices, fed the same four shard
    batches: global loss, correct, count and the all-reduced gradients
    (lr 0), and every rank's weights after one Adam step."""
    setup, out = ranks
    _, grads, jloss, jcorrect, jcount = _jax_step(
        small_graph, kind, params[kind], setup, P, _grad_capture())
    jp, _, _, _, _ = _jax_step(small_graph, kind, params[kind], setup, P,
                               optax.adam(LR))
    assert int(jcount) == BATCH
    for r in range(P):
        got = out[r][kind]
        np.testing.assert_allclose(got["loss"], float(jloss), **LOSS_TOL)
        assert (got["correct"], got["count"]) == (int(jcorrect), int(jcount))
        _assert_tree(got["grads"], grads, GRAD_TOL)
        _assert_tree(got["weights"], jp, WEIGHT_TOL)
        for name, w in got["weights"].items():
            np.testing.assert_array_equal(w, out[0][kind]["weights"][name])


def test_four_ranks_sum_the_shards(ranks, params):
    """The all-reduced gradient is that of the global mean loss over the
    four shard batches, computed here in one process."""
    setup, out = ranks
    tg = random_graph(**GRAPH_KW)
    model = get_model("sage", tg.feature_dim, HIDDEN, tg.num_classes,
                      len(FANOUTS))
    model.load_state_dict(params_from_jax(params["sage"]))
    nll = count = 0
    for r in range(P):
        batch = next(iter(NeighborSampler(
            tg, setup["shards"][r], FANOUTS, setup["per_dev"],
            capacities=setup["caps"], seed=SEED + r, drop_last=True,
            device="cpu")))
        logits = model(batch, gather_features(tg.features,
                                              batch.input_nodes, "cpu"))
        valid = batch.labels >= 0
        logp = torch.log_softmax(logits, -1)[valid]
        nll = nll - logp.gather(-1, batch.labels[valid, None].long()).sum()
        count += int(valid.sum())
    (nll / count).backward()
    for name, p in model.named_parameters():
        for r in range(P):
            np.testing.assert_allclose(out[r]["sage"]["grads"][name],
                                       p.grad.numpy(), err_msg=name,
                                       **GRAD_TOL)
    np.testing.assert_allclose(out[0]["sage"]["loss"],
                               float(nll.detach()) / count,
                               **LOSS_TOL)


@pytest.mark.parametrize("partitions", [1, 2])
def test_cli_converges(partitions):
    metrics = train.main(CLI + ["--partitions", str(partitions)])
    assert metrics["mode"] == "ddp" and metrics["partitions"] == partitions
    assert metrics["steps"] == 18  # 2 epochs of 9 batches of 128 targets
    assert np.isfinite(metrics["loss"]) and metrics["acc"] > 0.5, metrics
    assert set(metrics["phases"]) == {"sample", "feature_gather",
                                      "train_step"}
    assert ("backend" in metrics) == (partitions > 1)


def test_ranks_agree_on_steps_when_shards_differ():
    """129 nodes in 2 shards of 65 and 64 at 13 a rank: rank 0 alone
    could take 5 steps an epoch, rank 1 takes 4; both take 4 and the
    run ends (a rank taking a fifth would wait forever in the
    all-reduce)."""
    metrics = train.main(CLI + ["--partitions", "2", "--limit-train", "129",
                                "--batch-size", "26"])
    assert metrics["steps"] == 2 * 4
    assert np.isfinite(metrics["loss"])
