"""``--mode quiver`` in the port against the JAX package's device sampler.

torch's Philox draws cannot match JAX's threefry draws, so the parity
checks run on the ring graph of JAX tests/test_device_sampler.py, where
every node has one in-neighbour and a fan-out of 1 determines every
draw: there the dense logits, one trainer step's loss and the weights
after its Adam step must equal JAX's (rtol 1e-5, atol 1e-6 for the
logits and loss, 1e-5 for the weights), at P = 1 and over 4 gloo ranks
(spawned once for the module). On a random graph the draws are checked
as in-neighbours and for uniformity.
"""

import numpy as np
import optax
import pytest
import torch
from scipy.stats import chi2

import jax
import jax.numpy as jnp

from occ_gnn_tpu.data.graph import Graph as JaxGraph
from occ_gnn_tpu.models import SAGEModel as JaxSAGE
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling import device_sampler as jds
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.data.graph import Graph
from occ_gnn_tpu_torch.models import SAGEModel
from occ_gnn_tpu_torch.parallel.dist import DistContext
from occ_gnn_tpu_torch.parallel.model import make_device_csr
from occ_gnn_tpu_torch.sampling.device_sampler import (
    DeviceSampleTrainer,
    dense_frontiers,
    sample_neighbors_dense,
)
from occ_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax
from torch_ranks import quiver_rank, run_ranks

P = 4
RING_N, FANOUTS, BATCH, HIDDEN, SEED, LR = 64, [1, 1], 32, 16, 3, 1e-2
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-5)
CLI = ["--graph", "community", "--num-nodes", "1500", "--fan-out", "4,4",
       "--batch-size", "128", "--num-hidden", "16", "--num-epochs", "2",
       "--feature-dim", "16", "--cpu", "--cpu-devices", "1", "--mode",
       "quiver"]


def _ring(n=RING_N, feature_dim=8, num_classes=4, seed=0) -> dict:
    """JAX tests/test_device_sampler.py's ring: node v's one in-neighbour
    is v - 1."""
    rng = np.random.default_rng(seed)
    return dict(
        indptr=np.arange(n + 1, dtype=np.int64),
        indices=((np.arange(n) - 1) % n).astype(np.int64),
        features=rng.standard_normal((n, feature_dim)).astype(np.float32),
        labels=rng.integers(0, num_classes, n).astype(np.int32),
        num_classes=num_classes, train_mask=np.ones(n, dtype=bool))


@pytest.fixture(scope="module")
def ring():
    arrays = _ring()
    params = JaxSAGE(8, HIDDEN, arrays["num_classes"], len(FANOUTS)).init(
        jax.random.PRNGKey(0))
    return arrays, params


def _port_model(params):
    model = SAGEModel(8, HIDDEN, 4, len(FANOUTS))
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.fixture(scope="module")
def ranks(ring):
    arrays, params = ring
    state = {n: t.numpy() for n, t in params_from_jax(params).items()}
    setup = dict(ring=arrays, fanouts=FANOUTS, batch=BATCH, seed=SEED,
                 hidden=HIDDEN, graph=dict(feature_dim=8, num_classes=4))
    return run_ranks(quiver_rank, P, setup, state, LR)


def _dense_logits(model, g, targets, seed):
    """JAX's ``dense_logits`` in the port: the trainer's draw and forward
    of ``targets`` (its one batch, at P = 1)."""
    trainer = DeviceSampleTrainer(g, FANOUTS, len(targets), model, None,
                                  seed=seed, device="cpu")
    with torch.no_grad():
        return trainer.forward(trainer.sample(
            torch.as_tensor(targets, dtype=torch.int32))).numpy()


def test_dense_logits_match_jax_and_host_path(ring):
    arrays, params = ring
    g = Graph(**arrays)
    model = _port_model(params).eval()
    targets = np.arange(0, 32, dtype=np.int64)
    sampler = NeighborSampler(g, targets, FANOUTS, 32, seed=0, device="cpu")
    batch = sampler.sample_batch(targets)
    with torch.no_grad():
        host = model(batch, gather_features(g.features, batch.input_nodes,
                                            "cpu"))[: len(targets)].numpy()
    dev = _dense_logits(model, g, targets, seed=7)
    jg = JaxGraph(**arrays)
    jdev = np.asarray(jds.dense_logits(
        params, jds.device_csr(jg), jnp.asarray(jg.features),
        jnp.asarray(targets, dtype=jnp.int32), FANOUTS,
        jax.random.PRNGKey(7)))
    np.testing.assert_allclose(dev, jdev, **LOGIT_TOL)
    np.testing.assert_allclose(dev, host, **LOGIT_TOL)


def test_pad_targets_read_node_zero(ring):
    arrays, params = ring
    g = Graph(**arrays)
    model = _port_model(params).eval()
    np.testing.assert_array_equal(_dense_logits(model, g, [5, -1, 9], 1),
                                  _dense_logits(model, g, [5, 0, 9], 1))


def test_zero_degree_nodes_sample_self():
    # Nodes 0..3 isolated, node 4 has in-neighbours {0, 1}; node 3's
    # indptr entry is the edge count, one past the last edge.
    g = Graph(indptr=np.array([0, 0, 0, 0, 0, 2]), indices=np.array([0, 1]),
              features=np.zeros((5, 4), np.float32),
              labels=np.zeros(5, np.int32), num_classes=2)
    nbr = sample_neighbors_dense(make_device_csr(g, "cpu"),
                                 torch.arange(5, dtype=torch.int32), 3,
                                 torch.Generator().manual_seed(0)).numpy()
    assert nbr.dtype == np.int32 and nbr.shape == (5, 3)
    for v in range(4):
        assert (nbr[v] == v).all()
    assert np.isin(nbr[4], [0, 1]).all()


def test_frontier_shapes():
    g = Graph(**_ring(n=128))
    fr = dense_frontiers(make_device_csr(g, "cpu"),
                         torch.zeros(8, dtype=torch.int32), [3, 2],
                         torch.Generator().manual_seed(0))
    assert [int(f.shape[0]) for f in fr] == [8, 8 * 4, 8 * 4 * 3]
    # Each layer's frontier starts with the one before it.
    for a, b in zip(fr, fr[1:]):
        np.testing.assert_array_equal(b[: a.shape[0]].numpy(), a.numpy())


def test_draws_are_uniform_in_neighbours():
    """Every draw is an in-neighbour of its node, and each node's draws
    are uniform over its adjacency (counted with multiplicity): the
    chi-square statistic of 4,000 draws a node stays below its 1e-4
    upper quantile for every one of 12 nodes."""
    g = random_graph(num_nodes=400, avg_degree=8, feature_dim=4, seed=2)
    deg = np.diff(g.indptr)
    nodes = np.nonzero(deg >= 5)[0][:12]
    draws = 4000
    frontier = torch.from_numpy(np.repeat(nodes, 40).astype(np.int32))
    nbr = sample_neighbors_dense(make_device_csr(g, "cpu"), frontier, 100,
                                 torch.Generator().manual_seed(4)).numpy()
    for i, v in enumerate(nodes):
        got = nbr[40 * i : 40 * (i + 1)].reshape(-1)
        adj = g.indices[g.indptr[v] : g.indptr[v + 1]]
        assert np.isin(got, adj).all()
        vals, mult = np.unique(adj, return_counts=True)
        seen = np.array([(got == u).sum() for u in vals])
        expected = draws * mult / adj.shape[0]
        stat = ((seen - expected) ** 2 / expected).sum()
        assert vals.shape[0] == 1 or stat < chi2.ppf(1 - 1e-4,
                                                     vals.shape[0] - 1)


def _jax_trainer_step(arrays, params, num_ranks):
    """JAX's ``DeviceSampleTrainer`` step on its first batch -> (params,
    loss, correct, count)."""
    opt = optax.adam(LR)
    drv = jds.DeviceSampleTrainer(JaxGraph(**arrays), FANOUTS, BATCH,
                                  make_mesh(num_ranks), opt, seed=SEED)
    targets, labels = next(drv.epoch_batches(np.arange(RING_N)))
    keys = jnp.broadcast_to(jax.random.PRNGKey(1),
                            (num_ranks, 2))
    prm, _, loss, correct, count = drv.step_fn(
        params, opt.init(params), drv.csr, drv.features,
        jnp.asarray(targets), jnp.asarray(labels), keys)
    return prm, float(loss), int(correct), int(count)


def _assert_weights(got: dict, tree):
    for name, value in got.items():
        layer, leaf = name.split("/")
        np.testing.assert_allclose(value, np.asarray(tree[layer][leaf]),
                                   err_msg=name, **WEIGHT_TOL)


def test_trainer_step_matches_jax_one_rank(ring):
    arrays, params = ring
    g = Graph(**arrays)
    model = _port_model(params)
    trainer = DeviceSampleTrainer(
        g, FANOUTS, BATCH, model, torch.optim.Adam(model.parameters(),
                                                   lr=LR),
        seed=SEED, device="cpu")
    loss, correct, count = trainer.step(*next(trainer.epoch_batches(
        g.train_nodes())))
    jp, jloss, jcorrect, jcount = _jax_trainer_step(arrays, params, 1)
    np.testing.assert_allclose(float(loss), jloss, **LOGIT_TOL)
    assert (int(correct), int(count)) == (jcorrect, jcount) and jcount == BATCH
    _assert_weights({n: p.detach().numpy()
                     for n, p in model.named_parameters()}, jp)


def test_trainer_step_matches_jax_four_ranks(ring, ranks):
    arrays, params = ring
    jp, jloss, jcorrect, jcount = _jax_trainer_step(arrays, params, P)
    for r in range(P):
        got = ranks[r]
        np.testing.assert_allclose(got["loss"], jloss, **LOGIT_TOL)
        assert (got["correct"], got["count"]) == (jcorrect, jcount)
        _assert_weights(got["weights"], jp)
        for name, w in got["weights"].items():
            np.testing.assert_array_equal(w, ranks[0]["weights"][name])


def test_epoch_batches_split_one_permutation():
    """Every rank draws the same permutation and takes its row of each
    [P, B / P] batch; the ragged tail has label -1; B % P raises."""
    g = Graph(**_ring(n=70))
    model = SAGEModel(8, HIDDEN, 4, 2)
    opt = torch.optim.Adam(model.parameters())

    ranks = DistContext(0, P, "gloo", torch.device("cpu"), 0, 1)
    trainer = DeviceSampleTrainer(g, FANOUTS, BATCH, model, opt, seed=SEED,
                                  device="cpu", ranks=ranks)
    batches = list(trainer.epoch_batches(g.train_nodes()))
    assert len(batches) == 3 and batches[0][0].shape == (P, BATCH // P)
    targets = np.concatenate([t.reshape(-1) for t, _ in batches])
    labels = np.concatenate([lab.reshape(-1) for _, lab in batches])
    order = np.random.default_rng(SEED).permutation(70)
    np.testing.assert_array_equal(targets[:70], order)
    assert (labels[70:] == -1).all() and (targets[70:] == 0).all()
    with pytest.raises(ValueError, match="divisible"):
        DeviceSampleTrainer(g, FANOUTS, 30, model, opt, device="cpu",
                            ranks=ranks)


def test_bfloat16_runs_finite():
    g = random_graph(num_nodes=600, avg_degree=6, feature_dim=16, seed=3)
    model = SAGEModel(16, HIDDEN, g.num_classes, 2)
    trainer = DeviceSampleTrainer(
        g, [4, 3], 64, model, torch.optim.Adam(model.parameters(), lr=LR),
        dtype=torch.bfloat16, device="cpu")
    assert trainer.features.dtype == torch.bfloat16
    loss, correct, total = trainer.train_epoch(g.train_nodes())
    assert np.isfinite(loss) and total == g.train_nodes().shape[0]
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("extra", [[], ["--partitions", "2"],
                                   ["--dtype", "bfloat16"]],
                         ids=["P1", "P2", "bf16"])
def test_cli_converges(extra):
    metrics = train.main(CLI + extra)
    assert metrics["mode"] == "quiver" and metrics["steps"] == 20
    assert np.isfinite(metrics["loss"]) and metrics["acc"] > 0.5, metrics
    assert set(metrics["phases"]) == {"fused_step"}


def test_cli_refuses_other_models():
    with pytest.raises(SystemExit, match="supports --model-name sage"):
        train.main(CLI + ["--model-name", "gat"])
