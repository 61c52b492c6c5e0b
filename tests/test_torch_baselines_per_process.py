"""Several shards per process for ``--mode ddp`` and ``quiver`` in the port,
against the JAX trainer, which runs all P shards in one process over a
``make_mesh(P)`` device mesh.

  (a) ddp, one process of 4 shards, against JAX's ``make_dp_train_step``
      on a 4-device mesh fed the same four shard batches, for SAGE, GCN
      and GAT: loss, correct, count, the gradients (lr 0) and the weights
      after one Adam step, at tests/test_torch_ddp.py's tolerances;
  (b) quiver, one process of 4 rows, against JAX's
      ``DeviceSampleTrainer`` on a 4-device mesh, on the ring graph of
      tests/test_torch_quiver.py, where a fan-out of 1 forces every draw:
      the same quantities;
  (c) the placements (W processes, L shards each) = (1, 4), (2, 2) and
      (4, 1) of ddp and of quiver through the CLI with dropout 0.5: equal
      loss, accuracy and steps, weights within ``WEIGHT_TOL``;
  (d) the ddp CLI at ``--partitions 4`` in one process against the JAX
      CLI with the same flags, from the same initial weights;
  (e) a run of one process creates no process group.
"""

import numpy as np
import optax
import pytest
import torch

import jax

from occ_gnn_tpu import train as jax_train
from occ_gnn_tpu.data.graph import Graph as JaxGraph
from occ_gnn_tpu.models import SAGEModel as JaxSAGE
from occ_gnn_tpu.models import get_model as jax_get_model
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling import device_sampler as jds
from occ_gnn_tpu_torch import models, train
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.data.graph import Graph
from occ_gnn_tpu_torch.parallel import dist
from occ_gnn_tpu_torch.parallel.dp import make_dp_train_step
from occ_gnn_tpu_torch.sampling.device_sampler import DeviceSampleTrainer
from occ_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_ddp import (
    BATCH,
    FANOUTS,
    GRAD_TOL,
    GRAPH_KW,
    HIDDEN,
    KINDS,
    LOSS_TOL,
    LR,
    SEED,
    WEIGHT_TOL,
    _assert_tree,
    _grad_capture,
    _jax_step,
    _kw,
    _setup,
)
from test_torch_quiver import LOGIT_TOL, RING_N, _port_model, _ring
from test_torch_quiver import BATCH as RING_BATCH
from test_torch_quiver import FANOUTS as RING_FANOUTS
from test_torch_quiver import HIDDEN as RING_HIDDEN
from test_torch_quiver import SEED as RING_SEED
from torch_ranks import run_cli

P = 4
PLACEMENTS = [(1, 4), (2, 2), (4, 1)]
# The flags of tests/test_torch_ddp.py's CLI tests, at 4 shards.
CLI = ["--graph", "community", "--num-nodes", "1500", "--fan-out", "4,4",
       "--batch-size", "128", "--num-hidden", "16", "--num-epochs", "2",
       "--feature-dim", "16", "--cpu", "--partitions", str(P)]


def _weights(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


# -- (a) ddp: one process of 4 shards against JAX's 4-device mesh -----------


@pytest.fixture(scope="module")
def ddp_params(small_graph):
    g = small_graph
    return {k: jax_get_model(k, g.feature_dim, HIDDEN, g.num_classes,
                             len(FANOUTS), **_kw(k)).init(
                                 jax.random.PRNGKey(i))
            for i, k in enumerate(KINDS)}


def _shard_batches(setup):
    """The first batch of each of the P shards, as JAX's trainer samples
    them (shard p with seed ``SEED + p``), and its input frame."""
    g = random_graph(**GRAPH_KW)
    batches = [next(iter(NeighborSampler(
        g, setup["shards"][p], FANOUTS, setup["per_dev"],
        capacities=setup["caps"], seed=SEED + p, drop_last=True,
        device="cpu"))) for p in range(P)]
    return batches, [gather_features(g.features, b.input_nodes, "cpu")
                     for b in batches]


def _port_dp_model(kind, params):
    model = models.get_model(kind, GRAPH_KW["feature_dim"], HIDDEN,
                             GRAPH_KW["num_classes"], len(FANOUTS),
                             **_kw(kind))
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("kind", KINDS)
def test_ddp_one_process_of_four_shards_matches_jax(small_graph, ddp_params,
                                                    kind):
    setup = _setup(small_graph, P)
    batches, x0s = _shard_batches(setup)
    ranks = dist.single_process(P, "cpu")
    model = _port_dp_model(kind, ddp_params[kind])
    loss, correct, count = make_dp_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.0), ranks)(
            batches, x0s)
    _, jgrads, jloss, jcorrect, jcount = _jax_step(
        small_graph, kind, ddp_params[kind], setup, P, _grad_capture())
    assert int(jcount) == BATCH
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    assert (int(correct), int(count)) == (int(jcorrect), int(jcount))
    _assert_tree({n: p.grad.numpy() for n, p in model.named_parameters()},
                 jgrads, GRAD_TOL)
    model = _port_dp_model(kind, ddp_params[kind])
    make_dp_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                       ranks)(batches, x0s)
    jp, _, _, _, _ = _jax_step(small_graph, kind, ddp_params[kind], setup, P,
                               optax.adam(LR))
    _assert_tree(_weights(model), jp, WEIGHT_TOL)


def test_ddp_step_takes_one_batch_or_a_list():
    """At L = 1 a single batch works as a list of one; the lists must hold
    one batch, one frame and one generator a shard."""
    g = random_graph(**GRAPH_KW)
    batch = next(iter(NeighborSampler(g, g.train_nodes(), FANOUTS, 16,
                                      seed=SEED, device="cpu")))
    x0 = gather_features(g.features, batch.input_nodes, "cpu")
    state = models.get_model("sage", g.feature_dim, HIDDEN, g.num_classes,
                             len(FANOUTS)).state_dict()
    out = []
    for args in ((batch, x0), ([batch], [x0])):
        model = models.get_model("sage", g.feature_dim, HIDDEN,
                                 g.num_classes, len(FANOUTS))
        model.load_state_dict(state)
        loss, _, _ = make_dp_train_step(
            model, torch.optim.Adam(model.parameters(), lr=LR))(*args)
        out.append((float(loss), _weights(model)))
    assert out[0][0] == out[1][0]
    for name, w in out[0][1].items():
        np.testing.assert_array_equal(w, out[1][1][name])
    step = make_dp_train_step(model, torch.optim.SGD(model.parameters(),
                                                     lr=0.0))
    with pytest.raises(ValueError, match="one of each a shard"):
        step([batch, batch], [x0])


# -- (b) quiver: one process of 4 rows against JAX's 4-device mesh ----------


@pytest.fixture(scope="module")
def ring():
    arrays = _ring()
    params = JaxSAGE(8, RING_HIDDEN, arrays["num_classes"],
                     len(RING_FANOUTS)).init(jax.random.PRNGKey(0))
    return arrays, params


def _jax_quiver_step(arrays, params, opt):
    """JAX's ``DeviceSampleTrainer`` step on a 4-device mesh, its first
    batch -> (params, opt_state, loss, correct, count)."""
    drv = jds.DeviceSampleTrainer(JaxGraph(**arrays), RING_FANOUTS,
                                  RING_BATCH, make_mesh(P), opt,
                                  seed=RING_SEED)
    targets, labels = next(drv.epoch_batches(np.arange(RING_N)))
    keys = jax.numpy.broadcast_to(jax.random.PRNGKey(1), (P, 2))
    return drv.step_fn(params, opt.init(params), drv.csr, drv.features,
                       jax.numpy.asarray(targets),
                       jax.numpy.asarray(labels), keys)


def _port_quiver_step(arrays, params, opt_cls, lr):
    g = Graph(**arrays)
    model = _port_model(params)
    trainer = DeviceSampleTrainer(
        g, RING_FANOUTS, RING_BATCH, model, opt_cls(model.parameters(),
                                                    lr=lr),
        seed=RING_SEED, device="cpu", ranks=dist.single_process(P, "cpu"))
    # One feature table and one CSR for the four shards.
    assert trainer.features.shape[0] == g.num_nodes
    assert len(trainer.generators) == len(trainer.dropout_generators) == P
    loss, correct, count = trainer.step(*next(trainer.epoch_batches(
        g.train_nodes())))
    return model, float(loss), int(correct), int(count)


def test_quiver_one_process_of_four_shards_matches_jax(ring):
    arrays, params = ring
    model, loss, correct, count = _port_quiver_step(
        arrays, params, torch.optim.SGD, 0.0)
    _, jgrads, jloss, jcorrect, jcount = _jax_quiver_step(
        arrays, params, _grad_capture())
    assert int(jcount) == RING_BATCH
    np.testing.assert_allclose(loss, float(jloss), **LOGIT_TOL)
    assert (correct, count) == (int(jcorrect), int(jcount))
    _assert_tree({n: p.grad.numpy() for n, p in model.named_parameters()},
                 jgrads, GRAD_TOL)
    model, _, _, _ = _port_quiver_step(arrays, params, torch.optim.Adam, LR)
    jp, _, _, _, _ = _jax_quiver_step(arrays, params, optax.adam(LR))
    _assert_tree(_weights(model), jp, WEIGHT_TOL)


def test_quiver_holds_its_rows_of_every_batch():
    """A process of shards [1, 3) of 4 takes rows 1-2 of each [4, B / 4]
    batch of the permutation every process draws; the ragged tail pads
    whole grid positions, so which shard a pad lands on does not depend
    on the placement."""
    g = Graph(**_ring(n=70))
    model = models.SAGEModel(8, RING_HIDDEN, 4, 2)
    opt = torch.optim.Adam(model.parameters())
    full = DeviceSampleTrainer(g, RING_FANOUTS, RING_BATCH, model, opt,
                               seed=RING_SEED, device="cpu",
                               ranks=dist.single_process(P, "cpu"))
    mine = DeviceSampleTrainer(
        g, RING_FANOUTS, RING_BATCH, model, opt, seed=RING_SEED,
        device="cpu",
        ranks=dist.DistContext(1, 2, "gloo", torch.device("cpu"), 2, 4))
    assert len(mine.generators) == len(mine.dropout_generators) == 2
    for (t1, l1), (t2, l2) in zip(full.epoch_batches(g.train_nodes()),
                                  mine.epoch_batches(g.train_nodes())):
        assert t1.shape == (P, RING_BATCH // P)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(l1, l2)
    # 70 nodes in 3 batches of 32: the last batch's 26 pads fill its grid
    # from slot 6 on, in shard 0's row and the rows after it.
    assert (l1.reshape(-1)[:6] >= 0).all() and (l1.reshape(-1)[6:] == -1).all()
    with pytest.raises(ValueError, match="divisible by the 4 shards"):
        DeviceSampleTrainer(g, RING_FANOUTS, 30, model, opt, device="cpu",
                            ranks=dist.single_process(P, "cpu"))


# -- (c) the placements of ddp and quiver through the CLI -------------------


@pytest.fixture(scope="module", params=["ddp", "quiver"])
def placed_runs(request):
    """The CLI at ``--partitions 4 --dropout 0.5`` under ``--cpu-devices
    4, 2, 1``: one process, two of 2 shards, four of 1."""
    runs = {}
    for W, L in PLACEMENTS:
        runs[W, L] = run_cli(CLI + ["--mode", request.param, "--dropout",
                                    "0.5", "--cpu-devices", str(L)], W)
    return request.param, runs


def test_placements_give_one_run(placed_runs):
    mode, runs = placed_runs
    (one,) = runs[1, 4]
    m1 = one["metrics"]
    assert m1["mode"] == mode and m1["partitions"] == P and m1["steps"] > 0
    for (W, L), procs in runs.items():
        assert [p["metrics"]["partitions_local"] for p in procs] == [
            [k * L, (k + 1) * L] for k in range(W)]
        for proc in procs:
            m = proc["metrics"]
            assert (m["loss"], m["acc"], m["steps"]) == (
                m1["loss"], m1["acc"], m1["steps"]), (W, L)
            assert m["collectives"] == (0 if W == 1 else 2 * m["steps"])
            assert ("backend" in m) == (W > 1)
            for name, w in proc["weights"].items():
                np.testing.assert_allclose(w, one["weights"][name],
                                           err_msg=f"{(W, L)} {name}",
                                           **WEIGHT_TOL)
        # The processes of one run hold bit-equal weights.
        assert len({p["metrics"]["weights_crc32"] for p in procs}) == 1


def test_placed_runs_drop_out(placed_runs):
    """Dropout is on in these runs: the result is not the dropout-free
    one, so the per-shard streams were drawn from."""
    mode, runs = placed_runs
    (plain,) = run_cli(CLI + ["--mode", mode, "--cpu-devices", "4"], 1)
    (one,) = runs[1, 4]
    assert plain["metrics"]["loss"] != one["metrics"]["loss"]


# -- (d) the ddp CLI in one process against the JAX CLI ---------------------


def test_ddp_cli_in_one_process_matches_the_jax_cli(monkeypatch):
    """The same flags (dropout 0) through both CLIs; the port's model
    starts from the JAX trainer's initial weights (``init`` with
    ``PRNGKey(seed)``), so the two runs differ only by rounding: the final
    loss within 1e-4 and the accuracy within 0.002, as the split CLI's
    comparison."""
    flags = CLI + ["--mode", "ddp"]
    jm = jax_train.main(flags)
    real = models.get_model

    def from_jax(kind, *dims, **kw):
        model = real(kind, *dims, **kw)
        kw.pop("generator", None)
        model.load_state_dict(params_from_jax(jax_get_model(
            kind, *dims, **kw).init(jax.random.PRNGKey(0))))
        return model

    monkeypatch.setattr(models, "get_model", from_jax)
    m = train.main(flags + ["--cpu-devices", "4"])
    assert m["partitions"] == jm["partitions"] == P
    assert m["partitions_local"] == [0, P] and m["collectives"] == 0
    assert abs(m["loss"] - jm["loss"]) <= 1e-4, (m["loss"], jm["loss"])
    assert abs(m["acc"] - jm["acc"]) <= 0.002, (m["acc"], jm["acc"])


# -- (e) a run of one process makes no group --------------------------------


@pytest.mark.parametrize("mode", ["ddp", "quiver"])
def test_a_baseline_run_of_one_process_makes_no_group(monkeypatch, mode):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append(a))
    m = train.main(CLI + ["--mode", mode, "--cpu-devices", "4",
                          "--num-epochs", "1"])
    assert not calls and not torch.distributed.is_initialized()
    assert m["partitions"] == P and m["partitions_local"] == [0, P]
    assert m["collectives"] == 0 and "backend" not in m
