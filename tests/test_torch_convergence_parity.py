"""Thirty training steps of the port against thirty of the JAX package.

SAGE and GAT at P = 1: both packages start from the same weights
(``params_from_jax``), take the same sampled batches (both slicers get
the same seed, which gives the same batches) and the same Adam, for 30
steps; then both classify the same held-out batches. The limits are the
ones JAX's tests/test_convergence_parity.py:214-237 holds JAX to against
its torch twin: the first 5 losses step for step, the mean gap over the
curve, and the test accuracy.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from occ_gnn_tpu.parallel.model import SplitGAT as JaxSplitGAT
from occ_gnn_tpu.parallel.model import SplitSAGE as JaxSplitSAGE
from occ_gnn_tpu.parallel.model import make_split_forward as jax_forward
from occ_gnn_tpu.parallel.model import make_split_train_step as jax_step
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling.slicer import SplitSampler as JaxSplitSampler
from occ_gnn_tpu.training import gather_features as jax_gather
from occ_gnn_tpu_torch.data import block_graph
from occ_gnn_tpu_torch.parallel.model import (
    SplitGAT,
    SplitSAGE,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.sampling.slicer import SplitSampler
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax

STEPS, LR, FANOUTS, BATCH, TEST_BATCH = 30, 1e-2, [5, 5], 128, 64
# tests/conftest.py's community_graph.
GRAPH_KW = dict(num_nodes=800, num_blocks=4, avg_degree=10,
                cross_fraction=0.05, feature_dim=16, seed=2)
# model, its arguments, (first-5 tolerance, mean gap, accuracy gap, floor)
MODELS = {
    "sage": ((JaxSplitSAGE, SplitSAGE), dict(hidden=32), {},
             (2e-3, 0.05, 0.05, 0.85)),
    "gat": ((JaxSplitGAT, SplitGAT), dict(hidden=16), dict(num_heads=2),
            (5e-3, 0.08, 0.06, 0.8)),
}


def _samplers(jg, tg, nodes, batch, seed):
    pmap = np.zeros(tg.num_nodes, np.int32)
    return (JaxSplitSampler(jg, nodes, pmap, 1, FANOUTS, batch, seed=seed),
            SplitSampler(tg, nodes, pmap, 1, FANOUTS, batch, seed=seed,
                         device="cpu"))


def _steps(sampler):
    """STEPS batches, epoch after epoch."""
    out = []
    while len(out) < STEPS:
        out.extend(sampler)
    return out[:STEPS]


def _xs(gather, g, batch, port):
    if port:
        return gather(g.features, batch.input_nodes_host[0], "cpu")[None]
    return jnp.stack([gather(g.features, batch.input_nodes[0])])


@pytest.mark.parametrize("kind", list(MODELS))
def test_thirty_steps_track_jax(community_graph, kind):
    (jcls, tcls), dims, kw, (first5, mean_gap, acc_gap, floor) = MODELS[kind]
    jg, tg = community_graph, block_graph(**GRAPH_KW)
    np.testing.assert_array_equal(jg.indices, tg.indices)
    args = (jg.feature_dim, dims["hidden"], jg.num_classes, len(FANOUTS))
    jm = jcls(*args, **kw)
    params = jm.init(jax.random.PRNGKey(0))
    model = tcls(*args, **kw)
    model.load_state_dict(params_from_jax(params))

    opt = optax.adam(LR)
    opt_state = opt.init(params)
    jstep = jax_step(jm, opt, make_mesh(1))
    tstep = make_split_train_step(model, torch.optim.Adam(model.parameters(),
                                                          lr=LR))
    js, ts = _samplers(jg, tg, tg.train_nodes(), BATCH, seed=11)
    lj, lt = [], []
    for jb, tb in zip(_steps(js), _steps(ts)):
        params, opt_state, loss, _, _ = jstep(
            params, opt_state, jb, _xs(jax_gather, jg, jb, False))
        lj.append(float(loss))
        lt.append(float(tstep(tb, _xs(gather_features, tg, tb, True))[0]))
    assert len(lj) == len(lt) == STEPS

    test_nodes = np.nonzero(tg.test_mask)[0]
    js, ts = _samplers(jg, tg, test_nodes, TEST_BATCH, seed=4)
    jfwd, tfwd = jax_forward(jm, make_mesh(1)), make_split_forward(model)
    correct_j = correct_t = total = 0
    for jb, tb in zip(js, ts):
        yj = np.asarray(jb.labels[0])
        yt = tb.labels[0].numpy()
        np.testing.assert_array_equal(yj, yt)
        valid = yt >= 0
        pj = np.asarray(jfwd(params, jb, _xs(jax_gather, jg, jb, False))[0])
        pt = tfwd(tb, _xs(gather_features, tg, tb, True))[0].numpy()
        correct_j += int((pj.argmax(-1)[valid] == yj[valid]).sum())
        correct_t += int((pt.argmax(-1)[valid] == yt[valid]).sum())
        total += int(valid.sum())
    acc_j, acc_t = correct_j / total, correct_t / total

    np.testing.assert_allclose(lt[:5], lj[:5], rtol=first5, atol=first5)
    assert np.mean(np.abs(np.array(lj) - np.array(lt))) < mean_gap, (lj, lt)
    assert acc_j > floor and acc_t > floor, (acc_j, acc_t)
    assert abs(acc_j - acc_t) < acc_gap, (acc_j, acc_t)
