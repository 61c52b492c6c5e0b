"""The port's GraphSAGE against the JAX package's, with the same weights.

``jax.random`` and ``torch.Generator`` draw different numbers, so the JAX
model is initialised and its weights are carried across with
``params_from_jax``. Both samplers get the same seed, which gives the same
batches (tests/test_torch_sampler.py). Dropout is 0: masks cannot match.
"""

import numpy as np
import optax
import pytest
import torch

import jax

from occ_gnn_tpu.models import SAGEModel as JaxSAGE
from occ_gnn_tpu.models.common import masked_cross_entropy as jax_ce
from occ_gnn_tpu.sampling.neighbor import NeighborSampler as JaxSampler
from occ_gnn_tpu.training import gather_features as jax_gather
from occ_gnn_tpu.training import make_eval_step as jax_eval_step
from occ_gnn_tpu.training import make_train_step as jax_train_step
from occ_gnn_tpu.utils.checkpoint import save_checkpoint
from occ_gnn_tpu_torch.models import SAGEModel, get_model
from occ_gnn_tpu_torch.models.common import masked_cross_entropy
from occ_gnn_tpu_torch.parallel.dp import make_dp_train_step
from occ_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from occ_gnn_tpu_torch.training import gather_features, make_eval_step
from occ_gnn_tpu_torch.utils.checkpoint import load_checkpoint, params_from_jax

# f32 on the CPU in both packages; products and sums of a few hundred
# terms taken in another order.
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Adam divides each gradient by its own magnitude, which amplifies the
# last-digit differences of tiny gradients; three steps of lr 1e-2.
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-5)

FANOUTS, BATCH, HIDDEN = [4, 3, 5], 48, 24


def _models(g, seed=0):
    jm = JaxSAGE(g.feature_dim, HIDDEN, g.num_classes, len(FANOUTS))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = SAGEModel(g.feature_dim, HIDDEN, g.num_classes, len(FANOUTS))
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def _samplers(g, seed=5):
    nodes = g.train_nodes()
    return (JaxSampler(g, nodes, FANOUTS, BATCH, seed=seed),
            NeighborSampler(g, nodes, FANOUTS, BATCH, seed=seed, device="cpu"))


def test_state_dict_keys_follow_the_jax_pytree(small_graph):
    _, params, tm = _models(small_graph)
    assert set(tm.state_dict()) == {f"{layer}/{leaf}" for layer in params
                                    for leaf in params[layer]}
    for layer in params:
        for leaf in params[layer]:
            np.testing.assert_array_equal(
                tm.state_dict()[f"{layer}/{leaf}"].numpy(),
                np.asarray(params[layer][leaf]))


def test_logits_and_gradients_match_jax(small_graph):
    g = small_graph
    jm, params, tm = _models(g)
    js, ts = _samplers(g)
    jb, tb = next(iter(js)), next(iter(ts))
    jx0 = jax_gather(g.features, jb.input_nodes)
    tx0 = gather_features(g.features, tb.input_nodes, "cpu")
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))

    def loss_fn(p):
        return jax_ce(jm.apply(p, jb, jx0), jb.labels)

    jlogits = np.asarray(jm.apply(params, jb, jx0))
    jgrads = jax.grad(loss_fn)(params)
    tlogits = tm(tb, tx0)
    masked_cross_entropy(tlogits, tb.labels).backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, **LOGIT_TOL)
    for name, p in tm.named_parameters():
        layer, leaf = name.split("/")
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgrads[layer][leaf]),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("num_steps", [1, 3])
def test_adam_steps_match_jax(community_graph, num_steps):
    g = community_graph
    jm, params, tm = _models(g, seed=1)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    jstep = jax_train_step(jm, opt)
    tstep = make_dp_train_step(tm, torch.optim.Adam(tm.parameters(),
                                                    lr=1e-2))
    js, ts = _samplers(g, seed=2)
    rng = jax.random.PRNGKey(0)
    for _, jb, tb in zip(range(num_steps), js, ts):
        params, opt_state, jloss, jc, jt = jstep(
            params, opt_state, jb, jax_gather(g.features, jb.input_nodes), rng)
        tx0 = gather_features(g.features, tb.input_nodes, "cpu")
        tloss, tc, tt = tstep(tb, tx0)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert (int(tc), int(tt)) == (int(jc), int(jt))
    for name, p in tm.named_parameters():
        layer, leaf = name.split("/")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[layer][leaf]),
                                   err_msg=name, **WEIGHT_TOL)


def test_jax_checkpoint_predicts_the_same_classes(tmp_path, small_graph):
    g = small_graph
    jm, params, _ = _models(g, seed=3)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params, optax.adam(1e-2).init(params), epoch=4)
    tm = get_model("sage", g.feature_dim, HIDDEN, g.num_classes,
                   len(FANOUTS))
    assert load_checkpoint(path, tm) == 4
    js, ts = _samplers(g, seed=4)
    jb, tb = next(iter(js)), next(iter(ts))
    jx0 = jax_gather(g.features, jb.input_nodes)
    tx0 = gather_features(g.features, tb.input_nodes, "cpu")
    jpred = np.asarray(jm.apply(params, jb, jx0)).argmax(-1)
    with torch.no_grad():
        tpred = tm.eval()(tb, tx0).argmax(-1).numpy()
    valid = np.asarray(jb.labels) >= 0
    np.testing.assert_array_equal(tpred[valid], jpred[valid])
    jloss, jc, jt = jax_eval_step(jm)(params, jb, jx0)
    tloss, tc, tt = make_eval_step(tm)(tb, tx0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert (int(tc), int(tt)) == (int(jc), int(jt))
