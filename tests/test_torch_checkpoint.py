"""Checkpoints across packages: a JAX checkpoint (weights and optax Adam
state) loads into the port's model and ``torch.optim.Adam`` exactly, a
port checkpoint loads in the JAX package's ``load_checkpoint`` exactly,
and from either the next Adam update is the same in both packages."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from occ_gnn_tpu.parallel.model import SplitSAGE as JaxSplitSAGE
from occ_gnn_tpu.utils import checkpoint as jax_ckpt
from occ_gnn_tpu_torch.parallel.model import SplitSAGE
from occ_gnn_tpu_torch.utils import checkpoint as port_ckpt

DIMS = (16, 8, 5, 2)  # in, hidden, classes, layers
LR = 1e-2


def _grads(seed, like):
    rng = np.random.default_rng(seed)
    return {l: {k: rng.standard_normal(np.shape(v)).astype(np.float32)
                for k, v in leaves.items()} for l, leaves in like.items()}


def _jax_update(params, opt_state, grads):
    opt = optax.adam(LR)
    updates, opt_state = opt.update(
        jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params)
    return optax.apply_updates(params, updates), opt_state


def _port_update(model, opt, grads):
    for name, p in model.named_parameters():
        layer, leaf = name.split("/")
        p.grad = torch.from_numpy(grads[layer][leaf])
    opt.step()


def _assert_same(model, opt, params, opt_state, exact=True):
    adam = opt_state[0]
    tol = {} if exact else dict(rtol=1e-6, atol=1e-7)
    check = (np.testing.assert_array_equal if exact else
             lambda a, b, **k: np.testing.assert_allclose(a, b, **tol, **k))
    for name, p in model.named_parameters():
        layer, leaf = name.split("/")
        check(p.detach().numpy(), np.asarray(params[layer][leaf]),
              err_msg=name)
        st = opt.state[p]
        assert int(st["step"]) == int(adam.count)
        check(st["exp_avg"].numpy(), np.asarray(adam.mu[layer][leaf]),
              err_msg=name)
        check(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[layer][leaf]),
              err_msg=name)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    params = JaxSplitSAGE(*DIMS).init(jax.random.PRNGKey(0))
    opt_state = optax.adam(LR).init(params)
    for seed in range(3):
        params, opt_state = _jax_update(params, opt_state,
                                        _grads(seed, params))
    path = str(tmp_path / "split_epoch.npz")
    jax_ckpt.save_checkpoint(path, params, opt_state, 2)

    model = SplitSAGE(*DIMS)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    assert port_ckpt.load_checkpoint(path, model, opt) == 2
    _assert_same(model, opt, params, opt_state)
    g = _grads(9, params)
    params, opt_state = _jax_update(params, opt_state, g)
    _port_update(model, opt, g)
    _assert_same(model, opt, params, opt_state, exact=False)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    model = SplitSAGE(*DIMS, generator=torch.Generator().manual_seed(1))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    like = {f"layer_{i}": {k: v.detach().numpy()
                           for k, v in model.layer_params(i).items()}
            for i in range(DIMS[3])}
    for seed in range(2):
        _port_update(model, opt, _grads(seed, like))
    path = port_ckpt.save_checkpoint(str(tmp_path / "ck" / "split_epoch.npz"),
                                     model, opt, 5)

    template = JaxSplitSAGE(*DIMS).init(jax.random.PRNGKey(3))
    params, opt_state, epoch = jax_ckpt.load_checkpoint(
        path, template, optax.adam(LR).init(template))
    assert epoch == 5
    assert opt_state[0].count.dtype == jnp.int32
    _assert_same(model, opt, params, opt_state)
    g = _grads(7, params)
    params, opt_state = _jax_update(params, opt_state, g)
    _port_update(model, opt, g)
    _assert_same(model, opt, params, opt_state, exact=False)


def test_checkpoint_shapes_must_match(tmp_path):
    model = SplitSAGE(*DIMS)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    path = port_ckpt.save_checkpoint(str(tmp_path / "a.npz"), model, opt, 0)
    with np.load(path) as data:
        assert int(data["opt/0/.count"]) == 0  # no update yet: zero moments
        assert not data["opt/0/.mu/layer_0/w"].any()
    other = SplitSAGE(16, 12, 5, 2)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_ckpt.load_checkpoint(path, other,
                                  torch.optim.Adam(other.parameters()))
