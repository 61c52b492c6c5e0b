"""GCN's ``norm="sym"`` in the port against the JAX package's:
``ops.segment.spmm_sym`` (JAX ``ops/segment.py:113-136``) and
``GCNModel(norm="sym")`` (JAX ``models/gcn.py:20-62``), with the same
inputs and weights. On the CPU the sorted segment-sum takes its plain
version; on a CUDA tensor the weighted messages go through the kernel
(``chip_smoke.py`` counts its launches).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occ_gnn_tpu.models import GCNModel as JaxGCN
from occ_gnn_tpu.models.common import masked_cross_entropy as jax_ce
from occ_gnn_tpu.ops.segment import spmm_sym as jax_spmm_sym
from occ_gnn_tpu.sampling.neighbor import NeighborSampler as JaxSampler
from occ_gnn_tpu.training import gather_features as jax_gather
from occ_gnn_tpu_torch.models import GCNModel, get_model
from occ_gnn_tpu_torch.models.common import masked_cross_entropy
from occ_gnn_tpu_torch.ops.segment import spmm_sym
from occ_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax

# tests/test_segment_ops.py:125-144's tolerance against the dense A_hat.
DENSE_TOL = dict(rtol=1e-4, atol=1e-5)
# f32 on the CPU in both packages, sums taken in another order.
TOL = dict(rtol=1e-5, atol=1e-5)
FANOUTS, BATCH, HIDDEN = [4, 3, 5], 48, 6


def _coo(seed, num_src=30, num_dst=18, num_edges=120, edge_cap=160, h=6):
    """tests/test_segment_ops.py's random padded COO: sorted dst, padding
    edges (src 0, dst num_dst) at the end."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_src, size=num_edges).astype(np.int32)
    dst = np.sort(rng.integers(0, num_dst, size=num_edges)).astype(np.int32)
    pad = edge_cap - num_edges
    src_p = np.concatenate([src, np.zeros(pad, np.int32)])
    dst_p = np.concatenate([dst, np.full(pad, num_dst, np.int32)])
    x = rng.standard_normal((num_src, h)).astype(np.float32)
    return src, dst, src_p, dst_p, x


def test_spmm_sym_matches_dense_and_jax():
    S, D = 30, 18
    src, dst, src_p, dst_p, x = _coo(7, S, D)
    deg_in = np.bincount(dst, minlength=D).astype(np.float32)
    deg_out = np.bincount(src, minlength=S).astype(np.float32)
    golden = np.zeros((D, x.shape[1]), np.float32)
    for u, v in zip(src, dst):
        golden[v] += x[u] / np.sqrt(max(deg_out[u], 1) * max(deg_in[v], 1))
    got = spmm_sym(torch.from_numpy(x), torch.from_numpy(src_p),
                   torch.from_numpy(dst_p), D, S)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), golden, **DENSE_TOL)
    want = np.asarray(jax_spmm_sym(jnp.asarray(x), jnp.asarray(src_p),
                                   jnp.asarray(dst_p), D, S))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_spmm_sym_gradient_matches_jax():
    S, D = 30, 18
    _, _, src_p, dst_p, x = _coo(8, S, D)
    w = np.random.default_rng(9).standard_normal((D, x.shape[1])).astype(
        np.float32)
    jgrad = jax.grad(lambda a: jnp.sum(jax_spmm_sym(
        a, jnp.asarray(src_p), jnp.asarray(dst_p), D, S) * w))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (spmm_sym(xt, torch.from_numpy(src_p), torch.from_numpy(dst_p), D, S)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **TOL)


def test_gcn_sym_logits_and_gradients_match_jax(small_graph):
    g = small_graph
    jm = JaxGCN(g.feature_dim, HIDDEN, g.num_classes, len(FANOUTS),
                norm="sym")
    params = jm.init(jax.random.PRNGKey(3))
    tm = get_model("gcn", g.feature_dim, HIDDEN, g.num_classes, len(FANOUTS),
                   norm="sym")
    assert isinstance(tm, GCNModel) and tm.norm == "sym"
    tm.load_state_dict(params_from_jax(params))
    nodes = g.train_nodes()
    jb = next(iter(JaxSampler(g, nodes, FANOUTS, BATCH, seed=5)))
    tb = next(iter(NeighborSampler(g, nodes, FANOUTS, BATCH, seed=5,
                                   device="cpu")))
    jx0 = jax_gather(g.features, jb.input_nodes)
    tx0 = gather_features(g.features, tb.input_nodes, "cpu")
    jlogits = np.asarray(jm.apply(params, jb, jx0))
    jgrads = jax.grad(lambda p: jax_ce(jm.apply(p, jb, jx0), jb.labels))(
        params)
    tlogits = tm(tb, tx0)
    masked_cross_entropy(tlogits, tb.labels).backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, **TOL)
    # sym differs from mean on the same weights: the normalization ran.
    mean = GCNModel(g.feature_dim, HIDDEN, g.num_classes, len(FANOUTS))
    mean.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert not np.allclose(mean(tb, tx0).numpy(), jlogits, atol=1e-3)
    for name, p in tm.named_parameters():
        layer, leaf = name.split("/")
        assert np.isfinite(p.grad.numpy()).all(), name
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgrads[layer][leaf]),
                                   err_msg=name, **TOL)


def test_other_norms_raise_as_jax():
    texts = []
    for build in (JaxGCN, GCNModel):
        with pytest.raises(ValueError) as err:
            build(8, 8, 3, 2, norm="rw")
        texts.append(str(err.value))
    assert texts[0] == texts[1] == "norm must be 'mean' or 'sym', got 'rw'"
