"""The port's segment ops against the JAX package's.

The JAX Pallas kernel runs in interpret mode on the CPU, as in
tests/test_pallas_spmm.py; the port's wrapper takes its plain version on
CPU tensors. Tolerance 1e-5: f32 sums of at most a few hundred terms,
taken in another order.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from occ_gnn_tpu.ops import config as jax_config
from occ_gnn_tpu.ops import segment as jseg
from occ_gnn_tpu.ops.pallas_spmm_blocked import (
    segment_sum_sorted as jax_segment_sum_sorted,
    spmm_sum_blocked as jax_spmm_sum_blocked,
)
from occ_gnn_tpu_torch.ops import segment as tseg
from occ_gnn_tpu_torch.ops.segment_sum_sorted import (
    segment_sum_sorted,
    segment_sum_sorted_backward,
    spmm_sum_blocked,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _case(E, D, H, S, cap, seed=0):
    """E valid dst-sorted edges padded to cap (pad dst == D, pad src == 0)."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, D, size=E)).astype(np.int32)
    src = rng.integers(0, S, size=E).astype(np.int32)
    dstp = np.concatenate([dst, np.full(cap - E, D, np.int32)])
    srcp = np.concatenate([src, np.zeros(cap - E, np.int32)])
    x = rng.standard_normal((S, H)).astype(np.float32)
    return x, srcp, dstp


CASES = [
    (3000, 700, 64, 500, 4096),
    (100, 10, 8, 50, 256),
    (5000, 300, 128, 400, 6000),
    (0, 40, 16, 30, 512),      # every edge is padding
    (300, 1, 32, 60, 384),     # num_segments = 1
]


@pytest.mark.parametrize("E,D,H,S,cap", CASES)
def test_segment_sum_sorted_matches_jax(E, D, H, S, cap):
    x, src, dst = _case(E, D, H, S, cap)
    msgs = x[src]
    got = segment_sum_sorted(torch.from_numpy(msgs), torch.from_numpy(dst), D)
    pallas = jax_segment_sum_sorted(jnp.asarray(msgs), jnp.asarray(dst), D)
    xla = jax.ops.segment_sum(jnp.asarray(msgs), jnp.asarray(dst),
                              num_segments=D)
    assert got.shape == (D, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)


@pytest.mark.parametrize("E,D,H,S,cap", CASES[:3])
def test_spmm_sum_blocked_grad_matches_jax(E, D, H, S, cap):
    x, src, dst = _case(E, D, H, S, cap, seed=1)
    cot = np.random.default_rng(2).standard_normal((D, H)).astype(np.float32)
    gj = jax.grad(lambda xx: jnp.sum(
        jax_spmm_sum_blocked(xx, jnp.asarray(src), jnp.asarray(dst), D)
        * cot))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm_sum_blocked(xt, torch.from_numpy(src), torch.from_numpy(dst), D)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), **TOL)


def test_kernel_backward_matches_jax_bwd():
    """The CUDA path's backward is a plain gather; check it on the CPU
    against the JAX custom VJP on the same cotangent (padding rows -> 0)."""
    E, D, H, cap = 700, 90, 24, 1024
    _, _, dst = _case(E, D, H, 10, cap, seed=3)
    msgs = np.random.default_rng(4).standard_normal((cap, H)).astype(np.float32)
    cot = np.random.default_rng(5).standard_normal((D, H)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda m: jax_segment_sum_sorted(m, jnp.asarray(dst), D),
        jnp.asarray(msgs))
    (gj,) = vjp(jnp.asarray(cot))
    gt = segment_sum_sorted_backward(torch.from_numpy(cot),
                                     torch.from_numpy(dst), D)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
    assert not gt[E:].any()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_spmm_sum_and_mean_match_jax(use_pallas):
    x, src, dst = _case(2000, 256, 48, 300, 2304, seed=6)
    w = np.random.default_rng(7).random(2304).astype(np.float32)
    xt, st, dt = (torch.from_numpy(a) for a in (x, src, dst))
    before = jax_config.use_pallas()
    jax_config.set_use_pallas(use_pallas)
    try:
        jsum = jseg.spmm_sum(jnp.asarray(x), jnp.asarray(src),
                             jnp.asarray(dst), 256,
                             edge_weight=jnp.asarray(w))
        jmean = jseg.spmm_mean(jnp.asarray(x), jnp.asarray(src),
                               jnp.asarray(dst), 256)
    finally:
        jax_config.set_use_pallas(before)
    tsum = tseg.spmm_sum(xt, st, dt, 256, edge_weight=torch.from_numpy(w))
    tmean = tseg.spmm_mean(xt, st, dt, 256)
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), **TOL)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), **TOL)


# bf16 keeps 8 significant bits (unit roundoff u = 2^-9). JAX's spmm_sum
# adds a bf16 frame's rows in bf16 and the port in f32, so they differ by
# JAX's rounding: for a row of k adds, at most (k + 1) * u times the sum of
# the terms' magnitudes (the bound of recursive summation, the last
# rounding of the result included), element by element.
BF16_UNIT = 2.0**-9


def test_spmm_sum_and_mean_on_a_bf16_frame_match_jax():
    x, src, dst = _case(2000, 256, 48, 300, 2304, seed=9)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    x_same = np.array(xb.astype(jnp.float32))
    xt = torch.from_numpy(x_same).to(torch.bfloat16)
    st, dt = torch.from_numpy(src), torch.from_numpy(dst)
    jsum = np.asarray(jseg.spmm_sum(xb, jnp.asarray(src), jnp.asarray(dst),
                                    256), np.float32)
    tsum = tseg.spmm_sum(xt, st, dt, 256)
    assert tsum.dtype == torch.float32
    magnitude = np.zeros((257, 48), np.float64)
    np.add.at(magnitude, dst, np.abs(x_same[src]))
    adds = np.bincount(dst, minlength=257)[:256, None]
    bound = (adds + 1) * BF16_UNIT * magnitude[:256]
    assert (np.abs(tsum.numpy() - jsum) <= bound).all()
    # spmm_mean upcasts the frame first in JAX too: the same f32 sums.
    jmean = jseg.spmm_mean(xb, jnp.asarray(src), jnp.asarray(dst), 256)
    tmean = tseg.spmm_mean(xt, st, dt, 256)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), **TOL)
    assert torch.equal(tmean, tseg.spmm_mean(xt.float(), st, dt, 256))


def test_segment_sum_and_mean_match_jax():
    """The plain ops also take unsorted ids and rows of any rank."""
    rng = np.random.default_rng(8)
    data = rng.standard_normal((900, 3, 5)).astype(np.float32)
    ids = rng.integers(0, 61, size=900).astype(np.int32)  # 60 == padding
    for tfn, jfn in ((tseg.segment_sum, jseg.segment_sum),
                     (tseg.segment_mean, jseg.segment_mean)):
        got = tfn(torch.from_numpy(data), torch.from_numpy(ids), 60)
        want = jfn(jnp.asarray(data), jnp.asarray(ids), 60,
                   indices_are_sorted=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_path_launches_no_kernel():
    x, src, dst = _case(500, 50, 16, 40, 512)
    before = segment_sum_sorted.launches
    tseg.spmm_mean(torch.from_numpy(x), torch.from_numpy(src),
                   torch.from_numpy(dst), 50)
    assert segment_sum_sorted.launches == before


@pytest.mark.parametrize("msgs,dst,n,err", [
    (torch.zeros(8, 4, dtype=torch.float64), torch.zeros(8, dtype=torch.int32),
     2, TypeError),
    (torch.zeros(8), torch.zeros(8, dtype=torch.int32), 2, TypeError),
    (torch.zeros(8, 4), torch.zeros(8, dtype=torch.int64), 2, TypeError),
    (torch.zeros(8, 4), torch.zeros(7, dtype=torch.int32), 2, TypeError),
    (torch.zeros(4, 8).t(), torch.zeros(8, dtype=torch.int32), 2, ValueError),
    (torch.zeros(8, 4), torch.zeros(8, dtype=torch.int32), -1, ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(msgs, dst, n, err):
    with pytest.raises(err):
        segment_sum_sorted(msgs, dst, n)
