"""The port's dense gather-sum against the JAX package.

``ops/dense_gather_sum.dense_gather_sum`` is JAX's
``parallel/split.local_aggregate_dense`` (the unrolled K-gather XLA fuses
into one add), and its gradient ``dense_scatter_add`` is the transpose
``jax.vjp`` derives. On CPU tensors the port's wrappers take their plain
versions, which the kernels on the card equal: the forward bit for bit
(the same adds in the order of k), the backward within f32 rounding.

Tolerances. The forward adds the same f32 values in the same order as
XLA's fusion, so it must equal JAX's bit for bit. The f32 gradient sums
each row's terms in another order than XLA's scatter: 1e-5 of the
gradient's scale (at least 1), as the zero row sums every padding slot's
row (hundreds here) and its rounding grows with them. JAX's bf16
gradient rounds each term and each partial sum to bf16, where the port
sums in f32 and rounds once; with cotangents of small integers whose
partial sums stay below 256 in magnitude every partial sum is exact in
both, so the bf16 gradients are held to the same bound.

The last tests hold a numpy model of the backward kernel's blocks (the
zero row's share summed within each block, then added once) against the
plain scatter-add, and the ctypes argument lists against the C entries.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occ_gnn_tpu.parallel import split as jsplit
from occ_gnn_tpu_torch.ops import build
from occ_gnn_tpu_torch.ops import config as tcfg
from occ_gnn_tpu_torch.ops import dense_gather_sum as dgs
from occ_gnn_tpu_torch.parallel import split as tsplit

OP_TOL = dict(rtol=1e-5, atol=1e-5)
SOURCE = Path(dgs.__file__).resolve().parent.parent / "csrc" / \
    "dense_gather_sum.cu"


def _case(S, K, D, H, seed=0):
    """A frame ``x [S, H]`` with its zero row ``S - 1``, and ``nbr [K,
    D]`` with padding slots (the zero row), sources repeated within a
    column and across columns, and the last two columns all padding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, H)).astype(np.float32)
    x[S - 1] = 0.0
    nbr = rng.integers(0, S - 1, (K, D)).astype(np.int32)
    nbr[rng.random((K, D)) < 0.3] = S - 1
    if K > 1 and D > 2:
        nbr[1, ::3] = nbr[0, ::3]           # a source twice in a column
        nbr[:, 1] = nbr[:, 0]                # the same column twice
    if D > 4:
        nbr[:, -2:] = S - 1                  # padding dst columns
    return x, nbr


# (S, K, D, H): split A's widths at small size, K = 1, D = 0, odd widths.
CASES = [
    (60, 6, 40, 12),
    (300, 26, 80, 100),
    (120, 11, 64, 128),
    (40, 1, 30, 8),
    (20, 4, 0, 16),
    (50, 5, 33, 3),
]


def _frame(x, dtype):
    """The frame in both packages: bf16 values made in JAX and read back
    exactly, so both sides hold the same numbers."""
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    same = np.array(xb.astype(jnp.float32))
    return xb, torch.from_numpy(same).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,K,D,H", CASES)
def test_forward_equals_jax_bit_for_bit(S, K, D, H, dtype):
    x, nbr = _case(S, K, D, H)
    jx, tx = _frame(x, dtype)
    got = dgs.dense_gather_sum(tx, torch.from_numpy(nbr))
    want = np.asarray(jsplit.local_aggregate_dense(jx, jnp.asarray(nbr)))
    assert got.shape == (D, H) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _cotangent(D, H, dtype, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.standard_normal((D, H)).astype(np.float32)
    # Small integers: every partial sum of a dx row is exact in bf16.
    return rng.integers(-1, 2, (D, H)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,K,D,H", CASES)
def test_input_grad_matches_jax_vjp(S, K, D, H, dtype):
    x, nbr = _case(S, K, D, H, seed=2)
    g = _cotangent(D, H, dtype)
    jx, tx = _frame(x, dtype)
    _, vjp = jax.vjp(lambda xx: jsplit.local_aggregate_dense(
        xx, jnp.asarray(nbr)), jx)
    (want,) = vjp(jnp.asarray(g))
    tx.requires_grad_()
    out = dgs.dense_gather_sum(tx, torch.from_numpy(nbr))
    out.backward(torch.from_numpy(g))
    assert tx.grad.dtype == tx.dtype and tx.grad.shape == (S, H)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        assert np.abs(want).max(initial=0.0) < 256
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(tx.grad.float().numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_scatter_add_sums_padding_into_the_zero_row():
    """Every padding slot adds its dst's gradient into the zero row, as
    the transpose of the gather does: nothing is dropped."""
    S, K, D, H = 30, 3, 10, 4
    nbr = np.full((K, D), S - 1, np.int32)
    nbr[0] = np.arange(D)
    g = np.arange(D * H, dtype=np.float32).reshape(D, H)
    dx = dgs.dense_scatter_add(torch.from_numpy(g), torch.from_numpy(nbr), S)
    np.testing.assert_array_equal(dx[:D].numpy(), g)
    np.testing.assert_array_equal(dx[S - 1].numpy(), 2 * g.sum(axis=0))
    assert not dx[D:S - 1].any()


@pytest.mark.parametrize("S,K,D,H", [c for c in CASES if c[2] > 0])
def test_tiled_equals_default(S, K, D, H):
    """A dst tile at a time, into slices of the output: the same sums in
    the same order, forward and backward."""
    x, nbr = _case(S, K, D, H, seed=3)
    g = torch.from_numpy(_cotangent(D, H, "float32"))
    outs, grads = [], []
    for tile in (None, 7, D):
        tx = torch.from_numpy(x).requires_grad_()
        out = dgs.dense_gather_sum(tx, torch.from_numpy(nbr), tile)
        out.backward(g)
        outs.append(out.detach().numpy())
        grads.append(tx.grad.numpy())
    for o, gr in zip(outs[1:], grads[1:]):
        np.testing.assert_array_equal(o, outs[0])
        np.testing.assert_array_equal(gr, grads[0])


def test_occ_dense_agg_tiled_goes_through_tiles(monkeypatch):
    """``OCC_DENSE_AGG=tiled`` reaches the wrapper with split's
    ``DENSE_TILE`` and gives the unrolled sums."""
    x, nbr = _case(80, 5, 50, 16, seed=4)
    tiles = []
    real = dgs.dense_gather_sum_reference

    def spy(xx, n, out=None):
        tiles.append(n.shape[1])
        return real(xx, n, out)

    monkeypatch.setattr(dgs, "dense_gather_sum_reference", spy)
    monkeypatch.setattr(tsplit, "DENSE_TILE", 16)
    old = tcfg.dense_agg_impl()
    try:
        unrolled = tsplit.local_aggregate_dense(torch.from_numpy(x),
                                                torch.from_numpy(nbr))
        tcfg.set_dense_agg_impl("tiled")
        tiled = tsplit.local_aggregate_dense(torch.from_numpy(x),
                                             torch.from_numpy(nbr))
    finally:
        tcfg.set_dense_agg_impl(old)
    assert tiles == [50, 16, 16, 16, 2]
    np.testing.assert_array_equal(tiled.numpy(), unrolled.numpy())


def test_cpu_path_launches_no_kernel():
    x, nbr = _case(60, 6, 40, 12)
    before = (dgs.dense_gather_sum.launches, dgs.dense_scatter_add.launches)
    tx = torch.from_numpy(x).requires_grad_()
    dgs.dense_gather_sum(tx, torch.from_numpy(nbr), 8).sum().backward()
    assert tx.grad is not None
    assert (dgs.dense_gather_sum.launches,
            dgs.dense_scatter_add.launches) == before


def _rejects():
    x = torch.zeros(10, 8)
    nbr = torch.zeros(3, 5, dtype=torch.int32)
    yield "int64 nbr", x, nbr.long(), TypeError
    yield "non-contiguous x", torch.zeros(8, 10).t(), nbr, ValueError
    yield "f16 x", x.half(), nbr, TypeError
    yield "nbr on another device", x, nbr.to("meta"), ValueError
    yield "1-D nbr", x, nbr[0], TypeError
    yield "K = 0", x, nbr[:0], ValueError
    yield "non-contiguous nbr", x, torch.zeros(5, 3, dtype=torch.int32).t(), \
        ValueError


@pytest.mark.parametrize("label,x,nbr,err", list(_rejects()),
                         ids=[c[0] for c in _rejects()])
def test_wrapper_rejects_what_the_kernel_does_not_take(label, x, nbr, err):
    with pytest.raises(err):
        dgs.dense_gather_sum(x, nbr)


def test_scatter_wrapper_rejects_mismatched_shapes():
    nbr = torch.zeros(3, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="dst columns"):
        dgs.dense_scatter_add(torch.zeros(4, 8), nbr, 10)
    with pytest.raises(TypeError):
        dgs.dense_scatter_add(torch.zeros(5, 8, dtype=torch.bfloat16), nbr,
                              10)
    with pytest.raises(ValueError, match="num_rows"):
        dgs.dense_scatter_add(torch.zeros(5, 8), nbr, 0)


def _block_teams(h, K):
    """The backward kernel's dst rows a block (``geometry`` in the
    source): one thread a 4-float column group (one float when H % 4),
    as many teams as fit in 256 threads and in 48 KB of staged indices
    beside the block's zero-row sum."""
    width = h // 4 if h % 4 == 0 else h
    teams = 256 // min(width, 256)
    return min(teams, (48 * 1024 - 4 * h - 16) // (4 * K))


def _model_scatter(g, nbr, S, teams):
    """The backward kernel in numpy: each block of ``teams`` dst rows adds
    a row's gradient straight into every non-zero target, sums each
    team's zero-row slots in registers, the teams' sums in shared memory,
    and adds the block's sum into the zero row once."""
    K, D = nbr.shape
    dx = np.zeros((S, g.shape[1]), np.float32)
    zero = S - 1
    for d0 in range(0, D, teams):
        block = np.zeros(g.shape[1], np.float32)
        for d in range(d0, min(d0 + teams, D)):
            team = np.zeros(g.shape[1], np.float32)
            for k in range(K):
                if nbr[k, d] == zero:
                    team += g[d]
                else:
                    dx[nbr[k, d]] += g[d]
            block += team
        dx[zero] += block
    return dx


@pytest.mark.parametrize("S,K,D,H", [(300, 26, 80, 100), (120, 11, 64, 128),
                                     (50, 5, 33, 3)])
def test_block_zero_row_model_matches_plain_scatter(S, K, D, H):
    x, nbr = _case(S, K, D, H, seed=5)
    g = _cotangent(D, H, "float32", seed=6)
    teams = _block_teams(H, K)
    assert teams == {100: 10, 128: 8, 3: 85}[H]
    model = _model_scatter(g, nbr, S, teams)
    plain = dgs.dense_scatter_add_reference(
        torch.from_numpy(g), torch.from_numpy(nbr), S).numpy()
    np.testing.assert_allclose(model, plain, **OP_TOL)
    assert np.abs(model[S - 1]).max() > 0  # the zero row took a share


def _extern_c_arities(text):
    """Each ``extern "C"`` function of a C source: its parameter count."""
    out = {}
    for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                         text):
        params = [p for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = len(params)
    return out


def test_ctypes_argtypes_match_the_c_entries():
    arities = _extern_c_arities(SOURCE.read_text())
    bound = dict(dgs.ARGTYPES, cuda_error_string=build.ERROR_STRING_ARGTYPES)
    assert set(arities) == set(bound)
    for name, n in arities.items():
        assert len(bound[name]) == n, name
    # Pointers and 64-bit integers never pass as 32-bit ints.
    for argtypes in dgs.ARGTYPES.values():
        assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong)
                   for t in argtypes)


def test_kernel_is_built_from_its_source():
    assert "dense_gather_sum" in build.KERNELS
    assert build.library_path("dense_gather_sum").name.startswith(
        "libdense_gather_sum-")
