"""The port's fused gather and sorted segment-sum against the JAX package.

``gather_segment_sum`` is JAX's ``spmm_sum_blocked`` (the Pallas kernel,
in interpret mode on the CPU as in tests/test_pallas_spmm.py) and its
``ops.segment.spmm_sum`` with an edge weight. On CPU tensors the port's
wrapper takes its plain version. Tolerance 1e-5: f32 sums of at most a
few hundred terms, taken in another order.

The last tests hold a numpy model of the kernel's edge-balanced tiles (at
the wrapper's ``TILE_EDGES``) against the plain sum: which rows each tile
writes, which partial sums go to the scratch, and the second pass that
adds them.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from occ_gnn_tpu.ops import segment as jseg
from occ_gnn_tpu.ops.pallas_spmm_blocked import (
    spmm_sum_blocked as jax_spmm_sum_blocked,
)
from occ_gnn_tpu_torch.ops.segment_sum_sorted import (
    TILE_EDGES,
    gather_segment_sum,
    gather_segment_sum_backward,
    segment_sum_sorted,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _case(E, D, H, S, cap, seed=0):
    """E valid dst-sorted edges padded to cap (pad dst == D, pad src == 0),
    a frame x [S, H] and an edge weight [cap]."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, D, size=E)).astype(np.int32)
    src = rng.integers(0, S, size=E).astype(np.int32)
    dstp = np.concatenate([dst, np.full(cap - E, D, np.int32)])
    srcp = np.concatenate([src, np.zeros(cap - E, np.int32)])
    x = rng.standard_normal((S, H)).astype(np.float32)
    w = rng.random(cap).astype(np.float32)
    return x, srcp, dstp, w


CASES = [
    (3000, 700, 64, 500, 4096),
    (100, 10, 8, 50, 256),
    (5000, 300, 128, 400, 6000),
    (0, 40, 16, 30, 512),      # every edge is padding
    (300, 1, 32, 60, 384),     # num_segments = 1
]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("E,D,H,S,cap", CASES)
def test_matches_jax_spmm_sum_blocked(E, D, H, S, cap):
    x, src, dst, _ = _case(E, D, H, S, cap)
    got = gather_segment_sum(*_torch(x, src, dst), D)
    want = jax_spmm_sum_blocked(jnp.asarray(x), jnp.asarray(src),
                                jnp.asarray(dst), D)
    assert got.shape == (D, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("E,D,H,S,cap", CASES)
def test_weighted_matches_jax_spmm_sum(E, D, H, S, cap):
    x, src, dst, w = _case(E, D, H, S, cap, seed=1)
    xt, st, dt, wt = _torch(x, src, dst, w)
    got = gather_segment_sum(xt, st, dt, D, edge_weight=wt)
    want = jseg.spmm_sum(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                         D, edge_weight=jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("E,D,H,S,cap", CASES[:3])
def test_bf16_frame_matches_jax_on_the_same_values(E, D, H, S, cap):
    """A bf16 frame is read as it is and summed in f32; JAX's Pallas path
    sums the same bf16 values in f32 too."""
    x, src, dst, w = _case(E, D, H, S, cap, seed=2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    x_same = np.array(xb.astype(jnp.float32))
    xt = torch.from_numpy(x_same).to(torch.bfloat16)
    st, dt, wt = _torch(src, dst, w)
    got = gather_segment_sum(xt, st, dt, D)
    want = jax_spmm_sum_blocked(xb, jnp.asarray(src), jnp.asarray(dst), D)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_w = gather_segment_sum(xt, st, dt, D, edge_weight=wt)
    want_w = jseg.spmm_sum(jnp.asarray(x_same), jnp.asarray(src),
                           jnp.asarray(dst), D, edge_weight=jnp.asarray(w))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)


def test_no_edges_gives_zeros():
    x = np.random.default_rng(3).standard_normal((7, 12)).astype(np.float32)
    empty = np.zeros(0, np.int32)
    got = gather_segment_sum(*_torch(x, empty, empty), 5)
    want = jseg.spmm_sum(jnp.asarray(x), jnp.asarray(empty),
                         jnp.asarray(empty), 5)
    assert got.shape == (5, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


@pytest.mark.parametrize("E,D,H,S,cap", CASES[:3] + CASES[4:])
@pytest.mark.parametrize("weighted", [False, True])
def test_grad_to_x_matches_jax(E, D, H, S, cap, weighted):
    x, src, dst, w = _case(E, D, H, S, cap, seed=4)
    cot = np.random.default_rng(5).standard_normal((D, H)).astype(np.float32)

    def jfn(xx):
        if weighted:
            out = jseg.spmm_sum(xx, jnp.asarray(src), jnp.asarray(dst), D,
                                edge_weight=jnp.asarray(w))
        else:
            out = jax_spmm_sum_blocked(xx, jnp.asarray(src), jnp.asarray(dst),
                                       D)
        return jnp.sum(out * cot)

    gj = jax.grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = gather_segment_sum(xt, *_torch(src, dst), D,
                             edge_weight=torch.from_numpy(w) if weighted
                             else None)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_backward_matches_jax_vjp(weighted):
    """The CUDA path's backward is torch ops: check it on the CPU against
    JAX's VJP of the same function, padding edges contributing nothing."""
    E, D, H, S, cap = 700, 90, 24, 40, 1024
    x, src, dst, w = _case(E, D, H, S, cap, seed=6)
    cot = np.random.default_rng(7).standard_normal((D, H)).astype(np.float32)
    weight = jnp.asarray(w) if weighted else None
    _, vjp = jax.vjp(
        lambda xx: jseg.spmm_sum(xx, jnp.asarray(src), jnp.asarray(dst), D,
                                 edge_weight=weight), jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(cot))
    gt = gather_segment_sum_backward(
        torch.from_numpy(cot), *_torch(src, dst), D, S,
        torch.from_numpy(w) if weighted else None)
    assert gt.shape == (S, H) and gt.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)


def test_bf16_grad_comes_back_in_bf16():
    x, src, dst, _ = _case(500, 60, 16, 80, 640, seed=8)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    gather_segment_sum(xt, *_torch(src, dst), 60).sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    deg = np.bincount(src[:500], minlength=80).astype(np.float32)
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.repeat(deg[:, None], 16, axis=1))


# CASES with edges, and a frame of 40 rows under 20,000 edges (some 500
# terms a row).
BF16_GRAD_CASES = CASES[:3] + CASES[4:] + [(20000, 50, 16, 40, 20480)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("E,D,H,S,cap", BF16_GRAD_CASES)
def test_bf16_grad_within_one_rounding_of_the_exact_sum(E, D, H, S, cap,
                                                        weighted):
    """The gradient to a bf16 frame, on the CPU as on the card, is summed
    in f32 and rounded to bf16 once: each element within 2^-8 of the
    float64 sum of its edges' terms, beside the f32 sum's own bound
    (terms x 2^-24 of the terms' magnitudes, twice). JAX's gradient in
    the frame's type is no nearer: its unweighted path returns the f32
    sum for the bf16 frame, which a bf16 tensor's gradient holds rounded
    once; its weighted path rounds each edge's row and adds in bf16."""
    x, src, dst, w = _case(E, D, H, S, cap, seed=9)
    cot = np.random.default_rng(10).standard_normal((D, H)).astype(
        np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    gather_segment_sum(xt, *_torch(src, dst), D,
                       edge_weight=torch.from_numpy(w) if weighted
                       else None).backward(torch.from_numpy(cot))
    assert xt.grad.dtype == torch.bfloat16
    port = xt.grad.float().numpy().astype(np.float64)
    if weighted:
        fn = functools.partial(jseg.spmm_sum, edge_src=jnp.asarray(src),
                               edge_dst=jnp.asarray(dst), num_dst=D,
                               edge_weight=jnp.asarray(w))
    else:
        fn = functools.partial(jax_spmm_sum_blocked,
                               edge_src=jnp.asarray(src),
                               edge_dst=jnp.asarray(dst), num_dst=D)
    _, vjp = jax.vjp(fn, xb)
    (gj,) = vjp(jnp.asarray(cot))
    jgrad = np.asarray(gj.astype(jnp.bfloat16).astype(jnp.float32)).astype(
        np.float64)
    ww = w[:E].astype(np.float64) if weighted else np.ones(E)
    terms_e = cot[dst[:E]].astype(np.float64) * ww[:, None]
    exact, mags = np.zeros((S, H)), np.zeros((S, H))
    np.add.at(exact, src[:E], terms_e)
    np.add.at(mags, src[:E], np.abs(terms_e))
    terms = np.bincount(src[:E], minlength=S)[:, None]
    limit = 2.0**-8 * np.abs(exact) + 2 * terms * 2.0**-24 * mags
    port_err = np.abs(port - exact).max()
    jax_err = np.abs(jgrad - exact).max()
    print(f"E={E} S={S} weighted={weighted}: port {port_err:.3g}, JAX "
          f"{jax_err:.3g} from the float64 sum")
    assert (np.abs(port - exact) <= limit).all()
    assert port_err <= jax_err


def test_weight_requiring_grad_raises():
    x, src, dst, w = _case(100, 10, 8, 50, 256)
    wt = torch.from_numpy(w).requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        gather_segment_sum(*_torch(x, src, dst), 10, edge_weight=wt)


def test_cpu_path_launches_no_kernel():
    x, src, dst, w = _case(500, 50, 16, 40, 512)
    before = (gather_segment_sum.launches, segment_sum_sorted.launches)
    gather_segment_sum(*_torch(x, src, dst), 50,
                       edge_weight=torch.from_numpy(w))
    gather_segment_sum(torch.from_numpy(x).to(torch.bfloat16),
                       *_torch(src, dst), 50)
    assert (gather_segment_sum.launches,
            segment_sum_sorted.launches) == before


_I32 = dict(dtype=torch.int32)


@pytest.mark.parametrize("x,src,dst,w,n,err", [
    (torch.zeros(6, 4, dtype=torch.float64), torch.zeros(8, **_I32),
     torch.zeros(8, **_I32), None, 2, TypeError),
    (torch.zeros(6, 4, dtype=torch.float16), torch.zeros(8, **_I32),
     torch.zeros(8, **_I32), None, 2, TypeError),
    (torch.zeros(6), torch.zeros(8, **_I32), torch.zeros(8, **_I32), None,
     2, TypeError),
    (torch.zeros(6, 4), torch.zeros(8, dtype=torch.int64),
     torch.zeros(8, **_I32), None, 2, TypeError),
    (torch.zeros(6, 4), torch.zeros(7, **_I32), torch.zeros(8, **_I32),
     None, 2, TypeError),
    (torch.zeros(6, 4), torch.zeros(8, **_I32), torch.zeros(8, 1, **_I32),
     None, 2, TypeError),
    (torch.zeros(6, 4), torch.zeros(8, **_I32), torch.zeros(8, **_I32),
     torch.zeros(7), 2, TypeError),
    (torch.zeros(6, 4), torch.zeros(8, **_I32), torch.zeros(8, **_I32),
     torch.zeros(8, dtype=torch.float64), 2, TypeError),
    (torch.zeros(4, 6).t(), torch.zeros(8, **_I32), torch.zeros(8, **_I32),
     None, 2, ValueError),
    (torch.zeros(6, 4), torch.zeros(16, **_I32)[::2], torch.zeros(8, **_I32),
     None, 2, ValueError),
    (torch.zeros(6, 4), torch.zeros(8, **_I32), torch.zeros(8, **_I32),
     None, -1, ValueError),
    (torch.zeros(6, 4), torch.full((8,), 6, **_I32), torch.zeros(8, **_I32),
     None, 2, IndexError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(x, src, dst, w, n,
                                                       err):
    with pytest.raises(err):
        gather_segment_sum(x, src, dst, n, edge_weight=w)


# ---------------------------------------------------------------------------
# The kernel's tile decomposition, modelled in numpy.
# ---------------------------------------------------------------------------


def _tile_model(msgs, dst, n, tile):
    """Both passes of csrc/segment_sum_sorted.cu over f64 rows, counting
    the writes of each output row. Pass 1: tile t holds valid edges
    [t * tile, (t + 1) * tile). A row cut by a tile's edge is short when it
    spans two tiles (the tile where it begins sums it whole, reading into
    the next tile, which skips it) and long when it spans more: each tile
    then leaves its part in the scratch, slot 0 where the row began in an
    earlier tile, slot 1 (and the owner flag) where it begins. A tile
    writes 0 to the empty rows between the rows it sums; the rows before
    the first valid edge and after the last are written 0 by the whole
    grid. Pass 2: each owner adds its slot 1 and the following tiles'
    slot 0 in tile order. Returns the output, the writes of each row and
    the owner flags."""
    valid = int(np.searchsorted(dst, n, side="left"))
    tiles = -(-valid // tile)
    h = msgs.shape[1]
    out = np.full((n, h), np.nan)
    writes = np.zeros(n, np.int64)
    partial = np.full((tiles, 2, h), np.nan)
    owner = np.zeros(tiles, bool)

    def at(e):
        return dst[0] - 1 if e < 0 else (dst[e] if e < valid else n)

    def put(rows, value):
        out[rows] = value
        writes[rows] += 1

    def row_end(e, stop, key):
        while e < stop and dst[e] == key:
            e += 1
        return e

    if valid == 0:
        put(slice(0, n), 0.0)
    else:
        put(slice(0, dst[0]), 0.0)
        put(slice(dst[valid - 1] + 1, n), 0.0)
    for t in range(tiles):
        a, b = t * tile, min((t + 1) * tile, valid)
        prev, nxt = at(a - 1), at(b)
        first, last = dst[a], dst[b - 1]
        cut_start, cut_end = prev == first, nxt == last
        long_first = cut_start and (at(a - tile - 1) == first
                                    or (last == first and cut_end))
        begins_last = not (cut_start and last == first)
        long_last = (cut_end and begins_last and a + 2 * tile < valid
                     and dst[a + 2 * tile] == last)
        owner[t] = long_last
        start = (row_end(a, b, first) if cut_start and not long_first
                 else a)
        stop = (row_end(b, min(b + tile, valid), last)
                if cut_end and begins_last and not long_last else b)

        def flush(row, acc):
            if row == first and long_first:
                partial[t, 0] = acc
            elif row == last and long_last:
                partial[t, 1] = acc
            else:
                put(row, acc)

        gap_from = first if start > a else prev
        row = dst[start] if start < stop else first
        put(slice(gap_from + 1, row), 0.0)
        acc = np.zeros(h)
        for e in range(start, stop):
            if dst[e] != row:
                flush(row, acc)
                put(slice(row + 1, dst[e]), 0.0)
                row, acc = dst[e], np.zeros(h)
            acc = acc + msgs[e]
        if start < stop:
            flush(row, acc)
    for t in np.nonzero(owner)[0]:
        row = dst[(t + 1) * tile - 1]
        acc, u = partial[t, 1].copy(), t + 1
        while u * tile < valid and dst[u * tile] == row:
            acc += partial[u, 0]
            u += 1
        put(row, acc)
    return out, writes, owner


def _padded(rows, cap, n):
    dst = np.full(cap, n, np.int32)
    dst[: rows.shape[0]] = np.sort(rows)
    return dst


T = TILE_EDGES
TILE_CASES = {
    # a row of 2.5 tiles, so it spans three, between two short ones
    "row over three tiles": (np.concatenate(
        [np.zeros(T - 3, np.int64), np.full(5 * T // 2, 7),
         np.full(40, 9)]), 12),
    # a row longer than a tile, starting on a tile's edge
    "row longer than a tile": (np.concatenate(
        [np.zeros(T, np.int64), np.full(T + 5, 1), [4, 4]]), 6),
    # every row ends exactly on a tile's edge
    "rows cut at tile edges": (np.repeat(np.arange(6), T // 2), 6),
    # rows of one tile each, and wide gaps of empty rows
    "tile-sized rows, empty gaps": (np.repeat([0, 50, 51, 400], T), 1000),
    # a row of exactly two tiles, and a long row ending on a tile's edge
    "rows ending on tile edges": (np.concatenate(
        [np.zeros(T // 2, np.int64), np.full(2 * T, 1), np.full(T // 2, 2),
         np.full(3 * T, 3), [5]]), 7),
    "random": (np.random.default_rng(9).integers(0, 300, 7 * T + 19), 300),
    "heavy-tailed degrees": (np.repeat(
        np.arange(60), np.random.default_rng(11).zipf(1.6, 60).clip(1, 4 * T)),
        64),
    "one edge": (np.array([3]), 5),
    "empty head and tail rows": (np.concatenate(
        [np.full(T + 3, 40), np.arange(41, 90)]), 500),
    "all padding": (np.zeros(0, np.int64), 8),
}


@pytest.mark.parametrize("label", list(TILE_CASES))
def test_tile_model_matches_the_plain_sum(label):
    rows, n = TILE_CASES[label]
    cap = rows.shape[0] + 37
    dst = _padded(rows, cap, n)
    msgs = np.random.default_rng(10).standard_normal((cap, 5))
    out, writes, _ = _tile_model(msgs, dst, n, T)
    assert (writes == 1).all(), f"rows written {np.unique(writes)} times"
    want = np.zeros((n + 1, 5))
    np.add.at(want, dst, msgs)
    np.testing.assert_allclose(out, want[:n], rtol=1e-12, atol=1e-12)
    got = segment_sum_sorted(torch.from_numpy(msgs.astype(np.float32)),
                             torch.from_numpy(dst), n)
    np.testing.assert_allclose(got.numpy(), want[:n], rtol=1e-5, atol=1e-5)


def test_tile_model_cases_cut_rows_as_named():
    """The cases above do exercise what they are named for: a row whose
    edges lie in three tiles (a long row, summed through the scratch), one
    longer than a tile, rows ending on a tile's edge."""
    def tiles_of_rows(rows):
        dst = np.sort(rows)
        return {r: len(set(np.nonzero(dst == r)[0] // T)) for r in set(dst)}

    rows, n = TILE_CASES["row over three tiles"]
    assert max(tiles_of_rows(rows).values()) >= 3
    dst = _padded(rows, rows.shape[0] + 37, n)
    _, _, owner = _tile_model(np.ones((dst.shape[0], 1)), dst, n, T)
    assert owner.sum() == 1
    assert (np.bincount(TILE_CASES["row longer than a tile"][0]).max() > T)
    edges = np.cumsum(np.bincount(TILE_CASES["rows cut at tile edges"][0]))
    assert (edges % T == 0).sum() >= 2
