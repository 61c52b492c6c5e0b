"""The dense gather-sum kernels' designs, modelled in numpy on the CPU.

``csrc/dense_gather_sum.cu`` runs only on the card. What its arithmetic
and its index work must be is held here against the plain versions of
``ops/dense_gather_sum.py``:

- the backward's plan (each source row's slots in slot order, each
  column's padding slots) against a numpy transpose of ``nbr``, on the
  shapes of ``CASES`` and on a row named by 200 slots;
- the backward's summation order: each row's slots sorted by slot id
  (whatever order the fill left them in) and summed in f32 in that order
  (a row of more than 256 slots in 8 contiguous parts, added in order),
  and the zero row as ``sum over d of c_d * g[d]`` through a fixed tree
  (8 columns, then two levels of 16 partials, then all that are left),
  each level summed in order: within 1e-5 of the plain scatter-add
  (another order of the same f32 adds) and bit-equal to itself under a
  shuffled fill;
- the bf16 forward's 16-byte words: the aligned window around each row,
  realigned by one shuffle, gives each lane its 8 columns, and never
  reads past the frame for a row other than the zero row; the zero row
  read in 8-byte halves; the K rows summed in the order of k: bit-equal
  to the plain version, on frames whose last row is not zero too.
"""

import ctypes
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from occ_gnn_tpu_torch.ops import dense_gather_sum as dgs
from occ_gnn_tpu_torch.sampling import native
from test_torch_dense_gather import CASES, _case

OP_TOL = 1e-5
ZERO_COLS, ZERO_FAN = 8, 16  # kZeroCols and kZeroFan in the source
SPAN, WARPS = dgs.SPAN, 8  # kSpan and kWarps in the source
SLOT_CASES = [c for c in CASES if c[2] > 0]


def _hot_row_case(n=200, K=10, D=60):
    """A frame of 500 rows whose row 7 is named by ``n`` slots, among
    padding and other rows."""
    S, H = 500, 16
    x, nbr = _case(S, K, D, H, seed=11)
    flat = nbr.reshape(-1)
    flat[np.random.default_rng(12).choice(K * D, n, replace=False)] = 7
    return S, x, flat.reshape(K, D)


def _transpose(nbr, S):
    """numpy: row s -> its slot ids k * D + d, in slot order; each
    column's padding slots."""
    K, D = nbr.shape
    rows = [[] for _ in range(S - 1)]
    for k in range(K):
        for d in range(D):
            if nbr[k, d] != S - 1:
                rows[nbr[k, d]].append(k * D + d)
    return rows, (nbr == S - 1).sum(axis=0)


def _check_plan(nbr, S):
    """The backward's plan and the per-slot scatter's (``slots_plan``, the
    format the samplers ship) against the numpy transpose."""
    counts, offsets, slots, pad = dgs.dense_scatter_plan(
        torch.from_numpy(nbr), S)
    rows, want_pad = _transpose(nbr, S)
    assert counts.tolist() == [len(r) for r in rows]
    assert offsets.tolist() == np.concatenate(
        [[0], np.cumsum([len(r) for r in rows])]).tolist()
    for s, want in enumerate(rows):
        assert slots[offsets[s]:offsets[s + 1]].tolist() == want
    assert pad.tolist() == want_pad.tolist()
    plan = dgs.slots_plan(torch.from_numpy(nbr), S)
    assert all(t.dtype == torch.int32 for t in plan)
    assert plan.offsets.tolist() == offsets.tolist()
    valid = int(offsets[-1])
    assert plan.slots.shape == (nbr.size,)
    assert plan.slots[:valid].tolist() == slots.tolist()
    assert (plan.slots[valid:] == -1).all()
    longs = [s for s, r in enumerate(rows) if len(r) > SPAN]
    assert plan.long_rows.shape == (nbr.size // (SPAN + 1) + 1,)
    assert int(plan.num_long) == len(longs)
    assert plan.long_rows[:len(longs)].tolist() == longs
    assert (plan.long_rows[len(longs):] == -1).all()
    return counts


@pytest.mark.parametrize("S,K,D,H", CASES)
def test_plan_is_the_transpose_in_slot_order(S, K, D, H):
    _, nbr = _case(S, K, D, H)
    _check_plan(nbr, S)


@pytest.mark.parametrize("n", [200, 700])
def test_plan_of_a_hot_row(n):
    """Row 7 of n slots: listed as a long row from SPAN + 1 slots on."""
    S, _, nbr = _hot_row_case(n, K=20, D=80)
    counts = _check_plan(nbr, S)
    assert counts[7] >= n
    assert (int(dgs.slots_plan(torch.from_numpy(nbr), S).num_long) == 1) \
        == (n > SPAN)


def _model_backward(g, nbr, S, fill=None):
    """The backward kernel in numpy. ``fill`` is the order in which the
    fill placed the slots in their rows' lists (the atomics' order; slot
    order by default); each list is sorted by slot id before it is summed
    in f32, from its first row on; a list of more than SPAN slots in WARPS
    contiguous parts (part w from place w n // WARPS), each summed so,
    the parts then added in order. The zero row: 8-column blocks of
    ``f32(c_d) * g[d]`` (one rounding each, then the add), summed in
    order from 0; blocks of 16 of those, twice; then all that are left,
    in order."""
    K, D = nbr.shape
    H = g.shape[1]
    flat = nbr.reshape(-1)
    lists = [[] for _ in range(S - 1)]
    for i in (range(K * D) if fill is None else fill):
        if flat[i] != S - 1:
            lists[flat[i]].append(i)
    dx = np.zeros((S, H), np.float32)
    def run(slots):
        acc = g[slots[0] % D].copy()
        for i in slots[1:]:
            acc = acc + g[i % D]
        return acc

    for s, slots in enumerate(lists):
        slots, n = sorted(slots), len(slots)
        if n > SPAN:
            acc = run(slots[:n // WARPS])
            for w in range(1, WARPS):
                acc = acc + run(slots[w * n // WARPS:(w + 1) * n // WARPS])
            dx[s] = acc
        elif slots:
            dx[s] = run(slots)
    pad = (nbr == S - 1).sum(axis=0)

    def level(parts, fan, mult=None):
        out = []
        for j0 in range(0, len(parts), fan):
            acc = np.zeros(H, np.float32)
            for j in range(j0, min(j0 + fan, len(parts))):
                if mult is None:
                    acc = acc + parts[j]
                elif mult[j]:
                    acc = acc + np.float32(mult[j]) * parts[j]
            out.append(acc)
        return out

    third = level(level(level(list(g), ZERO_COLS, pad), ZERO_FAN), ZERO_FAN)
    dx[S - 1] = level(third, max(len(third), 1))[0]
    return dx


# The shapes of split A's layers 0-1 at small size and of the one-element
# path: those of the block model this design replaced.
@pytest.mark.parametrize("S,K,D,H", [(300, 26, 80, 100), (120, 11, 64, 128),
                                     (50, 5, 33, 3)])
def test_slot_order_model_matches_plain_scatter(S, K, D, H):
    _, nbr = _case(S, K, D, H, seed=5)
    g = np.random.default_rng(6).standard_normal((D, H)).astype(np.float32)
    model = _model_backward(g, nbr, S)
    plain = dgs.dense_scatter_add_reference(
        torch.from_numpy(g), torch.from_numpy(nbr), S).numpy()
    scale = max(1.0, float(np.abs(plain).max()))
    np.testing.assert_allclose(model, plain, rtol=OP_TOL,
                               atol=OP_TOL * scale)
    assert np.abs(model[S - 1]).max() > 0  # the zero row took a share
    shuffled = np.random.default_rng(13).permutation(K * D)
    np.testing.assert_array_equal(_model_backward(g, nbr, S, shuffled),
                                  model)


def test_slot_order_model_on_a_hot_row():
    S, _, nbr = _hot_row_case()
    K, D = nbr.shape
    g = np.random.default_rng(14).standard_normal((D, 16)).astype(np.float32)
    model = _model_backward(g, nbr, S)
    plain = dgs.dense_scatter_add_reference(
        torch.from_numpy(g), torch.from_numpy(nbr), S).numpy()
    np.testing.assert_allclose(model, plain, rtol=OP_TOL,
                               atol=OP_TOL * float(np.abs(plain).max()))
    fill = np.random.default_rng(15).permutation(K * D)
    np.testing.assert_array_equal(_model_backward(g, nbr, S, fill), model)


@pytest.mark.parametrize("n", [257, 700])
def test_slot_order_model_on_a_row_past_the_span(n):
    """A row of more than SPAN slots, summed in parts: within OP_TOL of the
    plain scatter-add, and bit-equal under a shuffled fill."""
    S, _, nbr = _hot_row_case(n, K=20, D=80)
    K, D = nbr.shape
    g = np.random.default_rng(18).standard_normal((D, 16)).astype(np.float32)
    model = _model_backward(g, nbr, S)
    plain = dgs.dense_scatter_add_reference(
        torch.from_numpy(g), torch.from_numpy(nbr), S).numpy()
    np.testing.assert_allclose(model, plain, rtol=OP_TOL,
                               atol=OP_TOL * float(np.abs(plain).max()))
    fill = np.random.default_rng(19).permutation(K * D)
    np.testing.assert_array_equal(_model_backward(g, nbr, S, fill), model)


def test_the_models_constants_are_the_sources():
    """The constants the models above take from the kernel's source, and
    the long-row threshold's one owner: the cooperative backward sorts
    runs of kSpan = SPAN slots, while the per-slot kernel and the C++
    sampling service hold no threshold of their own and take SPAN as an
    argument (the wrapper's and ``NativeSplitSampler``'s)."""
    root = Path(dgs.__file__).resolve().parent.parent
    kernel = (root / "csrc" / "dense_gather_sum.cu").read_text()
    for name, value in (("kSpan", SPAN), ("kZeroCols", ZERO_COLS),
                        ("kZeroFan", ZERO_FAN), ("kThreads", 32 * WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", kernel), name
    body = re.search(r"scatter_slots\(const Acc\*.*?\n}\n", kernel,
                     re.S).group(0)
    assert "kSpan" not in body and "n > span" in body
    assert dgs.ARGTYPES["dense_scatter_slots"][8] is ctypes.c_int  # span
    assert "SPAN, num_rows" in inspect.getsource(dgs._launch_slots)
    sampler = (root / "csrc" / "occ_sampler.cpp").read_text()
    assert "kSpan" not in sampler and "int32_t plan_span)" in sampler
    assert "SPAN if scatter_plans else 0" in inspect.getsource(
        native.NativeSplitSampler.__init__)


def _bf16_bytes(S, H, seed):
    x = np.random.default_rng(seed).standard_normal((S, H)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t.view(torch.uint8).numpy().reshape(-1), t.float().numpy()


def _lane_columns(buf, r, S, H):
    """Row r's columns as the bf16 words kernel's lanes hold them: lane j
    loads 16-byte word j of the aligned window around the row (2 H / 16
    words, or (2 H + 8) / 16 when 2 H % 16 == 8) and, for a row starting
    8 bytes off, keeps its word's upper half and the next lane's lower
    half; the zero row in 8-byte halves of each lane's own columns. A
    slice of ``buf`` past the frame's end would come up short."""
    row_bytes = 2 * H
    words = row_bytes // 16 if row_bytes % 16 == 0 else (row_bytes + 8) // 16
    assert words <= 32
    start = r * row_bytes
    if r == S - 1:
        got = buf[start:start + row_bytes]
        assert got.size == row_bytes
    else:
        off, win = start % 16, start - start % 16
        lanes = [buf[win + 16 * j: win + 16 * j + 16] for j in range(words)]
        assert all(w.size == 16 for w in lanes)
        lanes += [np.zeros(16, np.uint8)] * (33 - words)
        got = np.concatenate([
            np.concatenate([lanes[j][8:], lanes[j + 1][:8]]) if off else
            lanes[j] for j in range(32)])
    cols = torch.from_numpy(got.copy()).view(torch.bfloat16).float()
    return cols[:H].numpy()


@pytest.mark.parametrize("H", [4, 12, 100, 124, 128, 252])
def test_bf16_words_realign_each_lane_to_its_columns(H):
    """Each lane's 8 columns must be the row's, for every row, and no
    window may pass the frame's end. The kernel takes windows of up to
    256 bytes (H = 124 the widest), the model up to 512."""
    S = 9
    buf, rows = _bf16_bytes(S, H, seed=H)
    for r in range(S):
        np.testing.assert_array_equal(_lane_columns(buf, r, S, H), rows[r])


@pytest.mark.parametrize("S,K,D,H", [c for c in SLOT_CASES if c[3] % 4 == 0])
def test_bf16_words_model_equals_plain(S, K, D, H):
    """The bf16 words kernel in numpy, on a frame whose last row is not
    zero: each dst row's K rows as the lanes hold them, added in f32 in
    the order of k from the first, bit-equal to the plain version."""
    x, nbr = _case(S, K, D, H, seed=16)
    x[S - 1] = np.random.default_rng(17).standard_normal(H)  # not zero
    tx = torch.from_numpy(x).to(torch.bfloat16)
    buf = tx.view(torch.uint8).numpy().reshape(-1)
    plain = dgs.dense_gather_sum_reference(tx, torch.from_numpy(nbr))
    model = np.empty((D, H), np.float32)
    for d in range(D):
        acc = _lane_columns(buf, nbr[0, d], S, H).copy()
        for k in range(1, K):
            acc = acc + _lane_columns(buf, nbr[k, d], S, H)
        model[d] = acc
    np.testing.assert_array_equal(model, plain.numpy())
