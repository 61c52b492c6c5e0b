"""The port's dense GAT attention against the JAX package.

``ops/gat_attention.gat_attention`` is the batched branch of JAX's
``SplitGAT.layer`` (``occ_gnn_tpu/parallel/model.py:321-363``), which
``_jax_batched`` below runs line for line, in both types, on the same
inputs made from a numpy seed. On CPU tensors the port's wrappers take
their plain versions (``gat_attention_fwd`` the plain forward's partials,
``gat_attention_bwd`` the backward written out term by term); the kernels
are held to them on the card by ``chip_smoke.py``. The whole layer, with
this op inside it, is held to JAX's by ``tests/test_torch_split_gat.py``.

The port detaches the softmax's max (a shift: the layer reads only ``v /
s``, in which it cancels); JAX's lines differentiate through it. So the
gradients are compared two ways: of ``v / s`` with JAX's lines as they
are, and of ``(s, v)`` under any cotangent with JAX's max under
``stop_gradient``.

Tolerances: f32 exps, products and sums of a few dozen terms in another
order, ``(m, s, v)`` at 1e-5 and the gradients at the ``GRAD_TOL`` of
``tests/test_torch_split_gat.py`` (under cotangents of a mean loss's
scale, as there: ``dwl`` sums hundreds of terms, and an element near 0
carries their rounding); a bf16 frame at that file's
``BF16_TOL`` (the rows, ``wl`` and the weights rounded to 8 mantissa bits
in both packages).
"""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occ_gnn_tpu_torch.ops import build
from occ_gnn_tpu_torch.ops import config as tcfg
from occ_gnn_tpu_torch.ops import dense_gather_sum as dgs
from occ_gnn_tpu_torch.ops import gat_attention as ga
from occ_gnn_tpu_torch.parallel import model as tmodel

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_TOL = dict(rtol=1e-3, atol=1e-3)
SLOPE = 0.2
SOURCE = Path(ga.__file__).resolve().parent.parent / "csrc" / \
    "gat_attention.cu"
REPO = Path(__file__).resolve().parent.parent

# (S, K, D, H, heads, Dh): split GAT's layers at small size (the self slot
# first, hidden layers of heads x Dh columns), K = 1, odd widths, more
# heads than the kernels keep in registers.
CASES = [
    (300, 5, 64, 12, 2, 3),
    (300, 11, 64, 16, 2, 3),
    (120, 8, 40, 16, 2, 5),
    (50, 1, 30, 12, 2, 3),
    (90, 6, 33, 13, 3, 2),
    (80, 5, 30, 20, 12, 2),
]


def _case(S, K, D, H, heads, dh, seed=0):
    """A frame ``x [S, H]`` with its zero row, ``nbr [K, D]`` with 30 %
    padding slots, a source twice in a column, the last two columns all
    padding, and the weights ``wl``, ``w3`` and ``er``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, H)).astype(np.float32)
    x[S - 1] = 0.0
    nbr = rng.integers(0, S - 1, (K, D)).astype(np.int32)
    nbr[rng.random((K, D)) < 0.3] = S - 1
    if K > 1:
        nbr[1, ::3] = nbr[0, ::3]
    nbr[:, -2:] = S - 1
    wl = (0.5 * rng.standard_normal((H, heads))).astype(np.float32)
    w3 = (0.5 * rng.standard_normal((H, heads, dh))).astype(np.float32)
    er = rng.standard_normal((D, heads)).astype(np.float32)
    return x, nbr, wl, w3, er


def _cotangents(D, heads, dh, seed=1):
    """Cotangents of ``(s, v)`` at the scale a mean over the D columns
    gives them, as the layer's loss does in
    ``tests/test_torch_split_gat.py``, whose GRAD_TOL (and its absolute
    part) is written for gradients of that scale."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((D, heads)).astype(np.float32) / D,
            rng.standard_normal((D, heads, dh)).astype(np.float32) / D)


def _jax_batched(x, nbr, wl, w3, er_frame, stop_max=False):
    """JAX's batched branch (``parallel/model.py:321-363``, the default
    weighted sum), ``sentinel = x.shape[0] - 1``; ``stop_max`` puts the
    max under ``stop_gradient``, as the port detaches it."""
    sentinel = x.shape[0] - 1
    xg = x[nbr]
    valid = (nbr != sentinel)[..., None]
    z = jax.nn.leaky_relu(
        jnp.einsum("kdh,hc->kdc", xg, wl.astype(x.dtype),
                   preferred_element_type=jnp.float32)
        + er_frame[None], SLOPE)
    z = jnp.where(valid, z, -jnp.inf)
    m_loc = jnp.max(z, axis=0)
    if stop_max:
        m_loc = jax.lax.stop_gradient(m_loc)
    safe = jnp.where(jnp.isfinite(m_loc), m_loc, 0.0)
    pw = jnp.where(valid, jnp.exp(z - safe[None]), 0.0)
    s_loc = jnp.sum(pw, axis=0)
    agg = jnp.einsum("kdc,kdh->dch", pw.astype(x.dtype), xg,
                     preferred_element_type=jnp.float32)
    v_loc = jnp.einsum("dch,hco->dco", agg, w3)
    return m_loc, s_loc, v_loc


def _frame(x, dtype):
    """The frame in both packages, with the same values (bf16 made in JAX
    and read back exactly)."""
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)


def _port(x_t, nbr, wl, w3, er, grad_x):
    """The port's op on leaf tensors; returns them and ``(m, s, v)``."""
    leaves = dict(x=x_t.requires_grad_(grad_x),
                  wl=torch.from_numpy(wl).requires_grad_(),
                  w3=torch.from_numpy(w3).requires_grad_(),
                  er=torch.from_numpy(er).requires_grad_())
    out = ga.gat_attention(leaves["x"], torch.from_numpy(nbr), leaves["wl"],
                           leaves["w3"], leaves["er"])
    return leaves, out


def _assert_partials(got, want, tol):
    m, s, v = (t.detach().numpy() for t in got)
    jm, js, jv = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(np.isneginf(m), np.isneginf(jm))
    fin = np.isfinite(jm)
    np.testing.assert_allclose(m[fin], jm[fin], **tol)
    np.testing.assert_allclose(s, js, **tol)
    np.testing.assert_allclose(v, jv, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,K,D,H,heads,dh", CASES)
def test_partials_match_jax(S, K, D, H, heads, dh, dtype):
    x, nbr, wl, w3, er = _case(S, K, D, H, heads, dh)
    jx, tx = _frame(x, dtype)
    _, got = _port(tx, nbr, wl, w3, er, grad_x=False)
    want = _jax_batched(jx, jnp.asarray(nbr), jnp.asarray(wl),
                        jnp.asarray(w3), jnp.asarray(er))
    assert all(t.dtype == torch.float32 for t in got)
    assert got[2].shape == (D, heads, dh)
    _assert_partials(got, want, OUT_TOL if dtype == "float32" else BF16_TOL)


def _grads(leaves, names):
    return [leaves[n].grad.float().numpy() for n in names]


@pytest.mark.parametrize("S,K,D,H,heads,dh", CASES)
def test_grads_of_s_and_v_match_jax_vjp(S, K, D, H, heads, dh):
    """Any cotangent of ``(s, v)``, against JAX's lines with the max
    detached: gradients to x, wl, w3 and er."""
    x, nbr, wl, w3, er = _case(S, K, D, H, heads, dh, seed=2)
    gs, gv = _cotangents(D, heads, dh)
    _, vjp = jax.vjp(lambda *a: _jax_batched(a[0], jnp.asarray(nbr), *a[1:],
                                             stop_max=True)[1:],
                     *map(jnp.asarray, (x, wl, w3, er)))
    want = vjp((jnp.asarray(gs), jnp.asarray(gv)))
    leaves, (_, s, v) = _port(torch.from_numpy(x), nbr, wl, w3, er, True)
    torch.autograd.backward((s, v), (torch.from_numpy(gs),
                                     torch.from_numpy(gv)))
    for name, g, w in zip("x wl w3 er".split(), _grads(
            leaves, ["x", "wl", "w3", "er"]), want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL, err_msg=name)


def _ratio(s, v, xp):
    """What the layer reads: ``v / s``, zero where no slot is valid."""
    safe = xp.where(s > 0, s, 1.0)
    return xp.where((s > 0)[..., None], v / safe[..., None], 0.0)


@pytest.mark.parametrize("S,K,D,H,heads,dh", CASES)
def test_grads_of_the_ratio_match_jax_as_written(S, K, D, H, heads, dh):
    """The gradient of ``v / s`` against JAX's lines as they are (its max
    differentiated), where the max cancels."""
    x, nbr, wl, w3, er = _case(S, K, D, H, heads, dh, seed=3)
    _, gv = _cotangents(D, heads, dh, seed=4)

    def jfn(*a):
        _, s, v = _jax_batched(a[0], jnp.asarray(nbr), *a[1:])
        return _ratio(s, v, jnp)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, wl, w3, er)))
    want = vjp(jnp.asarray(gv))
    leaves, (_, s, v) = _port(torch.from_numpy(x), nbr, wl, w3, er, True)
    _ratio(s, v, torch).backward(torch.from_numpy(gv))
    for name, g, w in zip("x wl w3 er".split(), _grads(
            leaves, ["x", "wl", "w3", "er"]), want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("S,K,D,H,heads,dh", CASES)
def test_bf16_frame_grads_match_jax(S, K, D, H, heads, dh):
    """A bf16 frame (split GAT's layer 0: no gradient to it): the
    gradients to wl, w3 and er, JAX's bf16 rounding of ``wl``'s gradient
    and of ``dagg . leaf`` mirrored in the port."""
    x, nbr, wl, w3, er = _case(S, K, D, H, heads, dh, seed=5)
    gs, gv = _cotangents(D, heads, dh, seed=6)
    jx, tx = _frame(x, "bfloat16")
    _, vjp = jax.vjp(lambda *a: _jax_batched(jx, jnp.asarray(nbr), *a,
                                             stop_max=True)[1:],
                     *map(jnp.asarray, (wl, w3, er)))
    want = vjp((jnp.asarray(gs), jnp.asarray(gv)))
    leaves, (_, s, v) = _port(tx, nbr, wl, w3, er, False)
    torch.autograd.backward((s, v), (torch.from_numpy(gs),
                                     torch.from_numpy(gv)))
    assert leaves["x"].grad is None
    for name, g, w in zip("wl w3 er".split(), _grads(
            leaves, ["wl", "w3", "er"]), want):
        np.testing.assert_allclose(g, np.asarray(w), **BF16_TOL, err_msg=name)


def test_all_padding_columns_give_neg_inf_and_zeros():
    """Columns no slot names: m = -inf, zero sums, no nan, and finite
    gradients (zero to er there)."""
    x, nbr, wl, w3, er = _case(60, 4, 12, 8, 2, 3, seed=7)
    nbr[:, 3:7] = 59
    leaves, (m, s, v) = _port(torch.from_numpy(x), nbr, wl, w3, er, True)
    assert torch.isneginf(m[3:7]).all() and torch.isfinite(m[:3]).all()
    assert not s[3:7].any() and not v[3:7].any()
    (s.sum() + v.sum()).backward()
    for t in leaves.values():
        assert torch.isfinite(t.grad).all()
    assert not leaves["er"].grad[3:7].any()
    assert not leaves["x"].grad[:59][np.setdiff1d(
        np.arange(59), nbr[nbr != 59])].any()


def test_backward_reference_equals_autograd_of_the_plain_version():
    """The backward written out term by term equals autograd of the plain
    version, dxg summed by slot into dx (f32 and bf16 frames)."""
    S, K, D, H, heads, dh = 200, 9, 50, 16, 2, 4
    x, nbr, wl, w3, er = _case(S, K, D, H, heads, dh, seed=8)
    gs, gv = _cotangents(D, heads, dh, seed=9)
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype).requires_grad_(
            dtype == torch.float32)
        wt, w3t, ert = (torch.from_numpy(a).requires_grad_()
                        for a in (wl, w3, er))
        m, s, v = ga.gat_attention_reference(xt, torch.from_numpy(nbr), wt,
                                             w3t, ert)
        torch.autograd.backward((s, v), (torch.from_numpy(gs),
                                         torch.from_numpy(gv)))
        dagg = torch.einsum("dco,hco->dch", torch.from_numpy(gv), w3t.detach())
        dxg, dwl, der = ga.gat_attention_backward_reference(
            xt.detach(), torch.from_numpy(nbr), wt.detach(), ert.detach(),
            m, torch.from_numpy(gs), dagg, need_dx=dtype == torch.float32)
        np.testing.assert_allclose(dwl.numpy(), wt.grad.numpy(), **GRAD_TOL)
        np.testing.assert_allclose(der.numpy(), ert.grad.numpy(), **GRAD_TOL)
        if dtype == torch.float32:
            dx = dgs.dense_scatter_slots(dxg, torch.from_numpy(nbr), S)
            np.testing.assert_allclose(dx.numpy(), xt.grad.numpy(),
                                       **GRAD_TOL)
            pad = torch.from_numpy(nbr.reshape(-1) == S - 1)
            assert not dxg[pad].any()


@pytest.mark.parametrize("with_plan", [False, True],
                         ids=["no plan", "plan"])
def test_per_slot_plan_sums_each_rows_slots_in_slot_order(with_plan):
    """``dense_scatter_slots``: the plan's lists (``dense_scatter_plan``)
    summed row by row in slot order, against ``index_add_``; the zero row
    is 0 whatever its padding slots' rows hold (they are not read). On
    the CPU a plan (``slots_plan``) changes nothing."""
    S, K, D, H = 80, 7, 60, 5
    x, nbr, *_ = _case(S, K, D, H, 2, 3, seed=10)
    nbr[:, 10] = 3                               # a row of many slots
    rows = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (K * D, H)).astype(np.float32))
    nbr_t = torch.from_numpy(nbr)
    rows[torch.from_numpy(nbr.reshape(-1) == S - 1)] = float("nan")
    plan = dgs.slots_plan(nbr_t, S) if with_plan else None
    got = dgs.dense_scatter_slots(rows, nbr_t, S, plan)
    counts, offsets, slots, pad = dgs.dense_scatter_plan(nbr_t, S)
    want = torch.zeros(S, H)
    for r in range(S - 1):
        for slot in slots[offsets[r]:offsets[r + 1]]:
            want[r] += rows[slot]
    assert int(pad.sum()) == int((nbr == S - 1).sum())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    index_add = torch.zeros(S, H).index_add_(0, nbr_t.reshape(-1).long(),
                                             rows)
    index_add[S - 1] = 0.0
    np.testing.assert_allclose(got.numpy(), index_add.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_scatter_slots_on_the_card_needs_the_plan():
    """A call that is not on the CPU (meta tensors stand in for CUDA ones:
    no GPU needed) without a plan raises, naming where the plan comes
    from, and builds none; with a plan it reaches the device check."""
    S, K, D, H = 60, 4, 12, 8
    nbr = torch.from_numpy(_case(S, K, D, H, 2, 3)[1])
    rows = torch.zeros(K * D, H, device="meta")
    before = dgs.slots_plan.on_card
    with pytest.raises(ValueError, match="plan.*slots_plan"):
        dgs.dense_scatter_slots(rows, nbr.to("meta"), S)
    assert dgs.slots_plan.on_card == before
    plan = dgs.ScatterPlan(*(t.to("meta") for t in dgs.slots_plan(nbr, S)))
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        dgs.dense_scatter_slots(rows, nbr.to("meta"), S, plan)


def test_scatter_slots_rejects_a_plan_of_other_shapes():
    S, K, D, H = 60, 4, 12, 8
    nbr = torch.from_numpy(_case(S, K, D, H, 2, 3)[1])
    rows = torch.zeros(K * D, H)
    plan = dgs.slots_plan(nbr, S)
    with pytest.raises(ValueError, match="offsets"):
        dgs.dense_scatter_slots(rows, nbr, S, dgs.slots_plan(nbr, S + 1))
    with pytest.raises(ValueError, match="slots"):
        dgs.dense_scatter_slots(rows, nbr, S, plan._replace(
            slots=plan.slots.long()))
    with pytest.raises(ValueError, match="num_long"):
        dgs.dense_scatter_slots(rows, nbr, S, plan._replace(
            num_long=plan.num_long.reshape(1)))


def test_scatter_slots_rejects_mismatched_rows():
    nbr = torch.zeros(3, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="slots"):
        dgs.dense_scatter_slots(torch.zeros(14, 8), nbr, 10)
    with pytest.raises(TypeError):
        dgs.dense_scatter_slots(torch.zeros(15, 8, dtype=torch.bfloat16),
                                nbr, 10)


def test_cpu_path_launches_no_kernel():
    counters = (ga.gat_attention_fwd, ga.gat_attention_bwd,
                dgs.dense_scatter_slots)
    before = [fn.launches for fn in counters]
    x, nbr, wl, w3, er = _case(60, 4, 12, 8, 2, 3)
    leaves, (m, s, v) = _port(torch.from_numpy(x), nbr, wl, w3, er, True)
    (s.sum() + v.sum()).backward()
    assert leaves["x"].grad is not None
    assert [fn.launches for fn in counters] == before


def test_a_tensor_off_the_cpu_takes_the_kernel_or_raises():
    """The wrappers choose the plain version by the tensor's device alone:
    a tensor that is not on the CPU (here on the meta device) goes to the
    kernel path, which takes CUDA tensors and raises for any other."""
    x, nbr, wl, _, er = _case(60, 4, 12, 8, 2, 3)
    meta = [torch.from_numpy(a).to("meta") for a in (x, nbr, wl, er)]
    with pytest.raises(ValueError, match="CUDA"):
        ga.gat_attention_fwd(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        dgs.dense_scatter_slots(torch.zeros(48, 8, device="meta"), meta[1],
                                60)


def _rejects():
    x, nbr, wl, w3, er = (torch.from_numpy(a) for a in _case(
        60, 4, 12, 8, 2, 3))
    yield "int64 nbr", (x, nbr.long(), wl, w3, er), TypeError
    yield "f16 x", (x.half(), nbr, wl, w3, er), TypeError
    yield "wl of other heads", (x, nbr, wl[:, :1], w3, er), TypeError
    yield "er of other columns", (x, nbr, wl, w3, er[:5]), TypeError
    yield "w3 of other rows", (x, nbr, wl, w3[:4], er), TypeError
    yield "non-contiguous x", (torch.zeros(8, 60).t(), nbr, wl, w3, er), \
        ValueError
    yield "K = 0", (x, nbr[:0], wl, w3, er), TypeError


@pytest.mark.parametrize("label,args,err", list(_rejects()),
                         ids=[c[0] for c in _rejects()])
def test_op_rejects_what_the_kernels_do_not_take(label, args, err):
    with pytest.raises(err):
        ga.gat_attention(*args)


def test_dense_attention_takes_the_op_by_default_and_torch_ops_under_fma(
        monkeypatch):
    """``dense_attention`` goes through ``gat_attention`` under the
    default lowerings, and through torch ops under ``OCC_GAT_AGG=fma``;
    both give the same partials."""
    x, nbr, wl, w3, er = (torch.from_numpy(a) for a in _case(
        100, 6, 30, 12, 2, 3, seed=12))
    calls = []
    real = tmodel.gat_attention

    def spy(*a):
        calls.append(a[1].shape)
        return real(*a)

    monkeypatch.setattr(tmodel, "gat_attention", spy)
    default = tmodel.dense_attention(x, nbr, wl, w3, er)
    old = tcfg.gat_agg_impl()
    try:
        tcfg.set_gat_agg_impl("fma")
        fma = tmodel.dense_attention(x, nbr, wl, w3, er)
    finally:
        tcfg.set_gat_agg_impl(old)
    assert calls == [(6, 30)]
    for a, b in zip(default, fma):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        np.testing.assert_allclose(a[fin].numpy(), b[fin].numpy(), **OUT_TOL)


def test_import_leaves_jax_out():
    """A fresh ``import occ_gnn_tpu_torch`` and its GAT op import neither
    ``jax`` nor the JAX package."""
    code = ("import sys, occ_gnn_tpu_torch, occ_gnn_tpu_torch.parallel.model,"
            " occ_gnn_tpu_torch.ops.gat_attention; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'occ_gnn_tpu' or "
            "m.startswith('occ_gnn_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _extern_c_arities(text):
    out = {}
    for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                         text):
        params = [p for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = len(params)
    return out


def test_ctypes_argtypes_match_the_c_entries():
    arities = _extern_c_arities(SOURCE.read_text())
    bound = dict(ga.ARGTYPES, cuda_error_string=build.ERROR_STRING_ARGTYPES)
    assert set(arities) == set(bound)
    for name, n in arities.items():
        assert len(bound[name]) == n, name
    for argtypes in ga.ARGTYPES.values():
        assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float) for t in argtypes)
    # The wrapper sizes the backward's dwl partials, one a block of its
    # plan's grid (the `_any` kernel's, one a warp), and passes the staged
    # kernels the layout it plans: the C struct's ints, in its order.
    text = SOURCE.read_text()
    assert ("dwl_part [partials, h, heads] (a block's partial each,\n"
            "// `grid` of them; the `_any` kernel's a warp's, 8 * grid)"
            in text)
    body = re.search(r"struct Layout \{(.*?)\n\};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            kind, names = decl.split(None, 1)
            assert kind == "int", decl
            fields += [n.strip() for n in names.split(",")]
    assert tuple(fields) == ga.LAYOUT_FIELDS
    assert ga.Plan(8, 2, 5, None).partials == 40
    # Two blocks of MAX_WARPS warps an SM at most, as the staged kernels'
    # launch bounds give each thread registers for; the `_any` kernels'
    # blocks are ANY_WARPS warps.
    assert re.search(rf"constexpr int kMaxWarps = {ga.MAX_WARPS};", text)
    assert re.search(rf"constexpr int kWarps = {ga.ANY_WARPS};", text)
    assert "__launch_bounds__(32 * kMaxWarps, 2)" in text
    assert ga.WARPS_AN_SM == 2 * ga.MAX_WARPS
    assert not hasattr(ga, "MAX_H") and not hasattr(ga, "MAX_HEADS")


def test_kernel_is_built_from_its_source():
    assert "gat_attention" in build.KERNELS
    assert build.library_path("gat_attention").name.startswith(
        "libgat_attention-")


# (K, D, H, heads, element bytes): every shape the smoke's attention cases
# and main path give the kernels: split GAT A's layers 0-2 (layer 0 in
# bf16 too), GAT P4-B partition 0's layers 1-2, the CLI's hidden width,
# and the ragged cases; a bf16 row of odd width; and the CLI's wider
# options, whose columns no block can stage (K = 16 and 26 at H = 1024,
# H = 2048 with 4 and 8 heads).
PLAN_SHAPES = [
    (26, 123_904, 100, 4, 4), (26, 123_904, 100, 4, 2),
    (11, 22_528, 128, 4, 4), (11, 2_048, 128, 4, 4),
    (11, 11_576, 128, 4, 4), (11, 1_280, 128, 4, 4),
    (11, 8_192, 1024, 4, 4),
    (1, 300, 128, 4, 4), (26, 1_000, 100, 4, 4), (11, 1_500, 100, 2, 4),
    (11, 2_048, 128, 4, 4), (11, 700, 200, 5, 4), (26, 2_000, 100, 4, 2),
    (11, 2_000, 128, 2, 2), (25, 400, 128, 4, 4), (11, 1_500, 300, 9, 4),
    (26, 800, 602, 8, 2), (11, 64, 20, 12, 4), (26, 5_000, 301, 4, 2),
    (40, 2_000, 64, 4, 4), (26, 2_048, 1024, 4, 4), (11, 1_024, 2048, 8, 4),
    (16, 123_904, 1024, 4, 4), (26, 123_904, 1024, 4, 4),
    (11, 123_904, 2048, 8, 4), (11, 123_904, 2048, 4, 4),
]
# The main path's shapes and the ragged cases' narrower rows, which the
# staged kernels take, and the CLI's wide rows, whose columns no block can
# stage, or stage with few warps.
STAGED_SHAPES = PLAN_SHAPES[:6] + [
    (11, 700, 200, 5, 4), (11, 1_500, 300, 9, 4), (40, 2_000, 64, 4, 4),
    (11, 8_192, 512, 4, 4)]
WIDE_SHAPES = [(11, 1024, 4, 4), (26, 1024, 4, 4), (11, 2048, 8, 4),
               (16, 1024, 4, 4), (11, 2048, 4, 4)]
SMS = 132


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("K,D,H,heads,elt", PLAN_SHAPES)
def test_plan_fits_a_block_fills_the_sms_and_covers_each_column_once(
        K, D, H, heads, elt, backward):
    """The host's plan at every shape the kernels run, never raising: a
    staged plan's block within sm_90's 232,448 bytes (and the blocks it
    puts on an SM within the SM's, their warps within what the registers
    allow, at least MIN_STAGED_WARPS of them, rows read 8 bytes or more
    at a time), every SM a tile from 1,280
    columns on; else the `_any` kernels' blocks of 8 warps; a grid of at
    most the tiles, and block b's tiles b, b + grid, ... (a column a
    warp) covering every column exactly once."""
    for x_align in ((16, 2) if elt == 2 else (16, 4)):
        plan = ga.attention_plan(K, H, heads, elt, D, SMS, backward, x_align)
        tiles = -(-D // plan.tile)
        if plan.layout is not None:
            assert plan.layout == ga.layout(K, H, heads, elt, plan.tile,
                                            backward, x_align)
            assert plan.layout.total <= ga.SMEM_BLOCK
            assert (plan.per_sm * (plan.layout.total + ga.SMEM_RESERVED)
                    <= ga.SMEM_SM)
            assert 1 <= plan.tile <= ga.MAX_WARPS
            assert (ga.MIN_STAGED_WARPS[backward] <= plan.warps_an_sm
                    <= ga.WARPS_AN_SM)
            assert plan.layout.read >= ga.MIN_STAGED_READ
            assert plan.partials == plan.grid
            if D >= 1280:
                assert tiles >= SMS
            assert 1 <= plan.grid <= min(tiles, plan.per_sm * SMS)
        else:
            assert plan.tile == ga.ANY_WARPS
            assert plan.partials == plan.grid * ga.ANY_WARPS
            assert plan.grid == (min(tiles, ga.ANY_BLOCKS_AN_SM * SMS)
                                 if backward else tiles)
        seen = np.zeros(D, np.int64)
        for b in range(plan.grid):
            for t in range(b, tiles, plan.grid):
                seen[t * plan.tile:(t + 1) * plan.tile] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("K,D,H,heads,elt", STAGED_SHAPES)
def test_the_main_path_takes_the_staged_kernels(K, D, H, heads, elt,
                                                backward):
    plan = ga.attention_plan(K, H, heads, elt, D, SMS, backward)
    assert plan.layout is not None


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("K,H,heads,elt", WIDE_SHAPES)
def test_wide_rows_take_the_any_kernels(K, H, heads, elt, backward):
    staged = ga.staged_plan(K, H, heads, elt, 123_904, SMS, backward)
    assert (staged is None
            or staged.warps_an_sm < ga.MIN_STAGED_WARPS[backward])
    assert ga.attention_plan(K, H, heads, elt, 123_904, SMS,
                             backward).layout is None


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("K,H,heads,elt,x_align", [
    (26, 100, 4, 4, 16), (26, 100, 4, 2, 16), (11, 128, 4, 4, 16),
    (11, 200, 5, 4, 8), (40, 64, 4, 4, 16), (11, 20, 12, 4, 4),
    (26, 301, 4, 2, 2), (1, 3, 2, 2, 16)])
def test_layout_lays_regions_in_order_without_overlap(K, H, heads, elt,
                                                      x_align, backward):
    """The staged kernels' layout: 16-byte-aligned regions in the order
    the kernel's comments give, each as large as what the kernel keeps
    there, a block's wl first and the tile's warps after it."""
    tile = 3
    lay = ga.layout(K, H, heads, elt, tile, backward, x_align)
    groups = -(-heads // ga.HEAD_GROUP)
    assert lay.groups == groups and lay.stages == ga.STAGES
    assert lay.wl64 == 0
    assert lay.wl32 >= 8 * groups * lay.nvec * lay.wunit
    assert lay.warp >= lay.wl32 + (4 * groups * 4 * H if backward else 0)
    regions = [("rows", lay.stages * K * lay.stride),
               ("dagg", lay.stages * lay.dstage if backward else 0),
               ("ids", 4 * (lay.stages + 1) * K),
               ("z", 4 * K * groups * 4),
               ("pw", 4 * K * groups * 4 if backward else 0),
               ("dwl", 4 * groups * H * 4 if backward else 0),
               ("bar", 8 * lay.stages)]
    end = 0
    for name, size in regions:
        at = getattr(lay, name)
        assert at % 16 == 0 and at >= end, name
        end = at + size
    assert end <= lay.per_warp
    assert lay.dstage >= 4 * heads * H and lay.dstage % 16 == 0
    assert lay.total == lay.warp + tile * lay.per_warp
    assert all(v % 16 == 0 for v in (lay.wl32, lay.warp, lay.per_warp))


@pytest.mark.parametrize("H,elt,x_align", [
    (100, 4, 16), (128, 4, 16), (200, 4, 8), (300, 4, 16), (1024, 4, 16),
    (13, 4, 4), (100, 2, 16), (128, 2, 16), (602, 2, 16), (301, 2, 16),
    (301, 2, 2), (100, 4, 4), (3, 2, 16)])
def test_staged_rows_cover_the_row_and_read_without_bank_conflicts(
        H, elt, x_align):
    """A staged row's room holds the row's 16-byte-aligned window wherever
    the row starts (a multiple of the read unit past 16 bytes), rows are an
    odd number of 16 bytes apart, and where rows are whole 16-byte units on
    16-byte boundaries a warp reading one unit of 32 consecutive staged
    rows touches each bank once per memory phase (8 lanes of 16 bytes)."""
    read, bulk, stride, nvec = ga.row_layout(H, elt, x_align)
    rowbytes = H * elt
    assert read in (2, 4, 8, 16) and nvec * read == rowbytes
    assert rowbytes % read == 0 and x_align % read == 0
    assert stride % 16 == 0 and (stride // 16) % 2 == 1
    assert bulk == (rowbytes >= 16)
    for shift in (range(0, 16, read) if bulk else [0]):
        start = shift
        window = (start + rowbytes + 15) // 16 * 16
        assert window <= stride
    if read == 16:
        for j in range(nvec):
            banks = [(q * stride + j * 16) // 16 % 8 for q in range(32)]
            for p in range(0, 32, 8):
                assert len(set(banks[p:p + 8])) == 8
