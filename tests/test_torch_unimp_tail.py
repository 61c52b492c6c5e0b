"""UniMP's layer tail (``ops/unimp_tail``): the merged softmax partials
``(s, v)`` of the query-key attention, the skip and the weights to the
layer's output at its owned rows, one hand-written kernel each way on the
card (``csrc/unimp_tail.cu``).

On the CPU: the C entries' ctypes signatures, the wrapper's input checks,
the launch counter and the profile summary's key, and the plain forward
against the reference chain (the explicit backward is held to autograd of
that chain by ``tests/test_torch_split_unimp.py``). Tests marked ``card``
run on the CUDA card only, without JAX: ``python -m pytest --noconftest
tests/test_torch_unimp_tail.py -m card``: the kernels against the plain
versions (forward ``unimp_tail_reference``, backward the explicit
formula at the kernel's ReLU mask, both also in float64) at the
benchmark cell's three layers, the smoke's width, the CLI's default
width (the shared-row form) and an unaligned ``v``, and a split UniMP
step's launches and kernels.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.ops import build
from occ_gnn_tpu_torch.ops import unimp_tail as ut
from occ_gnn_tpu_torch.parallel.model import (
    SplitUniMP,
    make_device_csr,
    make_split_train_step,
)
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler

SOURCE = (Path(__file__).resolve().parent.parent / "occ_gnn_tpu_torch"
          / "csrc" / "unimp_tail.cu")
ZERO_COUNTS = {"fwd_register": 0, "fwd_shared": 0, "bwd_register": 0,
               "bwd_shared": 0}
# The kernels against the float64 plain versions: the forward's row sums
# are f64 where the chain's are f32, so the kernel is the closer; the
# gradients are f32 sums over every owned row (the gate's weights' cancel).
FWD_TOL = 2e-6
GRAD_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


def _inputs(D, O, n_own, heads, dh, last, layout, gen, device="cpu"):
    """``v`` (head-major as the value projection gives it, contiguous, or
    a slice of wider rows: no 8-byte alignment), ``s`` with a zero sum at
    row 1 head 0 (a row whose slots all padded: v is 0 there too), the
    owned rows (the first ``n_own`` valid), the skip and the weights."""
    width = dh if last else heads * dh
    if layout == "head_major":
        v = torch.randn(heads, D, dh, generator=gen).permute(1, 0, 2)
    elif layout == "slice":
        v = torch.randn(D, heads, dh + 1, generator=gen)[..., 1:]
    else:
        v = torch.randn(D, heads, dh, generator=gen)
    s = torch.rand(D, heads, generator=gen) * 3 + 0.1
    if D > 1:
        s[1, 0] = 0.0
        v[1, 0] = 0.0
    mask = torch.zeros(O, dtype=torch.bool)
    mask[:n_own] = True
    idx = torch.where(mask, torch.arange(O, dtype=torch.int32), -1).int()
    r = torch.randn(O, width, generator=gen)
    b_v = 0.1 * torch.randn(heads * dh, generator=gen)
    w_beta = torch.randn(3 * width, 1, generator=gen) / width ** 0.5
    ln = (None, None) if last else (
        0.1 * torch.randn(width, generator=gen),
        0.1 * torch.randn(width, generator=gen))
    return [None if t is None else t.to(device)
            for t in (v, s, r, b_v, w_beta, idx, mask, *ln)]


def _extern_c_arities(text):
    out = {}
    for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                         text):
        out[m.group(1)] = len([p for p in m.group(2).split(",")
                               if p.strip()])
    return out


def _row_floats():
    """A lane's floats of a row in the kernels' register form."""
    return int(re.search(r"constexpr int kRowFloats = (\d+);",
                         SOURCE.read_text())[1])


def test_ctypes_argtypes_match_the_c_entries():
    text = SOURCE.read_text()
    arities = _extern_c_arities(text)
    bound = dict(ut.ARGTYPES, cuda_error_string=build.ERROR_STRING_ARGTYPES)
    assert set(arities) == set(bound)
    for name, n in arities.items():
        assert len(bound[name]) == n, name
    for argtypes in ut.ARGTYPES.values():
        assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double) for t in argtypes)
    assert 32 * _row_floats() == 512  # the register form's widest row
    assert re.search(rf"constexpr int kMaxHeads = {ut.MAX_HEADS};", text)
    assert "unimp_tail" in build.KERNELS


@pytest.mark.parametrize("edit", [
    "v_2d", "s_shape", "r_shape", "more_owned", "b_v_shape",
    "w_beta_shape", "ln_alone", "ln_shape", "mask_int", "mask_2d",
    "r_double", "s_elsewhere"])
def test_tail_refuses_what_the_kernels_do_not_take(edit):
    gen = torch.Generator().manual_seed(1)
    v, s, r, b_v, w_beta, _, mask, ln_g, ln_b = _inputs(6, 5, 4, 2, 3,
                                                         False, "contiguous",
                                                         gen)
    args = dict(v=v, s=s, r=r, b_v=b_v, w_beta=w_beta, owned_mask=mask,
                ln_g=ln_g, ln_b=ln_b)
    error = TypeError
    if edit == "v_2d":
        args["v"] = v.reshape(6, -1)
    elif edit == "s_shape":
        args["s"] = s[:, :1]
    elif edit == "r_shape":
        args["r"] = r[:, 1:]
    elif edit == "more_owned":
        args["owned_mask"] = torch.ones(7, dtype=torch.bool)
        args["r"] = torch.zeros(7, 6)
        error = ValueError
    elif edit == "b_v_shape":
        args["b_v"] = b_v[1:]
    elif edit == "w_beta_shape":
        args["w_beta"] = w_beta.view(-1)
    elif edit == "ln_alone":
        args["ln_b"] = None
    elif edit == "ln_shape":
        args["ln_g"] = ln_g[1:]
    elif edit == "mask_int":
        args["owned_mask"] = mask.int()
    elif edit == "mask_2d":
        args["owned_mask"] = mask[:, None]
    elif edit == "r_double":
        args["r"] = r.double()
    else:
        args["s"] = s.to("meta")
        error = ValueError
    with pytest.raises(error):
        ut.unimp_tail(**args)


def test_counts_name_each_direction_and_form():
    """The CPU path launches no kernel; the reset clears the counts."""
    ut.reset_unimp_tail_counts()
    assert ut.unimp_tail_counts() == ZERO_COUNTS
    gen = torch.Generator().manual_seed(2)
    v, s, r, b_v, w_beta, _, mask, ln_g, ln_b = _inputs(8, 6, 5, 2, 4,
                                                        False, "head_major",
                                                        gen)
    leaves = [t.requires_grad_() for t in (v, s, r, b_v, w_beta, ln_g,
                                           ln_b)]
    ut.unimp_tail(*leaves[:5], mask, *leaves[5:]).sum().backward()
    assert ut.unimp_tail_counts() == ZERO_COUNTS
    ut._LAUNCHES["fwd", "shared"] += 2
    assert ut.unimp_tail_counts()["fwd_shared"] == 2
    ut.reset_unimp_tail_counts()
    assert ut.unimp_tail_counts() == ZERO_COUNTS


@pytest.mark.parametrize("last", [False, True], ids=["hidden", "last"])
def test_plain_forward_is_the_reference(last):
    """``unimp_tail_plain`` (the CPU's forward) gives the reference chain's
    rows, zeros at the pads, and LayerNorm's statistics of a hidden
    layer."""
    gen = torch.Generator().manual_seed(3)
    v, s, r, b_v, w_beta, idx, mask, ln_g, ln_b = _inputs(
        12, 10, 7, 3, 4, last, "head_major", gen)
    y, mean, rstd = ut.unimp_tail_plain(v, s, r, b_v, w_beta, mask, ln_g,
                                        ln_b)
    want = ut.unimp_tail_reference(v, s, r, b_v, w_beta, idx, mask, ln_g,
                                   ln_b)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    assert (y[7:] == 0).all()
    if last:
        assert mean is None and rstd is None
    else:
        assert mean.shape == rstd.shape == (10, 1)
        assert (rstd[:7] > 0).all()


def test_profile_summary_reports_the_tail_launches(tmp_path):
    """The split CLI's ``--profile-dir`` summary carries the tail kernels'
    launch counts (none on the CPU)."""
    m = train.main(["--graph", "community", "--model-name", "unimp",
                    "--num-heads", "2", "--num-hidden", "8", "--fan-out",
                    "4,4", "--batch-size", "128", "--num-nodes", "1200",
                    "--num-epochs", "1", "--mode", "split", "--cache-per",
                    "auto", "--cpu", "--cpu-devices", "1", "--profile-dir",
                    str(tmp_path)])
    assert m["profile"]["unimp_tail_launches"] == ZERO_COUNTS
    assert set(m["profile"]["qk_attention_launches"]) == {
        "fwd_staged", "fwd_any", "bwd_staged", "bwd_any"}


# -- on the card ---------------------------------------------------------------

# (D, O, valid owned rows, heads, dh, last, v's layout): unimp-split-b4096's
# layers 0-2 (4 heads of 128; the last layer 47 classes), layer 2 with pads,
# the smoke's split UniMP A layer 1 (4 x 32), the CLI's default width (4 x
# 256: the shared-row form), and a v whose rows are a slice of wider rows
# (4-byte reads).
CARD_SHAPES = {
    "cell_layer0": (495_616, 495_616, 366_381, 4, 128, False, "head_major"),
    "cell_layer1": (90_112, 45_056, 40_741, 4, 128, False, "head_major"),
    "cell_layer1_contiguous": (90_112, 45_056, 40_741, 4, 128, False,
                               "contiguous"),
    "cell_layer2": (8_192, 4_096, 4_096, 4, 47, True, "head_major"),
    "cell_layer2_padded": (8_192, 4_096, 3_001, 4, 47, True, "head_major"),
    "smoke_layer1": (22_528, 11_264, 9_243, 4, 32, False, "head_major"),
    "cli_width": (8_192, 4_096, 3_000, 4, 256, False, "head_major"),
    "unaligned": (1_000, 1_000, 700, 3, 31, False, "slice"),
}


def _rel(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.double() - want.double()).abs().max()) / scale


@pytest.mark.card
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernels_match_the_plain_version(card, shape):
    D, O, n_own, heads, dh, last, layout = CARD_SHAPES[shape]
    gen = torch.Generator().manual_seed(D + n_own)
    v, s, r, b_v, w_beta, idx, mask, ln_g, ln_b = _inputs(
        D, O, n_own, heads, dh, last, layout, gen, card)
    width = dh if last else heads * dh
    form = "shared" if width > 32 * _row_floats() else "register"
    before = ut.unimp_tail_counts()
    outs = [ut.unimp_tail_fwd(v, s, r, b_v, w_beta, mask, ln_g, ln_b)
            for _ in range(2)]
    y, mean, rstd = outs[0]
    for a, b in zip(*outs):
        assert (a is None and b is None) or torch.equal(a, b)
    want = ut.unimp_tail_reference(v, s, r, b_v, w_beta, idx, mask, ln_g,
                                   ln_b)
    f64 = [None if t is None else t.double()
           for t in (v, s, r, b_v, w_beta, ln_g, ln_b)]
    want64 = ut.unimp_tail_reference(*f64[:5], idx, mask, *f64[5:])
    assert (y[n_own:] == 0).all()
    fwd, chain = _rel(y, want64), _rel(want, want64)
    assert fwd <= FWD_TOL, (shape, fwd, chain)
    if not last:
        _, mean_p, rstd_p = ut.unimp_tail_plain(v, s, r, b_v, w_beta, mask,
                                                ln_g, ln_b)
        assert _rel(mean[:n_own], mean_p[:n_own, 0]) <= FWD_TOL
        assert _rel(rstd[:n_own], rstd_p[:n_own, 0]) <= FWD_TOL
        assert (mean[n_own:] == 0).all() and (rstd[n_own:] == 0).all()
    del outs, want, want64
    dy = torch.randn(y.shape, generator=gen).to(card)
    grads = [ut.unimp_tail_bwd(dy, v, s, r, b_v, w_beta, mask, ln_g, ln_b,
                               mean, rstd) for _ in range(2)]
    # At the kernel's ReLU mask: an element within rounding of 0 takes
    # either sign in another summation order, and moves its row's
    # gradients by O(1).
    ref = ut.unimp_tail_backward_reference(dy, v, s, r, b_v, w_beta, mask,
                                           ln_g, ln_b, y)
    ref64 = ut.unimp_tail_backward_reference(dy.double(), *f64[:5], mask,
                                             *f64[5:], y)
    torch.cuda.synchronize(card)
    names = ("dv", "ds", "dr", "db_v", "dw_beta", "dln_g", "dln_b")
    for name, g, again, w, w64 in zip(names, *grads, ref, ref64):
        if w is None:
            assert g is None and again is None
            continue
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert torch.equal(g, again), name  # two launches, the same bits
        err = _rel(g, w64)
        assert err <= GRAD_TOL, (shape, name, err, _rel(w, w64))
    dv, ds, dr = grads[0][:3]
    assert dv.stride() == v.stride()
    assert (dv[n_own:] == 0).all() and (ds[n_own:] == 0).all()
    assert (dr[n_own:] == 0).all() and ds[1, 0] == 0
    after = ut.unimp_tail_counts()
    assert after[f"fwd_{form}"] - before[f"fwd_{form}"] == 2
    assert after[f"bwd_{form}"] - before[f"bwd_{form}"] == 2


@pytest.mark.card
def test_a_split_unimp_step_launches_the_tail(card):
    """A step at P = 1 runs the tail's kernels three times each way, all
    in registers, and under the tail's ranges no torch elementwise kernel
    runs but the skip's ``addmm``'s."""
    graph = random_graph(num_nodes=500, avg_degree=6, feature_dim=16,
                         num_classes=5, seed=1)
    pmap = np.zeros(graph.num_nodes, np.int32)
    plan = CachePlan(graph, pmap, 1, 1.0, refresh_cap=8)
    sampler = NativeSplitSampler(graph, graph.train_nodes(), pmap, 1,
                                 [3, 3, 3], 32, seed=3, cache=plan,
                                 num_workers=2, innermost="device",
                                 scatter_plans=True, device=card)
    model = SplitUniMP(graph.feature_dim, 8, graph.num_classes, 3,
                       num_heads=4,
                       generator=torch.Generator().manual_seed(1)).to(card)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_split_train_step(model, opt,
                                 csr=make_device_csr(graph, card))
    frames = SplitFeatureCache(plan, device=card).frames
    gen = torch.Generator(card).manual_seed(7)
    batches = iter(sampler)
    try:
        step(next(batches), frames, sample_generator=gen)
        torch.cuda.synchronize(card)
        before = ut.unimp_tail_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loss = step(next(batches), frames, sample_generator=gen)[0]
            torch.cuda.synchronize(card)
        after = ut.unimp_tail_counts()
    finally:
        sampler.close()
    assert np.isfinite(float(loss))
    assert {k: after[k] - before[k] for k in after} == {
        "fwd_register": 3, "fwd_shared": 0, "bwd_register": 3,
        "bwd_shared": 0}
    under = {"unimp_tail": [], "_UnimpTailBackward": []}
    for e in prof.events():
        kernels = [k.name for k in getattr(e, "kernels", [])]
        p, skip = e, False
        while p is not None and kernels:
            skip = skip or p.name == "aten::addmm"
            if p.name in under:
                if not skip:
                    under[p.name] += kernels
                break
            p = p.cpu_parent
    for name, kernels in under.items():
        assert not [k for k in kernels if "elementwise_kernel" in k], (
            name, kernels)
    assert sum("unimp_tail_fwd_kernel" in k
               for k in under["unimp_tail"]) == 3
    assert sum("unimp_tail_bwd_kernel" in k
               for k in under["_UnimpTailBackward"]) == 3
