"""Split GAT's layer tail (``ops/gat_attention.gat_tail``): the merged
softmax partials ``(s, v)`` to the layer's output at its owned rows, one
hand-written kernel each way on the card.

On the CPU the op computes its plain version, which is the torch chain
the model ran before (``_chain`` below, its lines as they were): the
forward equal to it bit for bit, and the explicit backward formula equal
to autograd of it, on synthetic rows and on the owned rows of real layers
at P = 1 and P = 2, with padded owned rows, a zero softmax sum (clamped
to 1e-16) and ``v`` contiguous or head-major. The kernels take the
owned rows as the dst frame's prefix and read no owned index; every
layer builder is held to that here. Tests marked ``card`` run on the CUDA card only, without
JAX: ``python -m pytest --noconftest tests/test_torch_gat_tail.py -m
card``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.nn import functional as F
from torch.profiler import ProfilerActivity, profile

from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.data.partition import partition_graph
from occ_gnn_tpu_torch.ops import gat_attention as ga
from occ_gnn_tpu_torch.parallel import model as pm
from occ_gnn_tpu_torch.parallel.model import (
    SplitGAT,
    _materialize_layers,
    make_device_csr,
    make_split_train_step,
)
from occ_gnn_tpu_torch.sampling import slicer as tsl
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
from occ_gnn_tpu_torch.utils.profile import NAMED_RANGES

GRAPH_KW = dict(num_nodes=400, avg_degree=5, feature_dim=8, num_classes=4,
                seed=11)
FANOUTS = [3, 3, 3]
BATCH = 32
HEADS = 4
SOURCE = (Path(__file__).resolve().parent.parent / "occ_gnn_tpu_torch"
          / "csrc" / "gat_attention.cu")


@pytest.fixture(scope="module")
def graph():
    return random_graph(**GRAPH_KW)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


def _chain(v, s, owned_idx, owned_mask, b):
    """``SplitGAT.layers``' tail and ``forward_partitions``' ELU before
    the kernels, line for line."""
    k, d_out = v.shape[1:]
    own = owned_idx.clamp(min=0)
    s_own = s.index_select(0, own).clamp(min=1e-16)
    h = v.index_select(0, own) / s_own[..., None]
    h = h * owned_mask[:, None, None]
    if b is None:
        return h.mean(dim=1)
    return F.elu((h.reshape(-1, k * d_out) + b) * owned_mask[:, None])


def _owned(O, n_own, device="cpu"):
    """The owned rows as every sampler builds them: the first ``n_own``
    name themselves, the rest are pads (-1)."""
    idx = torch.full((O,), -1, dtype=torch.int32, device=device)
    idx[:n_own] = torch.arange(n_own, dtype=torch.int32, device=device)
    return idx, idx >= 0


def _inputs(D, heads, dh, layout, last, gen, device="cpu"):
    """``v`` (contiguous, or head-major as the per-head projection gives
    it), ``s`` with a zero sum at row 1 head 0 (a row whose slots all
    padded: v is 0 there too) and ``b`` (None on the last layer)."""
    if layout == "head_major":
        v = torch.randn(heads, D, dh, generator=gen).permute(1, 0, 2)
    else:
        v = torch.randn(D, heads, dh, generator=gen)
    s = torch.rand(D, heads, generator=gen) * 3 + 0.1
    if D > 1:
        s[1, 0] = 0.0
        v[1, 0] = 0.0
    b = None if last else torch.randn(heads * dh, generator=gen)
    to = (lambda t: None if t is None else t.to(device))
    return to(v), to(s), to(b)


def _autograd_chain(dy, v, s, owned_idx, owned_mask, b):
    leaves = [t.detach().clone().requires_grad_() for t in (v, s)]
    if b is not None:
        leaves.append(b.detach().clone().requires_grad_())
    y = _chain(leaves[0], leaves[1], owned_idx, owned_mask,
               leaves[2] if b is not None else None)
    grads = torch.autograd.grad(y, leaves, dy)
    return grads[0], grads[1], grads[2] if b is not None else None


def _assert_close(got, want):
    scale = max(float(want.abs().max()), 1e-30) if want.numel() else 1.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


def _check_plain(v, s, owned_idx, owned_mask, b, gen):
    y_chain = _chain(v, s, owned_idx, owned_mask, b)
    assert torch.equal(ga.gat_tail_reference(v, s, owned_idx, owned_mask,
                                             b), y_chain)
    assert torch.equal(ga.gat_tail(v, s, owned_idx, owned_mask, b), y_chain)
    dy = torch.randn(y_chain.shape, generator=gen)
    dv, ds, db = _autograd_chain(dy, v, s, owned_idx, owned_mask, b)
    got = ga.gat_tail_backward_reference(dy, v, s, owned_idx, owned_mask, b)
    for g, w in zip(got, (dv, ds, db)):
        if w is None:
            assert g is None
        else:
            _assert_close(g, w)
    # The autograd Function takes the explicit formula on the CPU.
    leaves = [t.detach().clone().requires_grad_() for t in (v, s)]
    bl = None if b is None else b.detach().clone().requires_grad_()
    y = ga.gat_tail(leaves[0], leaves[1], owned_idx, owned_mask, bl)
    assert y.grad_fn.name() == "_GatTailBackward"
    y.backward(dy)
    _assert_close(leaves[0].grad, dv)
    _assert_close(leaves[1].grad, ds)
    if b is not None:
        _assert_close(bl.grad, db)
    return dv, ds


@pytest.mark.parametrize("layout", ["contiguous", "head_major"])
@pytest.mark.parametrize("last", [False, True], ids=["hidden", "last"])
@pytest.mark.parametrize("D,O,n_own,heads", [(40, 32, 25, 4),
                                             (24, 30, 24, 4),
                                             (16, 16, 9, 3),
                                             (9, 9, 0, 4)])
def test_plain_tail_is_the_chain(D, O, n_own, heads, last, layout):
    gen = torch.Generator().manual_seed(D * 100 + O)
    dh = 5 if last else 6
    v, s, b = _inputs(D, heads, dh, layout, last, gen)
    owned_idx, owned_mask = _owned(O, n_own)
    dv, ds = _check_plain(v, s, owned_idx, owned_mask, b, gen)
    # Rows no owned row names take no gradient; nor does a zero sum.
    assert (dv[n_own:] == 0).all() and (ds[n_own:] == 0).all()
    if n_own > 1:
        assert ds[1, 0] == 0 and dv[1, 0].abs().max() > 1e10


def _batches(graph, parts, builder, n=2):
    """``n`` batches of a layer builder at P = ``parts``, device-sampled
    layers synthesised: ``[batch][layer][partition]``."""
    pmap = (np.zeros(graph.num_nodes, np.int32) if parts == 1 else
            partition_graph(graph, parts, mode="greedy", attach=False))
    csr = gen = None
    if builder == "numpy":
        sampler = tsl.SplitSampler(graph, graph.train_nodes(), pmap, parts,
                                   FANOUTS, BATCH, seed=5,
                                   scatter_plans=True, device="cpu")
    else:
        kw = {}
        if builder == "native_device":
            kw = dict(cache=CachePlan(graph, pmap, parts, 1.0,
                                      refresh_cap=8), innermost="device")
            csr = make_device_csr(graph, "cpu")
            gen = [torch.Generator().manual_seed(p) for p in range(parts)]
        sampler = NativeSplitSampler(graph, graph.train_nodes(), pmap, parts,
                                     FANOUTS, BATCH, seed=5, num_workers=2,
                                     scatter_plans=True, device="cpu", **kw)
    out = []
    try:
        for i, batch in enumerate(sampler):
            if i == n:
                break
            layers = _materialize_layers(
                [[lyr.partition(p) for lyr in batch.layers]
                 for p in range(parts)], csr, gen)
            out.append([[layers[p][l] for p in range(parts)]
                        for l in range(len(FANOUTS))])
    finally:
        if hasattr(sampler, "close"):
            sampler.close()
    return out


@pytest.mark.parametrize("builder", ["numpy", "native", "native_device"])
@pytest.mark.parametrize("parts", [1, 2])
def test_every_layer_builder_owns_a_prefix(graph, parts, builder):
    """The kernels read and write dst row o for owned row o: the owned
    rows are the first ``num_owned`` of the dst frame, in order."""
    seen = 0
    for batch in _batches(graph, parts, builder):
        for lyrs in batch:
            for lyr in lyrs:
                n = int(lyr.num_owned)
                idx, mask = lyr.owned_idx, lyr.owned_mask.bool()
                assert torch.equal(mask, idx >= 0)
                assert torch.equal(idx[:n], torch.arange(n, dtype=idx.dtype))
                assert (idx[n:] == -1).all()
                assert n <= lyr.dst_cap
                seen += n > 0
    assert seen


@pytest.mark.parametrize("last", [False, True], ids=["hidden", "last"])
@pytest.mark.parametrize("parts", [1, 2])
def test_plain_tail_at_real_layers(graph, parts, last):
    gen = torch.Generator().manual_seed(parts)
    dh = 5 if last else 6
    for lyrs in _batches(graph, parts, "native", n=1)[0]:
        for lyr in lyrs:
            v, s, b = _inputs(lyr.dst_cap, HEADS, dh, "head_major", last,
                              gen)
            _check_plain(v, s, lyr.owned_idx, lyr.owned_mask, b, gen)


def test_split_gat_runs_the_tail_once_a_layer(graph, monkeypatch):
    """Every layer's output is its tail's, the last with the heads' mean
    and no bias, and the next layer reads it as it is: the model adds no
    ELU of its own."""
    tails, inputs = [], []

    def spy(v, s, owned_idx, owned_mask, b=None):
        tails.append((b is None, ga.gat_tail(v, s, owned_idx, owned_mask,
                                             b)))
        return tails[-1][1]

    layers = SplitGAT.layers

    def seen(self, i, lyrs, xs, is_last):
        inputs.append(xs[0])
        return layers(self, i, lyrs, xs, is_last)

    monkeypatch.setattr(pm, "gat_tail", spy)
    monkeypatch.setattr(SplitGAT, "layers", seen)
    pmap = np.zeros(graph.num_nodes, np.int32)
    plan = CachePlan(graph, pmap, 1, 1.0, refresh_cap=8)
    sampler = NativeSplitSampler(graph, graph.train_nodes(), pmap, 1,
                                 FANOUTS, BATCH, seed=3, cache=plan,
                                 num_workers=2, innermost="device",
                                 scatter_plans=True, device="cpu")
    model = SplitGAT(graph.feature_dim, 4, graph.num_classes, len(FANOUTS),
                     num_heads=HEADS,
                     generator=torch.Generator().manual_seed(1))
    fwd = pm.make_split_forward(model, csr=make_device_csr(graph, "cpu"))
    try:
        frames = SplitFeatureCache(plan, device="cpu").frames
        logits = fwd(next(iter(sampler)), frames,
                     sample_generator=torch.Generator().manual_seed(7))
    finally:
        sampler.close()
    assert [last for last, _ in tails] == [False, False, True]
    assert inputs[1] is tails[0][1] and inputs[2] is tails[1][1]
    assert torch.equal(logits[0], tails[2][1])


def test_tail_kernels_stay_out_of_the_attention_roofline():
    """``gat_attention_roofline`` times the kernels whose names hold
    ``attention_fwd`` or ``attention_bwd``: the tail's hold neither."""
    kernels = re.findall(
        r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
        SOURCE.read_text())
    tail = [k for k in kernels if "tail" in k]
    assert sorted(tail) == ["gat_tail_bwd_kernel", "gat_tail_fwd_kernel"]
    for k in tail:
        assert "attention_fwd" not in k and "attention_bwd" not in k
    assert {"gat_tail", "_GatTailBackward"} <= set(NAMED_RANGES)


def test_tail_refuses_what_the_kernels_do_not_take():
    v = torch.zeros(4, 2, 3)
    s = torch.ones(4, 2)
    idx, mask = _owned(4, 4)
    with pytest.raises(TypeError):
        ga.gat_tail(v.double(), s, idx, mask)
    with pytest.raises(TypeError):
        ga.gat_tail(v, s[:, :1], idx, mask)
    with pytest.raises(TypeError):
        ga.gat_tail(v, s, idx.long(), mask)
    with pytest.raises(TypeError):
        ga.gat_tail(v, s, idx, mask, torch.zeros(5))


# Layer 0, 1 and 2 of gat-split-b4096 (dst rows, owned rows, valid owned
# rows, dh, last), and a COO-like v whose rows are a slice of wider rows.
CARD_SHAPES = {"layer0": (495_616, 495_616, 366_381, 128, False,
                          "head_major"),
               "layer1": (90_112, 45_056, 40_741, 128, False, "head_major"),
               "layer1_contiguous": (90_112, 45_056, 40_741, 128, False,
                                     "contiguous"),
               "layer2": (8_192, 4_096, 4_096, 47, True, "head_major"),
               "layer2_padded": (8_192, 4_096, 3_001, 47, True,
                                 "head_major"),
               "coo_slice": (1_000, 1_000, 700, 31, False, "slice")}


@pytest.mark.card
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernels_match_the_plain_version(card, shape):
    D, O, n_own, dh, last, layout = CARD_SHAPES[shape]
    gen = torch.Generator().manual_seed(D + n_own)
    if layout == "slice":
        wide, s, b = _inputs(D, HEADS, dh + 1, "contiguous", last, gen, card)
        v = wide[..., 1:]
        b = None if last else b[:HEADS * dh].contiguous()
    else:
        v, s, b = _inputs(D, HEADS, dh, layout, last, gen, card)
    owned_idx, owned_mask = _owned(O, n_own, card)
    fwd0, bwd0 = ga.gat_tail_fwd.launches, ga.gat_tail_bwd.launches
    y = ga.gat_tail_fwd(v, s, owned_idx, owned_mask, b)
    want = ga.gat_tail_reference(v, s, owned_idx, owned_mask, b)
    torch.cuda.synchronize(card)
    # Bit-equal to the chain at the owned rows; zeros at the pads (the
    # chain's may be -0).
    assert torch.equal(y[:n_own].view(torch.int32),
                       want[:n_own].view(torch.int32))
    assert torch.equal(y, want)
    dy = torch.randn(y.shape, generator=gen).to(card)
    got = ga.gat_tail_bwd(dy, v, s, owned_idx, owned_mask, b)
    again = ga.gat_tail_bwd(dy, v, s, owned_idx, owned_mask, b)
    ref = ga.gat_tail_backward_reference(dy, v, s, owned_idx, owned_mask, b)
    torch.cuda.synchronize(card)
    assert ga.gat_tail_fwd.launches == fwd0 + 1
    assert ga.gat_tail_bwd.launches == bwd0 + 2
    dv, ds, db = got
    assert dv.stride() == v.stride() or layout == "slice"
    for g, a, w in zip(got, again, ref):
        if w is None:
            assert g is None and a is None
            continue
        assert torch.equal(g, a)  # two launches, the same bits
        _assert_close(g, w)
    assert (dv[n_own:] == 0).all() and (ds[n_own:] == 0).all()
    assert ds[1, 0] == 0


def _gat_step(graph, card):
    pmap = np.zeros(graph.num_nodes, np.int32)
    plan = CachePlan(graph, pmap, 1, 1.0, refresh_cap=8)
    sampler = NativeSplitSampler(graph, graph.train_nodes(), pmap, 1,
                                 FANOUTS, BATCH, seed=3, cache=plan,
                                 num_workers=2, innermost="device",
                                 scatter_plans=True, device=card)
    model = SplitGAT(graph.feature_dim, 8, graph.num_classes, len(FANOUTS),
                     num_heads=HEADS,
                     generator=torch.Generator().manual_seed(1)).to(card)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_split_train_step(model, opt,
                                 csr=make_device_csr(graph, card))
    frames = SplitFeatureCache(plan, device=card).frames
    gen = torch.Generator(card).manual_seed(7)
    batches = iter(sampler)
    return sampler, lambda: step(next(batches), frames, sample_generator=gen)


@pytest.mark.card
def test_a_split_gat_step_launches_the_tail(card, graph):
    """A step at P = 1 runs the tail's kernels three times each way, and
    nothing under the tail's ranges is the chain's ``index_add_``."""
    sampler, step = _gat_step(graph, card)
    try:
        step()
        torch.cuda.synchronize(card)
        fwd0, bwd0 = ga.gat_tail_fwd.launches, ga.gat_tail_bwd.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize(card)
        assert ga.gat_tail_fwd.launches - fwd0 == 3
        assert ga.gat_tail_bwd.launches - bwd0 == 3
    finally:
        sampler.close()
    under = {"gat_tail": [], "_GatTailBackward": []}
    for e in prof.events():
        kernels = [k.name for k in getattr(e, "kernels", [])]
        p = e
        while p is not None and kernels:
            if p.name in under:
                under[p.name] += kernels
                break
            p = p.cpu_parent
    for name, kernels in under.items():
        assert not [k for k in kernels if "indexFuncLargeIndex" in k], name
    assert sum("gat_tail_fwd_kernel" in k for k in under["gat_tail"]) == 3
    assert sum("gat_tail_bwd_kernel" in k
               for k in under["_GatTailBackward"]) == 3
