"""UniMP's graph transformer on the port's split path
(``parallel/model.SplitUniMP``), held to its plain reference
(``occ_gnn_tpu_torch/reference/unimp.py``): the JAX package has no such
model.

On the CPU: the query-key attention's plain path and explicit backward
(an f64 gradient check, and against autograd of the plain chain); the
layer tail's explicit backward against autograd; ``SplitUniMP`` at P = 1
against the reference in f64 (logits, loss and every leaf's gradient),
at P = 2 in this process and at P = 4 over gloo ranks against P = 1; the
port's reference against the benchmark's copy; the CLI; the host's plan
of the kernels at the benchmark cell's shapes; the spans. Tests marked
``card`` run on the CUDA card only, without JAX: ``python -m pytest
--noconftest tests/test_torch_split_unimp.py -m card``.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from gnnbench.metrics import qk_attention_roofline
from gnnbench.reference import unimp as bench_reference
from gnnbench.reference.samples import Refs
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.data.partition import partition_graph
from occ_gnn_tpu_torch.ops import gat_attention as ga
from occ_gnn_tpu_torch.ops import unimp_tail as ut
from occ_gnn_tpu_torch.parallel.model import (
    SplitUniMP,
    make_device_csr,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.reference import unimp as reference
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
from occ_gnn_tpu_torch.sampling.slicer import SplitSampler
from occ_gnn_tpu_torch.training import gather_features
from occ_gnn_tpu_torch.utils.profile import NAMED_RANGES
from torch_ranks import run_ranks, split_rank

GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
FANOUTS, BATCH, HIDDEN, HEADS, SEED = [4, 3], 32, 6, 2, 7
# The f32 port against the f64 reference: products and sums of a few
# hundred f32 terms, the LayerNorm's variance among them.
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
# Gradients: f32 sums over every slot of a layer; an element near 0
# carries its terms' rounding.
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Two f32 forms of one sum (the explicit backward, autograd's).
OP_TOL = dict(rtol=1e-5, atol=1e-6)
REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "occ_gnn_tpu_torch" / "csrc" / "gat_attention.cu"
TAIL_SOURCE = REPO / "occ_gnn_tpu_torch" / "csrc" / "unimp_tail.cu"
SPANS = {"unimp_query", "qk_attention_dense", "_QkAttentionBackward",
         "unimp_tail", "_UnimpTailBackward"}


@pytest.fixture(scope="module")
def graph():
    return random_graph(**GRAPH_KW)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


def _state(seed=0) -> dict:
    """Seeded weights with every leaf away from its initial zeros."""
    model = SplitUniMP(GRAPH_KW["feature_dim"], HIDDEN,
                       GRAPH_KW["num_classes"], len(FANOUTS),
                       num_heads=HEADS,
                       generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    return {n: (p.detach() + 0.1 * torch.randn(p.shape, generator=gen))
            for n, p in model.named_parameters()}


def _model(state) -> SplitUniMP:
    model = SplitUniMP(GRAPH_KW["feature_dim"], HIDDEN,
                       GRAPH_KW["num_classes"], len(FANOUTS),
                       num_heads=HEADS)
    model.load_state_dict(state)
    return model


def _frames(g, batch):
    return torch.stack([gather_features(g.features, nodes, "cpu")
                        for nodes in batch.input_nodes_host])


def _refs(layers):
    """The reference's ``(self_ref, slot_ref)`` of one partition's layers:
    rows of the frame at the first layer, of the layer below's valid rows
    above it."""
    out, prev = [], None
    for lyr in layers:
        valid = lyr.owned_mask.bool()
        self_ref = lyr.self_idx[valid].long()
        slot = lyr.nbr_idx[:, lyr.owned_idx[valid].long()].t().long()
        slot = torch.where(slot == lyr.src_cap - 1, -1, slot)
        if prev is not None:
            self_ref = prev[self_ref]
            slot = torch.where(slot >= 0, prev[slot.clamp(min=0)], -1)
        out.append((self_ref, slot))
        prev = torch.full((valid.numel(),), -1, dtype=torch.long)
        prev[valid] = torch.arange(int(valid.sum()))
    return out


@pytest.fixture(scope="module")
def batches(graph):
    """One raw sample sliced at P = 1, 2 and 4 (the same seed and rows),
    and the P = 2 and 4 partition maps."""
    maps = {P: partition_graph(graph, P, mode="greedy", attach=False)
            for P in (2, 4)}
    maps[1] = np.zeros(graph.num_nodes, np.int32)
    samplers = {P: SplitSampler(graph, graph.train_nodes(), maps[P], P,
                                FANOUTS, BATCH, seed=SEED, scatter_plans=True,
                                device="cpu") for P in (1, 2, 4)}
    raw = samplers[4]._sample_raw(graph.train_nodes()[:BATCH])
    return raw, maps, {P: s.slice_raw(raw) for P, s in samplers.items()}


@pytest.fixture(scope="module")
def one_partition(graph, batches):
    """P = 1: the logits, loss and gradients of one step with lr 0."""
    _, _, b = batches
    model = _model(_state())
    logits = make_split_forward(model)(b[1], _frames(graph, b[1]))[0]
    loss, _, count = make_split_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.0))(
            b[1], _frames(graph, b[1]))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return logits, float(loss), int(count), grads


# -- the query-key attention op ----------------------------------------------


def _case(S=40, K=5, D=14, H=6, heads=2, dtype=torch.float32, seed=0):
    """A frame with its zero row, ``nbr`` with 30 % padding slots, a source
    twice in a column and the last column all padding, and ``u``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(S, H, generator=gen, dtype=dtype)
    x[S - 1] = 0
    nbr = torch.randint(0, S - 1, (K, D), generator=gen, dtype=torch.int32)
    nbr[torch.rand(K, D, generator=gen) < 0.3] = S - 1
    nbr[1, ::3] = nbr[0, ::3]
    nbr[:, -1] = S - 1
    u = 0.5 * torch.randn(D, heads, H, generator=gen, dtype=dtype)
    return x, nbr, u


def test_qk_attention_gradients_pass_an_f64_check():
    """The op's explicit backward (the plain path's, which the kernels
    compute) against finite differences, of the softmax's normalised
    sums ``agg / s``, which the max's shift leaves alone, at the columns
    with a valid slot."""
    x, nbr, u = _case(dtype=torch.float64)
    cols = (nbr != x.shape[0] - 1).any(dim=0)

    def ratio(x, u):
        _, s, agg = ga._QkAttention.apply(x, nbr, u, None)
        return agg[cols] / s[cols][..., None]

    assert torch.autograd.gradcheck(
        ratio, (x.requires_grad_(), u.requires_grad_()))


def test_qk_attention_backward_is_autograd_of_the_plain_chain():
    x, nbr, u = _case()
    wv = 0.3 * torch.randn(x.shape[1], u.shape[1], 3)
    gen = torch.Generator().manual_seed(5)
    cot = (torch.randn(nbr.shape[1], u.shape[1], generator=gen),
           torch.randn(nbr.shape[1], u.shape[1], 3, generator=gen))
    leaves = [t.clone().requires_grad_() for t in (x, u, wv)]
    m, s, v = ga.qk_attention(leaves[0], nbr, *leaves[1:])
    assert s.grad_fn.name() == "_QkAttentionBackward"
    got = torch.autograd.grad((s, v), leaves, cot)
    want_out = ga.qk_attention_reference(leaves[0], nbr, *leaves[1:])
    want = torch.autograd.grad(want_out[1:], leaves, cot)
    torch.testing.assert_close(m, want_out[0])
    assert torch.isneginf(m[-1]).all() and (s[-1] == 0).all()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **OP_TOL)


def test_cpu_path_launches_no_kernel():
    before = ga.qk_attention_counts()
    x, nbr, u = _case()
    ga.qk_attn_fwd(x, nbr, u)
    m = ga.qk_attn_fwd(x, nbr, u)[0]
    ga.qk_attn_bwd(x, nbr, u, m, torch.ones_like(m),
                   torch.ones(*u.shape), True)
    assert ga.qk_attention_counts() == before
    assert set(before) == {"fwd_staged", "fwd_any", "bwd_staged", "bwd_any"}


def test_op_refuses_what_the_kernels_do_not_take():
    x, nbr, u = _case()
    wv = torch.zeros(x.shape[1], u.shape[1], 3)
    for args in ((x.double(), nbr, u, wv), (x, nbr.long(), u, wv),
                 (x, nbr, u[:-1], wv), (x, nbr, u, wv[:, :1])):
        with pytest.raises(TypeError):
            ga.qk_attention(*args)


# -- the layer tail ------------------------------------------------------------


def _tail_inputs(last, gen, D=12, O=10, n_own=7, heads=2, dh=3):
    """``v`` head-major, ``s`` with a zero sum (row 1, head 0), owned rows
    with pads, the skip and the weights."""
    width = dh if last else heads * dh
    v = torch.randn(heads, D, dh, generator=gen).permute(1, 0, 2)
    s = torch.rand(D, heads, generator=gen) * 3 + 0.1
    s[1, 0] = 0.0
    idx = torch.full((O,), -1, dtype=torch.int32)
    idx[:n_own] = torch.arange(n_own, dtype=torch.int32)
    r = torch.randn(O, width, generator=gen)
    b_v = torch.randn(heads * dh, generator=gen)
    w_beta = torch.randn(3 * width, 1, generator=gen)
    ln = ([] if last else [0.3 * torch.randn(width, generator=gen),
                           torch.randn(width, generator=gen)])
    return v, s, r, b_v, w_beta, idx, idx >= 0, ln


@pytest.mark.parametrize("last", [False, True], ids=["hidden", "last"])
def test_tail_backward_is_autograd_of_the_chain(last):
    gen = torch.Generator().manual_seed(3)
    v, s, r, b_v, w_beta, idx, mask, ln = _tail_inputs(last, gen)
    leaves = [t.clone().requires_grad_() for t in (v, s, r, b_v, w_beta,
                                                   *ln)]
    y = ut.unimp_tail(*leaves[:5], mask, *leaves[5:])
    assert y.grad_fn.name() == "_UnimpTailBackward"
    want = ut.unimp_tail_reference(*leaves[:5], idx, mask, *leaves[5:])
    torch.testing.assert_close(y, want, **OP_TOL)
    assert (y[~mask] == 0).all()
    dy = torch.randn(y.shape, generator=gen)
    got = torch.autograd.grad(y, leaves, dy)
    ref = torch.autograd.grad(want, leaves, dy)
    for g, w in zip(got, ref):
        torch.testing.assert_close(g, w, **OP_TOL)
    assert got[1][1, 0] == 0 and (got[0][idx.numel():] == 0).all()


@pytest.mark.parametrize("last", [False, True], ids=["hidden", "last"])
def test_tail_gradients_pass_an_f64_check(last):
    gen = torch.Generator().manual_seed(4)
    v, s, r, b_v, w_beta, idx, mask, ln = _tail_inputs(last, gen)
    s[1, 0] = 1.0  # away from the clamp's kink
    leaves = [t.double().requires_grad_()
              for t in (v, s, r, b_v, w_beta, *ln)]
    assert torch.autograd.gradcheck(
        lambda *t: ut.unimp_tail(*t[:5], mask, *t[5:]), leaves)


# -- SplitUniMP against the reference -----------------------------------------


def test_one_partition_matches_the_reference(graph, batches, one_partition):
    """Logits, loss and every leaf's gradient at P = 1 against the plain
    reference in f64 over the batch's own slots."""
    _, _, b = batches
    logits, loss, count, grads = one_partition
    layers = [lyr.partition(0) for lyr in b[1].layers]
    valid = layers[-1].owned_mask
    assert (logits[~valid] == 0).all()
    state = {n: t.double().requires_grad_() for n, t in _state().items()}
    x0 = _frames(graph, b[1])[0].double()
    want = reference.forward(state, _refs(layers), x0, HEADS)
    np.testing.assert_allclose(logits[valid].numpy(), want.detach().numpy(),
                               **LOGIT_TOL)
    ref_loss = F.cross_entropy(want, b[1].labels[0][valid].long())
    assert count == int(valid.sum())
    np.testing.assert_allclose(loss, float(ref_loss.detach()), rtol=1e-6)
    ref_loss.backward()
    assert set(grads) == set(state)
    for name, g in grads.items():
        assert g.abs().max() > 0, name
        np.testing.assert_allclose(g.numpy(), state[name].grad.numpy(),
                                   err_msg=name, **GRAD_TOL)


def _rows(raw, pmap, r):
    return np.nonzero(pmap[raw[0].frontier] == r)[0]


def test_two_partitions_in_one_process_match_one(graph, batches,
                                                 one_partition):
    raw, maps, b = batches
    logits1, loss1, count1, grads1 = one_partition
    model = _model(_state())
    logits = make_split_forward(model)(b[2], _frames(graph, b[2]))
    loss, _, count = make_split_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.0))(
            b[2], _frames(graph, b[2]))
    for r in range(2):
        rows = _rows(raw, maps[2], r)
        assert rows.size > 0
        np.testing.assert_allclose(logits[r, :rows.size].numpy(),
                                   logits1[rows].numpy(), **LOGIT_TOL)
    assert int(count) == count1
    np.testing.assert_allclose(float(loss), loss1, **GRAD_TOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads1[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_four_gloo_ranks_match_one_partition(batches, one_partition):
    """Each rank's logits at its targets, and the global loss and the
    all-reduced gradients, against P = 1; each layer runs a reverse
    shuffle and a merge forward and backward."""
    raw, maps, _ = batches
    logits1, loss1, count1, grads1 = one_partition
    setup = dict(graph=GRAPH_KW, pmap=maps[4], fanouts=FANOUTS, batch=BATCH,
                 seed=SEED, hidden=HIDDEN, heads=HEADS)
    state = {n: t.numpy() for n, t in _state().items()}
    out = run_ranks(split_rank, 4, setup, "unimp", state)
    for r in range(4):
        got = out[r]
        rows = _rows(raw, maps[4], r)
        np.testing.assert_allclose(got["logits"][:rows.size],
                                   logits1[rows].numpy(), **LOGIT_TOL)
        assert got["count"] == count1
        np.testing.assert_allclose(got["loss"], loss1, **GRAD_TOL)
        for name, g in grads1.items():
            np.testing.assert_allclose(got["grads"][name], g.numpy(),
                                       err_msg=name, **GRAD_TOL)
        assert got["shuffles"]["forward"] == 2 * len(FANOUTS)
        assert got["shuffles"]["backward"] == 2 * len(FANOUTS)


def test_the_two_references_agree(graph, batches):
    _, _, b = batches
    layers = [lyr.partition(0) for lyr in b[1].layers]
    state = {n: t.double() for n, t in _state().items()}
    x0 = _frames(graph, b[1])[0].double()
    refs = _refs(layers)
    cfg = {"heads": HEADS, "layer_norm_eps": reference.LN_EPS}
    want = reference.forward(state, refs, x0, HEADS)
    got = bench_reference.forward(state, Refs(layers=refs, targets=None), x0,
                                  cfg)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_reference_imports_nothing_but_torch():
    tree = ast.parse(Path(reference.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "torch"}


# -- the CLI, the plan, the spans ----------------------------------------------


CLI = ["--graph", "community", "--model-name", "unimp", "--num-heads", "2",
       "--fan-out", "5,5", "--batch-size", "256", "--num-nodes", "3000",
       "--num-epochs", "2", "--cpu"]


def test_cli_split_unimp_converges():
    """The split CLI's UniMP on the 3000-node community graph at P = 1:
    SplitGAT reaches 0.97 on this command (tests/test_torch_split_gat.py);
    UniMP read 0.98 when written."""
    m = train.main(CLI + ["--mode", "split", "--cache-per", "auto",
                          "--cpu-devices", "1"])
    assert m["steps"] == 20 and m["innermost"] == "device"
    assert m["acc"] >= 0.95, m


@pytest.mark.parametrize("mode", ["single", "pa-cache", "ddp", "quiver",
                                  "infer"])
def test_cli_refuses_unimp_outside_split(mode):
    with pytest.raises(SystemExit, match="--mode split"):
        train.main(CLI + ["--mode", mode])


# (K, D, H) of unimp-split-b4096's layers 0-2 (4 heads), as its traced
# runs count them: layer 0 takes the staged kernels both ways.
CELL = [(26, 495_616, 100), (11, 90_112, 512), (11, 8_192, 512)]
SMS = 132


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("K,D,H", CELL)
def test_plan_fits_and_stages_the_cells_first_layer(K, D, H, backward):
    plan = ga.attention_plan(K, H, 4, 4, D, SMS, backward, 16, qk=True)
    if (K, D, H) == CELL[0]:
        assert plan.layout is not None
    if plan.layout is None:
        assert plan.tile == ga.ANY_WARPS
        return
    lay = plan.layout
    assert lay == ga.layout(K, H, 4, 4, plan.tile, backward, 16, qk=True)
    assert plan.per_sm * (lay.total + ga.SMEM_RESERVED) <= ga.SMEM_SM
    assert plan.warps_an_sm >= ga.MIN_STAGED_WARPS[backward]
    # No block-level weights; each warp's u ring after its rows, dagg's
    # after it (backward), then ids, scores, weights and barriers.
    assert lay.warp == 0 and lay.wl32 == 0
    sizes = [("rows", lay.stages * K * lay.stride),
             ("u", lay.stages * lay.dstage),
             ("dagg", lay.stages * lay.dstage if backward else 0),
             ("ids", 4 * (lay.stages + 1) * K), ("z", 4 * K * 4),
             ("pw", 4 * K * 4 if backward else 0), ("bar", 8 * lay.stages)]
    end = 0
    for name, size in sizes:
        at = getattr(lay, name)
        assert at % 16 == 0 and at >= end, name
        end = at + size
    assert end <= lay.per_warp and lay.dwl == lay.bar
    assert lay.dstage >= 4 * 4 * H


def test_gat_layouts_keep_their_offsets():
    """GAT's staged layout is the one before the u ring: ``u`` sits where
    ``dagg`` starts, and takes no bytes."""
    for backward in (False, True):
        lay = ga.layout(26, 100, 4, 4, 3, backward)
        assert lay.u == lay.dagg == ga._a16(lay.stages * 26 * lay.stride)


def test_kernel_names_keep_the_two_families_apart():
    """The qk kernels' names hold ``qk_attn_fwd`` or ``qk_attn_bwd``, which
    ``qk_attention_roofline`` times, and neither of the substrings that
    ``gat_attention_roofline`` times; the tail's kernels
    (``csrc/unimp_tail.cu``) hold none of the four."""
    pattern = r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\("
    kernels = re.findall(pattern, SOURCE.read_text())
    qk = [k for k in kernels if k.startswith("qk_")]
    assert sorted(qk) == ["qk_attn_bwd_any", "qk_attn_bwd_kernel",
                          "qk_attn_fwd_any", "qk_attn_fwd_kernel"]
    needles = qk_attention_roofline.NEEDLES
    for k in kernels:
        assert any(n in k for n in needles) == (k in qk), k
        if k in qk:
            assert "attention_fwd" not in k and "attention_bwd" not in k
    tail = re.findall(pattern, TAIL_SOURCE.read_text())
    assert sorted(tail) == ["unimp_tail_bwd_kernel", "unimp_tail_fwd_kernel",
                            "unimp_tail_sum_kernel"]
    for k in tail:
        assert not any(n in k for n in (*needles, "attention_fwd",
                                         "attention_bwd")), k


def test_named_ranges_list_the_spans():
    assert SPANS <= set(NAMED_RANGES)


# -- on the card ---------------------------------------------------------------


def _card_case(K, D, S, H, heads, device, seed=0):
    """Random rows (the zero row last), ``nbr`` with 30 % padding slots and
    every 97th column all padding, ``u`` head-major (as the model's einsum
    gives it) scaled to O(1) scores, ``m``'s cotangents."""
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(S, H, generator=gen, device=device)
    x[S - 1] = 0
    nbr = torch.randint(0, S - 1, (K, D), generator=gen, device=device,
                        dtype=torch.int32)
    nbr[torch.rand(K, D, generator=gen, device=device) < 0.3] = S - 1
    nbr[:, ::97] = S - 1
    u = (torch.randn(heads, D, H, generator=gen, device=device)
         / H ** 0.5).permute(1, 0, 2)
    ds = torch.randn(D, heads, generator=gen, device=device)
    dagg = torch.randn(D, heads, H, generator=gen, device=device)
    return x, nbr, u, ds, dagg


def _close(got, want, label):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * scale, (label, err, scale)


# (K, D, S, H, heads): small ragged rows, split GAT A's layer 0 and 1
# (4 x 32), and unimp-split-b4096's layers 0 and 1.
CARD_SHAPES = {"ragged": (5, 3_001, 4_000, 12, 3),
               "gat_a_layer0": (26, 123_904, 2_450_001, 100, 4),
               "gat_a_layer1": (11, 22_528, 123_904, 128, 4),
               "cell_layer0": (26, 495_616, 2_449_030, 100, 4),
               "cell_layer1": (11, 90_112, 495_616, 512, 4)}


@pytest.mark.card
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernels_match_the_plain_version(card, shape):
    K, D, S, H, heads = CARD_SHAPES[shape]
    x, nbr, u, ds, dagg = _card_case(K, D, S, H, heads, card)
    grad_x = shape not in ("gat_a_layer0", "cell_layer0")
    before = ga.qk_attention_counts()
    outs = [ga.qk_attn_fwd(x, nbr, u) for _ in range(2)]
    with torch.no_grad():
        want = ga._qk_partials_reference(x, nbr, u)
    torch.cuda.synchronize(card)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    m, s, agg = outs[0]
    assert torch.equal(torch.isneginf(m), torch.isneginf(want[0]))
    for name, g, w in zip("msa", outs[0], want):
        fin = torch.isfinite(w)
        _close(g[fin], w[fin], f"{shape} {name}")
    del want
    bwds = [ga.qk_attn_bwd(x, nbr, u, m, ds, dagg, grad_x)
            for _ in range(2)]
    ref = ga.qk_attention_backward_reference(x, nbr, u, m, ds, dagg, grad_x)
    torch.cuda.synchronize(card)
    assert torch.equal(bwds[0][1], bwds[1][1])
    assert bwds[0][1].stride() == u.stride()
    _close(bwds[0][1], ref[1], f"{shape} du")
    if grad_x:
        at = (nbr != S - 1).reshape(-1)
        assert torch.equal(bwds[0][0][at], bwds[1][0][at])
        _close(bwds[0][0][at], ref[0][at], f"{shape} dxg")
    after = ga.qk_attention_counts()
    launched = {k: after[k] - before[k] for k in after}
    assert launched["fwd_staged"] + launched["fwd_any"] == 2
    assert launched["bwd_staged"] + launched["bwd_any"] == 2
    if shape == "cell_layer0":
        assert launched["fwd_staged"] == launched["bwd_staged"] == 2


@pytest.mark.card
def test_a_split_unimp_step_launches_the_kernels(card, graph):
    """A step at P = 1 launches the forward and the backward kernel once
    a layer, under the spans ``qk_attention_dense`` and
    ``_QkAttentionBackward``, and its losses stay finite."""
    from torch.profiler import ProfilerActivity, profile

    fanouts = [3, 3, 3]
    pmap = np.zeros(graph.num_nodes, np.int32)
    plan = CachePlan(graph, pmap, 1, 1.0, refresh_cap=8)
    sampler = NativeSplitSampler(graph, graph.train_nodes(), pmap, 1,
                                 fanouts, BATCH, seed=3, cache=plan,
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
        losses = [float(step(next(batches), frames,
                             sample_generator=gen)[0])]
        before = ga.qk_attention_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            losses.append(float(step(next(batches), frames,
                                     sample_generator=gen)[0]))
            torch.cuda.synchronize(card)
        after = ga.qk_attention_counts()
        for _ in range(8):
            losses.append(float(step(next(batches), frames,
                                     sample_generator=gen)[0]))
    finally:
        sampler.close()
    launched = {k: after[k] - before[k] for k in after}
    assert launched["fwd_staged"] + launched["fwd_any"] == 3
    assert launched["bwd_staged"] + launched["bwd_any"] == 3
    under = {"qk_attention_dense": 0, "_QkAttentionBackward": 0}
    for e in prof.events():
        kernels = [k.name for k in getattr(e, "kernels", [])]
        p = e
        while p is not None and kernels:
            if p.name in under:
                under[p.name] += sum("qk_attn_" in k for k in kernels)
                break
            p = p.cpu_parent
    assert under == {"qk_attention_dense": 3, "_QkAttentionBackward": 3}
    assert np.isfinite(losses).all()
