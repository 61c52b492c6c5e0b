"""The on-device samplers (``ops/device_sample.py``): split A's innermost
synthesis, quiver's draws and quiver's layer-0 gather-mean.

Their plain versions take the random numbers as an input, so here they
are fed JAX's own draws (the ``jax.random.randint`` calls of the JAX
functions, made again with the same keys) and must give JAX's outputs
bit for bit at every degree; the mean within a stated tolerance of JAX's.
The callers keep their bits: for a torch generator seed the refactored
paths give what an inline copy of the code before the kernels gave. On
CPU tensors every wrapper runs its plain version and counts no launch.
The kernels themselves run only on the card (``chip_smoke.py``'s
``device_sample_cases``).
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occ_gnn_tpu.ops import config as jax_config
from occ_gnn_tpu.parallel import split as jax_split
from occ_gnn_tpu.sampling import device_sampler as jds
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.data.graph import Graph
from occ_gnn_tpu_torch.models import SAGEModel
from occ_gnn_tpu_torch.ops import build
from occ_gnn_tpu_torch.ops import device_sample as ds
from occ_gnn_tpu_torch.parallel.model import make_device_csr
from occ_gnn_tpu_torch.parallel.split import (
    SplitLayer,
    synthesize_device_innermost,
)
from occ_gnn_tpu_torch.sampling.device_sampler import (
    DeviceSampleTrainer,
    dense_frontiers,
    dense_sage_forward,
    sample_neighbors_dense,
)
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
from occ_gnn_tpu_torch.cache import CachePlan

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "occ_gnn_tpu_torch" / "csrc" / "device_sample.cu"
K = 4
FIELDS = ("nbr", "owned_idx", "owned_deg", "self_idx", "owned_mask",
          "num_owned")
# gather_mean's plain version against JAX's first-layer inputs, of the
# inputs' scale: f32 sums of the same rows in the same order, so rounding
# only; on a bf16 table within one bf16 step.
MEAN_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-8}


def _csr(degrees, num_nodes, seed):
    """An int32 CSR with the given in-degrees, neighbours uniform."""
    rng = np.random.default_rng(seed)
    indptr = np.zeros(len(degrees) + 1, np.int64)
    indptr[1:] = np.cumsum(degrees)
    indices = rng.integers(0, num_nodes, indptr[-1]).astype(np.int32)
    return indptr.astype(np.int32), indices


@pytest.fixture(scope="module")
def degree_graph():
    """64 nodes whose in-degrees are 0, 1, K, K + 1, 3K and 40, each
    many times over."""
    rng = np.random.default_rng(0)
    degrees = rng.choice([0, 1, K, K + 1, 3 * K, 40], 64)
    return _csr(degrees, 64, 1)


def _frames(parts, D, seed):
    """``parts`` dst frames of D columns, global ids of the 64-node graph
    in rank order, each padded at its end with -1 (a different count of
    pads a frame, one frame full)."""
    rng = np.random.default_rng(seed)
    out = np.full((parts, D), -1, np.int32)
    for p in range(parts):
        fill = D if p == 0 else int(rng.integers(1, D))
        out[p, :fill] = rng.choice(64, fill, replace=False)
    return out


def _jax_draws(key, dg, indptr, D):
    """The draws of JAX's randint lowering (``occ_gnn_tpu/parallel/
    split.py:230-235,261-264``) for ``key``."""
    dg = jnp.asarray(dg)
    valid = dg >= 0
    g = jnp.maximum(dg, 0)
    ip = jnp.asarray(indptr)
    deg = jnp.where(valid, ip[g + 1] - ip[g], 0)
    return np.array(jax.random.randint(
        key, (K, D), 0, jnp.maximum(deg, 1)[None, :], dtype=jnp.int32))


@pytest.fixture
def jax_randint():
    old = jax_config.device_sample_impl()
    jax_config.set_device_sample_impl("randint")
    yield
    jax_config.set_device_sample_impl(old)


@pytest.mark.parametrize("parts, D, out_cap", [(1, 48, 48), (1, 48, 40),
                                                (4, 24, 24)])
def test_synthesis_equals_jax_on_jax_draws(degree_graph, jax_randint, parts,
                                           D, out_cap):
    indptr, indices = degree_graph
    src_cap = 65
    frames = _frames(parts, D, seed=parts + out_cap)
    degs = set()
    for p in range(parts):
        key = jax.random.fold_in(jax.random.PRNGKey(3), p)
        dg = frames[p]
        lyr = jax_split.SplitLayer(dst_global=jnp.asarray(dg),
                                   src_cap=src_cap, dst_cap=D,
                                   out_cap=out_cap, fanout=K)
        want = jax_split.synthesize_device_innermost(
            lyr, jnp.asarray(indptr), jnp.asarray(indices), key)
        draws = torch.from_numpy(_jax_draws(key, dg, indptr, D)).long()
        got = ds.synthesize_innermost(
            torch.from_numpy(dg), torch.from_numpy(indptr),
            torch.from_numpy(indices), draws, K, src_cap, out_cap)
        for name in FIELDS:
            a = getattr(got, name).numpy()
            b = np.asarray(getattr(want, "nbr_idx" if name == "nbr"
                                   else name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        valid = dg >= 0
        degs |= set(np.diff(indptr)[dg[valid]].tolist())
    # Degrees 0, 1, K and far above K all met in the frames.
    assert {0, 1, K, 40} <= degs


def test_synthesis_draws_reduced_modulo_degree(degree_graph):
    """Draws past the degree are reduced modulo it: 62-bit draws and the
    same draws taken modulo each degree give the same layer."""
    indptr, indices = degree_graph
    dg = torch.from_numpy(_frames(1, 48, 5)[0])
    gen = torch.Generator().manual_seed(2)
    big = torch.randint(0, 2**62, (K, 48), generator=gen)
    deg = torch.from_numpy(np.diff(indptr))[dg.clamp(min=0).long()]
    small = big % deg.clamp(min=1).long()[None, :]
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    a = ds.synthesize_innermost(dg, ip, ix, big, K, 65, 48)
    b = ds.synthesize_innermost(dg, ip, ix, small, K, 65, 48)
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _zero_degree_csr():
    # Nodes 0-3 isolated, node 3's indptr entry one past the last edge;
    # the others of degree 1 to 9.
    degrees = [0, 0, 0, 0] + [1 + i % 9 for i in range(36)]
    return _csr(degrees, 40, 7)


def test_draws_equal_jax_on_jax_draws():
    indptr, indices = _zero_degree_csr()
    jcsr = jds.DeviceCSR(indptr=jnp.asarray(indptr),
                         indices=jnp.asarray(indices))
    targets = np.array([0, 3, 5, 17, 39, 3, 21], np.int32)
    fanouts = [3, 2, 5]
    key = jax.random.PRNGKey(11)
    want = jds.dense_frontiers(jcsr, jnp.asarray(targets), fanouts, key)
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    frontier = torch.from_numpy(targets)
    for layer, fanout in enumerate(fanouts):
        n = frontier.shape[0]
        sub = jax.random.fold_in(key, layer)
        # sample_neighbors_dense's draws (device_sampler.py:80-82).
        r = np.asarray(jax.random.randint(sub, (n, fanout), 0,
                                          jnp.iinfo(jnp.int32).max))
        nbr = jds.sample_neighbors_dense(jcsr, jnp.asarray(frontier.numpy()),
                                         fanout, sub)
        frontier = ds.draw_neighbors(frontier, ip, ix,
                                     torch.from_numpy(r.astype(np.int32)))
        assert frontier.dtype == torch.int32
        np.testing.assert_array_equal(
            frontier.numpy(),
            np.concatenate([np.asarray(want[layer]),
                            np.asarray(nbr).reshape(-1)]))
        np.testing.assert_array_equal(frontier.numpy(),
                                      np.asarray(want[layer + 1]))
    # The zero-degree targets drew themselves.
    n0 = targets.shape[0]
    drawn = want[1][n0:].reshape(n0, fanouts[0])
    assert (np.asarray(drawn)[:2] == targets[:2, None]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [100, 37])
def test_gather_mean_matches_jax(dtype, h):
    rng = np.random.default_rng(h)
    N, n, fanout = 300, 40, 5
    feats = rng.standard_normal((N, h)).astype(np.float32)
    frontier = rng.integers(0, N, n * (1 + fanout)).astype(np.int32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    # JAX: features[frontiers[-1]], then the first layer's lines of
    # dense_sage_forward (device_sampler.py:139-141).
    x = jnp.asarray(feats).astype(jdtype)[jnp.asarray(frontier)]
    j_self = x[:n].astype(jnp.float32)
    j_nbr = x[n:].reshape(n, fanout, -1).astype(jnp.float32)
    j_mean = (j_self + j_nbr.sum(axis=1)) / (fanout + 1.0)
    x_self, mean = ds.gather_mean(torch.from_numpy(feats).to(dtype),
                                  torch.from_numpy(frontier), n, fanout)
    assert x_self.dtype == mean.dtype == torch.float32
    assert x_self.shape == mean.shape == (n, h)
    np.testing.assert_array_equal(x_self.numpy(), np.asarray(j_self))
    scale = max(1.0, float(np.abs(np.asarray(j_mean)).max()))
    err = float(np.abs(mean.numpy() - np.asarray(j_mean)).max())
    assert err <= MEAN_TOL[dtype] * scale


def test_wrappers_on_cpu_run_the_plain_versions_and_count_no_launch(
        degree_graph):
    indptr, indices = degree_graph
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    gen = torch.Generator().manual_seed(4)
    entries = (ds.synthesize_innermost, ds.draw_neighbors, ds.gather_mean)
    for fn in entries:
        fn.launches = 0
    dg = torch.from_numpy(_frames(1, 48, 6)[0])
    draws = torch.randint(0, 2**62, (K, 48), generator=gen)
    got = ds.synthesize_innermost(dg, ip, ix, draws, K, 65, 40)
    want = ds.synthesize_innermost_reference(dg, ip, ix, draws, K, 65, 40)
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    frontier = torch.arange(10, dtype=torch.int32)
    r = torch.randint(0, 2**31 - 1, (10, 3), generator=gen,
                      dtype=torch.int32)
    nxt = ds.draw_neighbors(frontier, ip, ix, r)
    assert torch.equal(nxt, ds.draw_neighbors_reference(frontier, ip, ix, r))
    feats = torch.randn(64, 8, generator=gen)
    a = ds.gather_mean(feats, nxt, 10, 3)
    b = ds.gather_mean_reference(feats, nxt, 10, 3)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert [fn.launches for fn in entries] == [0, 0, 0]
    # The launchers take CUDA tensors only.
    with pytest.raises(ValueError, match="CUDA"):
        ds._launch_draw(frontier, ip, ix, r)


def test_wrappers_check_their_inputs(degree_graph):
    indptr, indices = degree_graph
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    dg = torch.from_numpy(_frames(1, 8, 8)[0])
    draws = torch.zeros(K, 8, dtype=torch.int64)
    with pytest.raises(TypeError, match="draws"):
        ds.synthesize_innermost(dg, ip, ix, draws.int(), K, 65, 8)
    with pytest.raises(TypeError, match="draws"):
        ds.synthesize_innermost(dg, ip, ix, draws[:, :4], K, 65, 8)
    with pytest.raises(ValueError, match="out_cap"):
        ds.synthesize_innermost(dg, ip, ix, draws, K, 65, 9)
    with pytest.raises(TypeError, match="indices"):
        ds.synthesize_innermost(dg, ip, ix.long(), draws, K, 65, 8)
    with pytest.raises(TypeError, match="dst_global"):
        ds.synthesize_innermost(dg.long(), ip, ix, draws, K, 65, 8)
    frontier = torch.arange(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="r must"):
        ds.draw_neighbors(frontier, ip, ix, torch.zeros(4, 2,
                                                       dtype=torch.int64))
    with pytest.raises(TypeError, match="r must"):
        ds.draw_neighbors(frontier, ip, ix, torch.zeros(3, 2,
                                                       dtype=torch.int32))
    feats = torch.randn(64, 8)
    f = torch.zeros(4 * 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="self rows"):
        ds.gather_mean(feats, f, 4, 3)
    with pytest.raises(TypeError, match="features"):
        ds.gather_mean(feats.double(), f, 4, 2)


# The code before the kernels, copied inline: its bits for a seed.

def _old_synthesize(lyr, indptr, indices, generator):
    dg = lyr.dst_global
    K_ = lyr.fanout
    D = dg.shape[0]
    valid = dg >= 0
    g = dg.clamp(min=0)
    off = indptr.index_select(0, g)
    deg = torch.where(valid, indptr.index_select(0, g + 1) - off, 0)
    take = deg.clamp(max=K_)
    kr = torch.arange(K_, device=dg.device)[:, None]
    draws = (torch.randint(0, 2**62, (K_, D), generator=generator,
                           device=dg.device)
             % deg.clamp(min=1)[None, :])
    sel = torch.where(deg[None, :] > K_, draws, kr)
    last = indices.shape[0] - 1
    src = indices[(off[None, :] + sel).clamp_(max=last)]
    zero_row = lyr.src_cap - 1
    nbr_main = torch.where(kr < take[None, :], src, zero_row)
    self_rows = torch.where(valid, g, zero_row).to(torch.int32)
    nbr = torch.cat([self_rows[None, :], nbr_main.to(torch.int32)], dim=0)
    O = lyr.out_cap
    v = valid[:O]
    ar = torch.arange(O, dtype=torch.int32, device=g.device)
    return dict(owned_idx=torch.where(v, ar, -1),
                owned_deg=torch.where(v, (take[:O] + 1).float(), 1.0),
                self_idx=torch.where(v, g[:O], 0).to(torch.int32),
                owned_mask=v, num_owned=valid.sum().to(torch.int32),
                nbr_idx=nbr)


def _old_sample_neighbors_dense(csr, frontier, fanout, generator):
    indptr, indices = csr
    n = frontier.shape[0]
    if indices.numel() == 0:
        return frontier[:, None].expand(n, fanout).contiguous()
    f = frontier.long()
    start = indptr[f].long()
    deg = indptr[f + 1].long() - start
    r = torch.randint(0, 2**31 - 1, (n, fanout), generator=generator,
                      device=frontier.device)
    pos = start[:, None] + r % deg.clamp(min=1)[:, None]
    nbr = indices[pos.clamp(max=indices.numel() - 1)]
    return torch.where(deg[:, None] > 0, nbr, frontier[:, None])


def _old_dense_frontiers(csr, targets, fanouts, generator):
    frontier = targets
    out = [frontier]
    for fanout in fanouts:
        nbr = _old_sample_neighbors_dense(csr, frontier, fanout, generator)
        frontier = torch.cat([frontier, nbr.reshape(-1)])
        out.append(frontier)
    return out


@pytest.mark.parametrize("parts", [1, 4])
def test_synthesis_keeps_its_bits_for_a_seed(parts):
    g = random_graph(num_nodes=500, avg_degree=6, feature_dim=16,
                     num_classes=5, seed=1)
    pmap = (np.arange(g.num_nodes) % parts).astype(np.int32)
    fanouts = [3, 3]
    plan = CachePlan(g, pmap, parts, 1.0, refresh_cap=8)
    sampler = NativeSplitSampler(g, g.train_nodes(), pmap, parts, fanouts, 32,
                                 seed=3, cache=plan, num_workers=1,
                                 innermost="device", device="cpu")
    batch = sampler.sample_batch(g.train_nodes()[:32])
    sampler.close()
    csr = make_device_csr(g, "cpu")
    l0 = batch.layers[0]
    drawn = 0
    for p in range(parts):
        lyr = l0.partition(p)
        new = synthesize_device_innermost(
            lyr, csr[0], csr[1], torch.Generator().manual_seed(10 + p))
        old = _old_synthesize(lyr, csr[0], csr[1],
                              torch.Generator().manual_seed(10 + p))
        for name, t in old.items():
            assert torch.equal(getattr(new, name), t), name
            assert getattr(new, name).dtype == t.dtype, name
        assert isinstance(new, SplitLayer) and new.fanout == 3
        drawn += int((np.diff(g.indptr)[lyr.dst_global[
            lyr.dst_global >= 0].numpy()] > 3).sum())
    assert drawn > 0  # some columns took draws


@pytest.mark.parametrize("empty", [False, True])
def test_frontiers_keep_their_bits_for_a_seed(empty):
    g = random_graph(num_nodes=300, avg_degree=5, feature_dim=8,
                     num_classes=3, seed=2)
    if empty:
        g = Graph(indptr=np.zeros(g.num_nodes + 1, np.int64),
                  indices=np.zeros(0, np.int64), features=g.features,
                  labels=g.labels, num_classes=g.num_classes)
    csr = make_device_csr(g, "cpu")
    targets = torch.tensor([0, 7, 299, 42, 7], dtype=torch.int32)
    new = dense_frontiers(csr, targets, [4, 3, 2],
                          torch.Generator().manual_seed(5))
    old = _old_dense_frontiers(csr, targets, [4, 3, 2],
                               torch.Generator().manual_seed(5))
    for a, b in zip(new, old):
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a, b)
    nbr = sample_neighbors_dense(csr, targets, 6,
                                 torch.Generator().manual_seed(6))
    assert torch.equal(nbr, _old_sample_neighbors_dense(
        csr, targets, 6, torch.Generator().manual_seed(6)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quiver_forward_keeps_its_bits(dtype):
    """The trainer's forward through ``gather_mean`` and
    ``dense_sage_layers`` gives the logits of the gather of the frame and
    ``dense_sage_forward`` of it, as the forward was written before."""
    g = random_graph(num_nodes=400, avg_degree=6, feature_dim=12,
                     num_classes=4, seed=3)
    fanouts = [3, 2]
    model = SAGEModel(12, 16, 4, 2, generator=torch.Generator().manual_seed(0))
    trainer = DeviceSampleTrainer(g, fanouts, 16, model, None, seed=1,
                                  dtype=dtype, device="cpu")
    model.eval()
    with torch.no_grad():
        frontiers = trainer.sample(torch.arange(16, dtype=torch.int32))
        logits = trainer.forward(frontiers)
        x = trainer.features.index_select(0, frontiers[-1])
        want = dense_sage_forward(model, x, fanouts, dtype=dtype)
    assert torch.equal(logits, want)


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
    bound = dict(ds.ARGTYPES, cuda_error_string=build.ERROR_STRING_ARGTYPES)
    assert set(arities) == set(bound)
    for name, n in arities.items():
        assert len(bound[name]) == n, name
    for argtypes in ds.ARGTYPES.values():
        assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong)
                   for t in argtypes)


def test_kernel_is_built_from_its_source():
    assert "device_sample" in build.KERNELS
    assert build.library_path("device_sample").name.startswith(
        "libdevice_sample-")


def test_module_imports_no_jax_in_a_fresh_process():
    code = ("import sys, occ_gnn_tpu_torch.ops.device_sample, "
            "occ_gnn_tpu_torch.sampling.device_sampler, "
            "occ_gnn_tpu_torch.parallel.split\n"
            "print('jax' in sys.modules, any(k == 'occ_gnn_tpu' or "
            "k.startswith('occ_gnn_tpu.') for k in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False"]


# The fan-out-0 repair: JAX keeps the frontier at a fan-out of 0.

@pytest.mark.parametrize("fanouts", [[2, 0], [0]])
def test_frontiers_at_fanout_zero_equal_jax(fanouts):
    indptr, indices = _zero_degree_csr()
    jcsr = jds.DeviceCSR(indptr=jnp.asarray(indptr),
                         indices=jnp.asarray(indices))
    targets = np.array([0, 5, 17, 39], np.int32)
    key = jax.random.PRNGKey(12)
    want = jds.dense_frontiers(jcsr, jnp.asarray(targets), fanouts, key)
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    ds.draw_neighbors.launches = 0
    # The same layers from JAX's own draws, layer by layer.
    frontier = torch.from_numpy(targets)
    for layer, fanout in enumerate(fanouts):
        n = frontier.shape[0]
        r = np.asarray(jax.random.randint(
            jax.random.fold_in(key, layer), (n, fanout), 0,
            jnp.iinfo(jnp.int32).max))
        frontier = ds.draw_neighbors(frontier, ip, ix,
                                     torch.from_numpy(r.astype(np.int32)))
        np.testing.assert_array_equal(frontier.numpy(),
                                      np.asarray(want[layer + 1]))
    # The port's own frontiers: JAX's shapes, and a layer of fan-out 0
    # repeats the one before it.
    got = dense_frontiers((ip, ix), torch.from_numpy(targets), fanouts,
                          torch.Generator().manual_seed(3))
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(t.dtype == torch.int32 for t in got)
    for layer, fanout in enumerate(fanouts):
        if fanout == 0:
            assert torch.equal(got[layer + 1], got[layer])
    assert ds.draw_neighbors.launches == 0
    nbr = sample_neighbors_dense((ip, ix), torch.from_numpy(targets), 0,
                                 torch.Generator().manual_seed(3))
    want_nbr = jds.sample_neighbors_dense(jcsr, jnp.asarray(targets), 0, key)
    assert tuple(nbr.shape) == want_nbr.shape == (4, 0)
    assert nbr.dtype == torch.int32


def test_draw_neighbors_at_fanout_zero_copies_the_frontier():
    indptr, indices = _zero_degree_csr()
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    frontier = torch.tensor([3, 9, 21], dtype=torch.int32)
    ds.draw_neighbors.launches = 0
    out = ds.draw_neighbors(frontier, ip, ix,
                            torch.zeros(3, 0, dtype=torch.int32))
    assert torch.equal(out, frontier)
    assert out.data_ptr() != frontier.data_ptr()
    assert ds.draw_neighbors.launches == 0


def test_gather_mean_without_neighbours_raises_on_both_routes():
    feats = np.random.default_rng(0).standard_normal((10, 4)).astype(
        np.float32)
    frontier = np.array([1, 4, 7], np.int32)
    # JAX's first layer cannot take a fan-out of 0 either.
    x = jnp.asarray(feats)[jnp.asarray(frontier)]
    with pytest.raises(Exception):
        x[3:].reshape(3, 0, -1)
    with pytest.raises(Exception):
        x[0:].reshape(0, 4, -1)  # nor n = 0
    ds.gather_mean.launches = 0
    for device in ("cpu", "meta"):
        # On meta tensors the check must come before the launcher (which
        # would refuse a tensor off the card with another message).
        t = torch.from_numpy(feats).to(device)
        with pytest.raises(ValueError, match="fan-out 0"):
            ds.gather_mean(t, torch.from_numpy(frontier).to(device), 3, 0)
        with pytest.raises(ValueError, match="n = 0"):
            ds.gather_mean(t, torch.zeros(0, dtype=torch.int32,
                                          device=device), 0, 4)
    assert ds.gather_mean.launches == 0


# num_owned without state across launches.

# The synthesis kernel's tile: a warp's columns.
TILE = int(re.search(r"constexpr int kLanes = (\d+);",
                     SOURCE.read_text()).group(1))


def _kernel_num_owned(valid: np.ndarray) -> int:
    """The synthesis kernel's count, tile by tile as it computes it:
    each tile's first pad, whether the column before the tile is a pad,
    and the one writer; raises where the kernel's assert would fire."""
    D = valid.shape[0]
    written = []
    for d0 in range(0, D, TILE):
        tile = valid[d0:d0 + TILE]
        pads = np.flatnonzero(~tile)
        first = int(pads[0]) if pads.size else TILE
        before = d0 > 0 and not valid[d0 - 1]
        if tile[first:].any() or (before and tile.any()):
            raise AssertionError("valid column after a pad")
        if not before:
            if first < TILE:
                written.append(d0 + first)
            elif d0 + TILE >= D:
                written.append(D)
    assert len(written) == 1, written
    return written[0]


@pytest.mark.parametrize("boundary", ["all valid", "all pad", 0, 255, 256,
                                      257, 600])
def test_num_owned_at_the_frame_boundary(degree_graph, boundary):
    """Frames of D = 600 columns (not a multiple of the tile) whose first
    pad is at ``boundary``: the wrapper's count (the plain version's on
    the CPU), JAX's and the kernel's tile rule all give it."""
    D = 600
    first = {"all valid": D, "all pad": 0}.get(boundary, boundary)
    assert 256 % TILE == 0  # the boundaries 255-257 straddle a tile's edge
    rng = np.random.default_rng(first)
    dg = np.full(D, -1, np.int32)
    dg[:first] = rng.integers(0, 64, first)
    indptr, indices = degree_graph
    draws = torch.zeros(K, D, dtype=torch.int64)
    got = ds.synthesize_innermost(
        torch.from_numpy(dg), torch.from_numpy(indptr),
        torch.from_numpy(indices), draws, K, 65, 300)
    assert int(got.num_owned) == first
    lyr = jax_split.SplitLayer(dst_global=jnp.asarray(dg), src_cap=65,
                               dst_cap=D, out_cap=300, fanout=K)
    want = jax_split.synthesize_device_innermost(
        lyr, jnp.asarray(indptr), jnp.asarray(indices),
        jax.random.PRNGKey(0))
    assert int(want.num_owned) == first
    assert _kernel_num_owned(dg >= 0) == first


@pytest.mark.parametrize("late", [3, 300])
def test_a_valid_column_after_a_pad_raises(degree_graph, late):
    indptr, indices = degree_graph
    dg = np.full(600, -1, np.int32)
    dg[:200] = 5
    dg[late] = -1 if late < 200 else 7
    with pytest.raises(AssertionError):
        _kernel_num_owned(dg >= 0)
    with pytest.raises(ValueError, match="after a pad"):
        ds.synthesize_innermost(
            torch.from_numpy(dg), torch.from_numpy(indptr),
            torch.from_numpy(indices), torch.zeros(K, 600, dtype=torch.int64),
            K, 65, 600)


@pytest.mark.parametrize("parts, emit, packed, plans", [
    (1, None, True, False), (2, None, True, True), (4, None, False, False),
    (4, (1, 3), True, False), (4, (2, 4), False, True)])
def test_native_sampler_frames_are_valid_prefixes(parts, emit, packed,
                                                  plans):
    """Every layer-0 dst frame the C++ service emits on the
    device-innermost path (every partition count, emitted range, arena
    and plan setting that split takes it with) is a valid prefix, the
    form the synthesis counts by."""
    g = random_graph(num_nodes=600, avg_degree=6, feature_dim=8,
                     num_classes=3, seed=4)
    pmap = np.random.default_rng(parts).integers(0, parts, g.num_nodes
                                                 ).astype(np.int32)
    plan = CachePlan(g, pmap, parts, 1.0, refresh_cap=8)
    nodes = g.train_nodes()
    sampler = NativeSplitSampler(g, nodes, pmap, parts, [4, 3], 64, seed=5,
                                 cache=plan, num_workers=1,
                                 innermost="device", emit_range=emit,
                                 packed=packed, scatter_plans=plans,
                                 device="cpu")
    frames = 0
    for chunk in (nodes[:64], nodes[64:128], nodes[-37:]):
        dg = sampler.sample_batch(chunk).layers[0].dst_global
        for p in range(dg.shape[0]):
            valid = dg[p] >= 0
            n = int(valid.sum())
            assert bool(valid[:n].all()), (p, n)
            assert n > 0
            frames += 1
    sampler.close()
    lo, hi = emit or (0, parts)
    assert frames == 3 * (hi - lo)


def test_distinct_rows_equal_unique_per_output():
    rng = np.random.default_rng(9)
    for n, fanout, rows in ((50, 25, 40), (20, 3, 5), (7, 40, 1000),
                            (0, 4, 10)):
        f = torch.from_numpy(rng.integers(0, rows, n * (1 + fanout)).astype(
            np.int32))
        got = ds.distinct_rows(f, n, fanout)
        want = [torch.unique(torch.cat([f[s:s + 1],
                                        f[n + s * fanout:
                                          n + (s + 1) * fanout]])).numel()
                for s in range(n)]
        assert got.tolist() == want


def _straddling_csr():
    # Runs of 0 to 17 words starting at every offset within a 32-byte
    # sector, so many cross one or two sector edges.
    degrees = [3, 5, 8, 1, 7, 9, 16, 0, 2, 13, 17, 6, 0, 11, 4, 8]
    return _csr(degrees, len(degrees), 3)


def _direct_run_bytes(frontier, indptr, distinct):
    nodes = sorted(set(frontier)) if distinct else list(frontier)
    total = 0
    for f in nodes:
        total += 32  # the indptr pair
        sectors = {4 * i // 32 for i in range(indptr[f], indptr[f + 1])}
        total += 32 * len(sectors)
    return total


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("graph", ["zero_degree", "straddling"])
def test_run_sectors_equal_a_direct_count(graph, distinct):
    indptr, _ = (_zero_degree_csr() if graph == "zero_degree"
                 else _straddling_csr())
    rng = np.random.default_rng(4)
    frontier = rng.integers(0, len(indptr) - 1, 200).astype(np.int32)
    frontier[:5] = [0, 3, 7, 7, 7]  # zero-degree nodes, a repeated node
    got = ds.run_sectors(torch.from_numpy(frontier),
                         torch.from_numpy(indptr), distinct=distinct)
    assert got == _direct_run_bytes(frontier.tolist(), indptr.tolist(),
                                    distinct)


def _source_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    return int(m.group(1))


def _umulhi(x, m):
    return (x.astype(np.uint64) * np.asarray(m, np.uint64)) >> np.uint64(32)


def _div32(x, d, m):
    """draw_kernel's div32 on uint64 arrays of 32-bit values."""
    q = _umulhi(x, m)
    return np.where(x - q * d >= d, q + 1, q)


def _mod32(x, d, m):
    """draw_kernel's mod32, ``d`` and ``m`` arrays or scalars."""
    rem = x - _umulhi(x, m) * d
    return np.where(rem >= d, rem - d, rem)


@pytest.mark.parametrize("op", ["div", "mod"])
def test_reciprocal_division_is_exact(op):
    rng = np.random.default_rng(5)
    for d in (1, 2, 3, 7, 10, 25, 33, 41, 100_000, 2**25, 2**31 - 1,
              2**32 - 1):
        m = np.uint64(0xFFFFFFFF // d)
        d64 = np.uint64(d)
        # Around multiples of d, the ends of 32 bits, and at random.
        mults = d64 * np.unique(np.linspace(0, (2**32 - 1) // d, 4000)
                                .astype(np.uint64))
        x = np.concatenate([mults, mults + 1, mults - 1, mults + d64 - 1,
                            np.arange(0, 3000, dtype=np.uint64),
                            np.array([2**31 - 1, 2**31, 2**32 - 1],
                                     np.uint64),
                            rng.integers(0, 2**32, 20000, dtype=np.uint64)])
        x = x[x < 2**32]
        if op == "div":
            np.testing.assert_array_equal(_div32(x, d64, m), x // d64)
        else:
            np.testing.assert_array_equal(_mod32(x, d64, m), x % d64)


def _kernel_draws(frontier, indptr, indices, r):
    """draw_kernel's indexing in numpy: a warp a tile of kDrawTile entries
    and a stage of min(kDrawTile K, kDrawStage) words, the tile's words a
    stage at a time, a word's node by div32 of its tile-local index, its
    draw by mod32 of the staged draw."""
    n, k = r.shape
    rows = _source_constant("kDrawTile")
    stage = min(rows * k, _source_constant("kDrawStage"))
    out = np.empty(n * (1 + k), np.int64)
    draws = r.reshape(-1).astype(np.uint64)
    k_recip = np.uint64(0xFFFFFFFF // k)
    for s0 in range(0, n, rows):
        tile = min(rows, n - s0)
        words = tile * k
        f = frontier[s0:s0 + tile].astype(np.int64)
        out[s0:s0 + tile] = f
        start = indptr[f].astype(np.int64)
        deg = (indptr[f + 1] - start).astype(np.uint64)
        base = np.where(deg > 0, start, f).astype(np.uint64)
        recip = (0xFFFFFFFF // np.maximum(deg, 1)).astype(np.uint64)
        for w0 in range(0, words, stage):
            w = w0 + np.arange(min(stage, words - w0), dtype=np.uint64)
            t = _div32(w, np.uint64(k), k_recip).astype(np.int64)
            live = deg[t] > 0
            sel = _mod32(draws[s0 * k + w.astype(np.int64)],
                         np.maximum(deg[t], 1), recip[t])
            pos = (base[t] + np.where(live, sel, 0)).astype(np.int64)
            out[n + s0 * k + w.astype(np.int64)] = np.where(
                live, indices[np.minimum(pos, len(indices) - 1)],
                base[t].astype(np.int64))
    return out.astype(np.int32)


@pytest.mark.parametrize("n,k", [(1, 1), (31, 25), (33, 33), (100, 41),
                                 (64, 10), (9, 200)])
def test_kernel_indexing_model_equals_the_plain_version(n, k):
    indptr, indices = _zero_degree_csr()
    rng = np.random.default_rng(n * 100 + k)
    frontier = rng.integers(0, len(indptr) - 1, n).astype(np.int32)
    frontier[: min(n, 3)] = [0, 3, 17][: min(n, 3)]
    r = rng.integers(0, 2**31 - 1, (n, k)).astype(np.int32)
    want = ds.draw_neighbors_reference(
        torch.from_numpy(frontier), torch.from_numpy(indptr),
        torch.from_numpy(indices), torch.from_numpy(r))
    np.testing.assert_array_equal(
        _kernel_draws(frontier, indptr, indices, r), want.numpy())
