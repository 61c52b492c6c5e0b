"""Several partitions per process in the port (ROADMAP item 14), against
the JAX package, which supplies every partition of the devices a process
addresses from that one process.

  (a) the three shuffles at P = 4 placed as (W processes, L partitions
      each) = (1, 4), (2, 2) and (4, 1), forward and backward, against
      their plain references over all P partitions (1e-6), with the same
      per-partition exchange counts in every placement and collectives
      only across processes;
  (b) one process holding 4 partitions, one batch of the C++ service with
      a 0.1 cache, against JAX's step on a 4-device CPU mesh at the same
      weights: logits and gradients within 1e-4 of scale, SAGE, GCN, GAT;
  (c) the CLI at the JAX multi-host test's flags: one process of 4
      partitions and two ``--distributed`` processes of 2 give the same
      run (accuracy equal, loss within 1e-5), within 1e-4 in loss and
      0.002 in accuracy of the JAX CLI's;
  (d) device-innermost draws under a replicated cache are bit-equal in
      the placements (1, 2) and (2, 1);
  (e) inference at P = 4 in one process predicts what 4 processes do;
  (f) the placement rules, and the flags that stop the CLI;
  (g) the feed of a process holding two of four partitions: the C++
      service (packed and unpacked arenas, worker-gathered tails) and the
      numpy slicer (host tails) emit the full batch's rows 1-2, and the
      cache frames of those partitions equal the full cache's; a
      replicated cache holds one frame for all of a process's partitions.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from occ_gnn_tpu import train as jax_train
from occ_gnn_tpu.cache import CachePlan as JaxCachePlan
from occ_gnn_tpu.cache import SplitFeatureCache as JaxSplitFeatureCache
from occ_gnn_tpu.data import block_graph as jax_block_graph
from occ_gnn_tpu.data import partition_graph
from occ_gnn_tpu.parallel.model import SplitGAT as JaxSplitGAT
from occ_gnn_tpu.parallel.model import SplitGCN as JaxSplitGCN
from occ_gnn_tpu.parallel.model import SplitSAGE as JaxSplitSAGE
from occ_gnn_tpu.parallel.model import _local_ce as jax_local_ce
from occ_gnn_tpu.parallel.model import _unstack
from occ_gnn_tpu.parallel.model import make_split_forward as jax_forward
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling.native import NativeSplitSampler as JaxNative
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import block_graph, random_graph
from occ_gnn_tpu_torch.parallel import dist
from occ_gnn_tpu_torch.parallel.model import (
    SplitGAT,
    SplitGCN,
    SplitSAGE,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.parallel.split import (
    reverse_shuffle_reference,
    shuffle_merge_reference,
    shuffle_softmax_merge_reference,
)
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
from occ_gnn_tpu_torch.sampling.slicer import SplitSampler
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax
from torch_ranks import device_innermost_rank, exchange_rank, run_ranks

REPO = Path(__file__).resolve().parent.parent
P = 4
GRAPH_KW = dict(num_nodes=500, avg_degree=6, feature_dim=16, num_classes=5,
                seed=1)
FANOUTS, BATCH, HIDDEN, SEED, HEADS, DH = [4, 3], 32, 16, 7, 2, 4
# The shuffles: f32 sums of at most P terms in another order.
OP_TOL = dict(rtol=1e-6, atol=1e-6)
# Logits and gradients of a step against JAX: 1e-4 of the tensor's scale.
SCALE_TOL = 1e-4
# The community graph of tests/test_distributed_cli.py.
COMMUNITY = dict(num_nodes=2000, num_blocks=8, avg_degree=8, feature_dim=16,
                 seed=0)
COMMON = [
    "--graph", "community", "--num-nodes", "2000", "--avg-degree", "8",
    "--feature-dim", "16", "--fan-out", "3,3", "--batch-size", "128",
    "--num-epochs", "2", "--mode", "split", "--partitions", "4",
    "--cache-per", "0.1", "--num-workers", "1", "--seed", "0", "--json",
]
PLACEMENTS = [(1, 4), (2, 2), (4, 1)]


def _last_json(out: str) -> dict:
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in output:\n{out[-2000:]}")


def _processes(argv, world: int, tmp_path) -> list[dict]:
    """``argv`` as ``world`` ``--distributed`` processes meeting at a
    ``file://`` store; every process's final metrics."""
    store = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "occ_gnn_tpu_torch.train", *argv,
         "--distributed", "--coordinator-address", store, "--num-processes",
         str(world), "--process-id", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ)) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-3000:]
            outs.append(_last_json(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))


# -- (a) the exchange in three placements -----------------------------------


@pytest.fixture(scope="module")
def setup(small_graph):
    pmap = partition_graph(small_graph, P, mode="greedy", attach=False)
    return dict(graph=GRAPH_KW, pmap=pmap, fanouts=FANOUTS, batch=BATCH,
                seed=SEED, hidden=HIDDEN)


@pytest.fixture(scope="module")
def full_batch(setup):
    """All P rows of the first batch, in this process."""
    g = random_graph(**GRAPH_KW)
    s = SplitSampler(g, g.train_nodes(), setup["pmap"], P, FANOUTS, BATCH,
                     seed=SEED, device="cpu")
    return s.slice_raw(s._sample_raw(g.train_nodes()[:BATCH]))


def _exchange_inputs(batch):
    """Per layer, every partition's rows of the shuffles' inputs (some
    softmax rows with no edge: m = -inf, zero sums) and loss weights."""
    rng = np.random.default_rng(0)
    out = []
    for lyr in batch.layers:
        shape = (P, lyr.dst_cap, HEADS)
        m = rng.standard_normal(shape).astype(np.float32)
        s = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        v = rng.standard_normal(shape + (DH,)).astype(np.float32)
        empty = rng.random(shape[:2]) < 0.2
        m[empty], s[empty], v[empty] = -np.inf, 0.0, 0.0
        ins = dict(neigh=rng.standard_normal((P, lyr.dst_cap, 8)),
                   frame=rng.standard_normal(shape), m=m, s=s, v=v)
        ins = {k: a.astype(np.float32) for k, a in ins.items()}
        for key, like in (("w_merge", "neigh"), ("w_er", "frame"),
                          ("w_s", "s"), ("w_v", "v")):
            ins[key] = rng.standard_normal(ins[like].shape).astype(
                np.float32)
        out.append(ins)
    return out


@pytest.fixture(scope="module")
def placed(setup, full_batch):
    """The exchange results of every placement, stitched back to P rows."""
    inputs = _exchange_inputs(full_batch)
    results = {}
    for W, L in PLACEMENTS:
        if W == 1:
            procs = [exchange_rank(dist.single_process(P, "cpu"), setup,
                                   inputs)]
        else:
            procs = run_ranks(exchange_rank, W, setup, inputs, local=L)
        layers = [{k: np.concatenate([p["layers"][l][k] for p in procs])
                   for k in procs[0]["layers"][l]}
                  for l in range(len(inputs))]
        results[W, L] = dict(layers=layers,
                             shuffles=[p["shuffles"] for p in procs],
                             collectives=[p["collectives"] for p in procs])
    return inputs, results


def _references(lyr, ins):
    """The three plain references over all P partitions, with their
    gradients of the same weighted sums."""
    t = {k: torch.from_numpy(v) for k, v in ins.items()}
    neigh = t["neigh"].clone().requires_grad_()
    merged = shuffle_merge_reference(neigh, lyr.push_idx, lyr.recv_idx)
    (merged * t["w_merge"]).sum().backward()
    frame = t["frame"].clone().requires_grad_()
    er = reverse_shuffle_reference(frame, lyr.push_idx, lyr.recv_idx)
    (er * t["w_er"]).sum().backward()
    s, v = t["s"].clone().requires_grad_(), t["v"].clone().requires_grad_()
    s_out, v_out = shuffle_softmax_merge_reference(t["m"], s, v, lyr.push_idx,
                                                   lyr.recv_idx)
    ((s_out * t["w_s"]).sum() + (v_out * t["w_v"]).sum()).backward()
    return dict(merged=merged, neigh_grad=neigh.grad, er=er,
                frame_grad=frame.grad, s=s_out, v=v_out, s_grad=s.grad,
                v_grad=v.grad)


@pytest.mark.parametrize("placement", PLACEMENTS,
                         ids=[f"W{w}xL{l}" for w, l in PLACEMENTS])
def test_exchange_matches_the_references_in_every_placement(full_batch,
                                                            placed,
                                                            placement):
    inputs, results = placed
    got = results[placement]
    for l, (lyr, ins) in enumerate(zip(full_batch.layers, inputs)):
        # Padded slots both ways: the masks are exercised.
        assert (lyr.push_idx == -1).any() and (lyr.push_idx >= 0).any()
        ref = _references(lyr, ins)
        for key, want in ref.items():
            have = got["layers"][l][key]
            assert np.isfinite(have).all(), key
            np.testing.assert_allclose(have, want.detach().numpy(),
                                       err_msg=f"layer {l} {key}", **OP_TOL)


def test_exchange_counts_are_per_partition(placed):
    _, results = placed
    counts = {json.dumps(sh, sort_keys=True)
              for r in results.values() for sh in r["shuffles"]}
    assert len(counts) == 1, counts
    (one,) = [json.loads(c) for c in counts]
    # Three shuffles a layer, each once forward and once backward.
    assert one["forward"] == one["backward"] == 3 * len(FANOUTS)
    assert one["bytes_sent"] > 0
    for (W, _), r in results.items():
        expected = 0 if W == 1 else one["forward"] + one["backward"]
        assert r["collectives"] == [expected] * W


# -- (b) one process of 4 partitions against JAX's 4-device mesh ------------


@pytest.fixture(scope="module")
def community():
    jg = jax_block_graph(**COMMUNITY)
    tg = block_graph(**COMMUNITY)
    pmap = partition_graph(jg, P, mode="greedy", attach=False)
    return jg, tg, pmap


@pytest.fixture(scope="module")
def cached_batches(community):
    """The first batch of both packages' C++ service at P = 4 with a 0.1
    refreshing cache, and the frames after its tail write."""
    jg, tg, pmap = community
    caps_kw = dict(capacities=None, seed=0, num_workers=1)
    jcache = JaxSplitFeatureCache(JaxCachePlan(jg, pmap, P, 0.1,
                                               refresh_cap=512))
    js = JaxNative(jg, jg.train_nodes(), pmap, P, [3, 3], 128, cache=jcache,
                   **caps_kw)
    tcache = SplitFeatureCache(CachePlan(tg, pmap, P, 0.1, refresh_cap=512),
                               device="cpu", partitions=(0, P))
    ts = NativeSplitSampler(tg, tg.train_nodes(), pmap, P, [3, 3], 128,
                            cache=tcache, emit_range=(0, P), device="cpu",
                            **caps_kw)
    try:
        jb, tb = next(iter(js)), next(iter(ts))
        jframes = jcache.frames
        tframes = tcache.frames.clone()
    finally:
        js.close()
        ts.close()
    # The static rows; tail rows past a partition's fill hold whatever
    # the pinned buffer held, and no batch reads them.
    ts = tcache.plan.tail_start
    np.testing.assert_array_equal(np.asarray(jframes)[:, :ts],
                                  tframes[:, :ts].numpy())
    np.testing.assert_array_equal(np.asarray(jb.labels), tb.labels.numpy())
    return jb, jframes, tb, tframes


KINDS = {"sage": (JaxSplitSAGE, SplitSAGE, {}),
         "gcn": (JaxSplitGCN, SplitGCN, {}),
         "gat": (JaxSplitGAT, SplitGAT, {"num_heads": HEADS})}


def _jax_loss_and_grads(jm, params, jb, jframes):
    def body(prm, layers, labels, xs):
        layers_l = [_unstack(l) for l in layers]
        logits = jm.forward_local(prm, layers_l, xs[0])
        nll, cnt, _ = jax_local_ce(logits, labels[0])
        return jax.lax.psum(nll, "p") / jnp.maximum(jax.lax.psum(cnt, "p"), 1)

    mapped = jax.shard_map(body, mesh=make_mesh(P),
                           in_specs=(PS(), PS("p"), PS("p"), PS("p")),
                           out_specs=PS(), check_vma=False)
    return jax.jit(jax.value_and_grad(
        lambda prm: mapped(prm, jb.layers, jb.labels, jframes)))(params)


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_process_of_four_matches_the_jax_mesh(community, cached_batches,
                                                  kind):
    jg, _, _ = community
    jb, jframes, tb, tframes = cached_batches
    jcls, tcls, kw = KINDS[kind]
    dims = (jg.feature_dim, HIDDEN, jg.num_classes, 2)
    jm = jcls(*dims, **kw)
    params = jm.init(jax.random.PRNGKey(5))
    jlogits = np.asarray(jax_forward(jm, make_mesh(P))(params, jb, jframes))
    jloss, jgrads = _jax_loss_and_grads(jm, params, jb, jframes)
    model = tcls(*dims, **kw)
    model.load_state_dict(params_from_jax(params))
    logits = make_split_forward(model)(tb, tframes).numpy()
    assert logits.shape == jlogits.shape
    assert _rel(logits, jlogits) <= SCALE_TOL
    loss, _, count = make_split_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.0))(tb, tframes)
    assert int(count) == int((np.asarray(jb.labels) >= 0).sum()) > 0
    assert _rel(float(loss), float(jloss)) <= SCALE_TOL
    for name, p in model.named_parameters():
        layer, leaf = name.split("/")
        want = np.asarray(jgrads[layer][leaf])
        if p.grad is None:  # GAT's last layer averages heads: no bias
            assert kind == "gat" and not want.any()
            continue
        assert _rel(p.grad.numpy(), want) <= SCALE_TOL, name


# -- (c) the CLI: one process, two processes, and JAX -----------------------


def test_cli_one_process_equals_two_and_jax(tmp_path):
    one = train.main(COMMON + ["--cpu", "--cpu-devices", "4"])
    two = _processes(COMMON + ["--cpu", "--cpu-devices", "2"], 2, tmp_path)
    assert one["backend"] == "none" and one["collectives"] == 0
    assert one["partitions_local"] == [0, 4] and one["partitions"] == 4
    assert [m["partitions_local"] for m in two] == [[0, 2], [2, 4]]
    for m in two:
        assert m["backend"] == "gloo" and m["collectives"] > 0
        assert m["acc"] == one["acc"] and m["steps"] == one["steps"]
        assert abs(m["loss"] - one["loss"]) <= 1e-5
        assert m["shuffle"] == one["shuffle"]
        assert m["tail_batches"] == m["steps"] > 0
    jm = jax_train.main(COMMON)
    assert abs(one["loss"] - jm["loss"]) <= 1e-4, (one["loss"], jm["loss"])
    assert abs(one["acc"] - jm["acc"]) <= 0.002, (one["acc"], jm["acc"])


# -- (d) device-innermost draws do not depend on the placement --------------


def test_device_innermost_draws_are_placement_free(small_graph):
    pmap = partition_graph(small_graph, 2, mode="greedy", attach=False)
    setup = dict(graph=GRAPH_KW, pmap=pmap, fanouts=FANOUTS, batch=BATCH,
                 seed=SEED, hidden=HIDDEN)
    model = SplitSAGE(GRAPH_KW["feature_dim"], HIDDEN,
                      GRAPH_KW["num_classes"], 2,
                      generator=torch.Generator().manual_seed(2))
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    one = device_innermost_rank(dist.single_process(2, "cpu"), setup, state)
    two = run_ranks(device_innermost_rank, 2, setup, state)
    assert len(one["nbr"]) == 2 and [len(r["nbr"]) for r in two] == [1, 1]
    for p in range(2):
        np.testing.assert_array_equal(one["nbr"][p], two[p]["nbr"][0])
        np.testing.assert_allclose(one["logits"][p], two[p]["logits"][0],
                                   **OP_TOL)


# -- (e) inference at P = 4 in one process and in four ----------------------


def test_infer_in_one_process_equals_four(tmp_path):
    flags = ["--graph", "community", "--num-nodes", "1500", "--fan-out",
             "4,4", "--batch-size", "128", "--num-hidden", "16",
             "--feature-dim", "16", "--cpu", "--seed", "3"]
    train.main(flags + ["--mode", "split", "--num-epochs", "1",
                        "--cpu-devices", "1", "--save-dir", str(tmp_path)])
    ck = str(tmp_path / "split_epoch.npz")
    preds = {}
    for devices in ("4", "1"):
        out = tmp_path / f"preds_{devices}.npy"
        m = train.main(flags + ["--mode", "infer", "--resume", ck,
                                "--infer-nodes", "val", "--partitions", "4",
                                "--cpu-devices", devices, "--output",
                                str(out)])
        assert m["partitions"] == 4
        preds[devices] = (m, np.load(out))
    (one, p1), (four, p4) = preds["4"], preds["1"]
    assert one["backend"] == "none" and four["backend"] == "gloo"
    assert (one["count"], one["acc"]) == (four["count"], four["acc"])
    assert one["count"] > 0
    np.testing.assert_array_equal(p1, p4)


# -- (f) placement and flags ------------------------------------------------


def test_placement_rules(monkeypatch):
    place = dist.placement
    # The CPU: ceil(P / --cpu-devices) processes; 0 partitions is the
    # virtual device count of each process.
    assert place(4, cpu=True, cpu_devices=8) == (4, 1)
    assert place(0, cpu=True, cpu_devices=8) == (8, 1)
    assert place(8, cpu=True, cpu_devices=2) == (8, 4)
    assert place(0, cpu=True, cpu_devices=2, world=2) == (4, 2)
    # The cards: one process per card the partitions land on.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert place(2, cpu=False, cpu_devices=8) == (2, 1)
    assert place(0, cpu=False, cpu_devices=8) == (1, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert place(8, cpu=False, cpu_devices=8) == (8, 4)
    assert place(2, cpu=False, cpu_devices=8) == (2, 2)
    assert place(0, cpu=False, cpu_devices=8, world=4) == (4, 4)
    # ddp and quiver place their shards by the same rule, through the
    # CLI's placement whatever the mode.
    for mode in ("split", "ddp", "quiver", "infer"):
        args = train.build_argparser().parse_args(
            ["--graph", "g", "--mode", mode, "--partitions", "4", "--cpu",
             "--cpu-devices", "2"])
        assert train._placement(args) == (4, 2)
        assert train._placement(args, world=4) == (4, 4)
    with pytest.raises(SystemExit, match="not a multiple"):
        place(6, cpu=False, cpu_devices=8)
    with pytest.raises(SystemExit, match="not a multiple"):
        place(4, cpu=True, cpu_devices=8, world=3)


@pytest.mark.parametrize("argv,message", [
    (["--mode", "ddp", "--cpu-devices", "2"],
     "--cpu-devices is not ported without --cpu"),
    (["--mode", "quiver", "--cpu-devices", "2"],
     "--cpu-devices is not ported without --cpu"),
    (["--mode", "split", "--cpu-devices", "2"],
     "--cpu-devices is not ported without --cpu"),
    (["--mode", "infer", "--cpu-devices", "2"],
     "--cpu-devices is not ported without --cpu"),
    (["--mode", "split", "--cpu", "--partitions", "3", "--cpu-devices", "2"],
     "--partitions 3 is not a multiple of the 2 processes"),
], ids=["ddp", "quiver", "split-on-card", "infer-on-card", "not-a-multiple"])
def test_flags_that_stop_the_cli(argv, message):
    with pytest.raises(SystemExit, match=message):
        train.main(["--graph", "community", "--num-nodes", "300", *argv])


def test_a_run_of_one_process_makes_no_group(monkeypatch):
    """A W = 1 run never creates a process group, whatever its P."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append(a))
    m = train.main(["--graph", "community", "--num-nodes", "600",
                    "--fan-out", "3,3", "--batch-size", "64",
                    "--num-epochs", "1", "--num-hidden", "8",
                    "--feature-dim", "8", "--partitions", "3",
                    "--cache-per", "0.2", "--cpu"])
    assert not calls and not torch.distributed.is_initialized()
    assert m["partitions"] == 3 and m["partitions_local"] == [0, 3]
    assert m["collectives"] == 0 and m["shuffle"]["forward"] > 0


# -- (g) the feed of a process that holds two of four partitions ------------


def _fields(batch):
    out = {"labels": batch.labels, "input": batch.input_nodes,
           "targets": batch.target_nodes}
    for i, lyr in enumerate(batch.layers):
        for f in ("edge_src", "edge_dst", "push_idx", "recv_idx",
                  "owned_idx", "owned_deg", "self_idx", "owned_mask",
                  "num_owned", "nbr_idx", "dst_global"):
            out[f"{i}.{f}"] = getattr(lyr, f)
    return {k: v for k, v in out.items() if v is not None}


def _read_rows(batch, frames) -> list[np.ndarray]:
    """Each partition's frame rows that the batch's layer 0 reads (tail
    rows past a partition's fill hold stale values no batch reads)."""
    lyr = batch.layers[0]
    out = []
    for j in range(frames.shape[0]):
        rows = [lyr.nbr_idx[j].reshape(-1)] if lyr.nbr_idx is not None else []
        if lyr.edge_src is not None:
            rows.append(lyr.edge_src[j][lyr.edge_dst[j] < lyr.dst_cap])
        rows = torch.unique(torch.cat(rows).long())
        out.append(frames[j].index_select(0, rows).numpy().copy())
    return out


@pytest.mark.parametrize("feed", ["native packed", "native unpacked",
                                  "numpy"])
def test_two_of_four_partitions_emit_the_full_rows(small_graph, feed):
    g = random_graph(**GRAPH_KW)
    pmap = partition_graph(small_graph, P, mode="greedy", attach=False)
    runs = {}
    for lo, hi in ((0, P), (1, 3)):
        cache = SplitFeatureCache(CachePlan(g, pmap, P, 0.1, refresh_cap=64),
                                  device="cpu", partitions=(lo, hi))
        if feed == "numpy":
            sampler = SplitSampler(g, g.train_nodes(), pmap, P, FANOUTS,
                                   BATCH, seed=SEED, cache=cache,
                                   emit_range=(lo, hi), device="cpu")
        else:
            sampler = NativeSplitSampler(
                g, g.train_nodes(), pmap, P, FANOUTS, BATCH, seed=SEED,
                cache=cache, num_workers=2, emit_range=(lo, hi),
                packed=feed == "native packed", device="cpu")
        batches = []
        for batch in sampler:
            batches.append(({k: v.clone() for k, v in _fields(batch).items()},
                            _read_rows(batch, cache.frames)))
        if hasattr(sampler, "close"):
            sampler.close()
        assert cache.tail_batches == len(batches) > 2
        runs[lo, hi] = batches
    for (full, full_rows), (mine, rows) in zip(runs[0, P], runs[1, 3]):
        assert set(mine) == set(full)
        for key, value in mine.items():
            assert value.shape[0] == 2, key
            np.testing.assert_array_equal(value.numpy(),
                                          full[key][1:3].numpy(), key)
        for j in range(2):
            np.testing.assert_array_equal(rows[j], full_rows[1 + j])


def test_replicated_cache_holds_one_frame(small_graph):
    g = random_graph(**GRAPH_KW)
    pmap = partition_graph(small_graph, P, mode="greedy", attach=False)
    cache = SplitFeatureCache(CachePlan(g, pmap, P, 1.0, refresh_cap=8),
                              device="cpu", partitions=(1, 4))
    frames = cache.frames
    assert frames.shape == (3, g.num_nodes + 1, g.feature_dim)
    assert frames.stride(0) == 0  # one frame, expanded without a copy
    np.testing.assert_array_equal(frames[2, :-1].numpy(), g.features)


def test_cache_tails_keep_the_frames_finite(small_graph, monkeypatch):
    """The C++ service fills a tail buffer only up to each partition's
    fill; the rest reaches the frame as it is. The service's buffers start
    zeroed, so the frames stay finite whatever fresh host memory holds
    (split GAT's COO layer 0 projects the whole frame, and a NaN row there
    made its weight gradient NaN on the card). Fresh memory is poisoned
    with NaN here."""
    empty = torch.empty

    def poisoned(*args, **kwargs):
        t = empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    g = random_graph(**GRAPH_KW)
    pmap = partition_graph(small_graph, P, mode="greedy", attach=False)
    cache = SplitFeatureCache(CachePlan(g, pmap, P, 0.1, refresh_cap=64),
                              device="cpu", partitions=(1, 3))
    monkeypatch.setattr(torch, "empty", poisoned)
    sampler = NativeSplitSampler(g, g.train_nodes(), pmap, P, FANOUTS, BATCH,
                                 seed=SEED, cache=cache, num_workers=2,
                                 emit_range=(1, 3), device="cpu")
    try:
        for _ in sampler:
            assert torch.isfinite(cache.frames).all()
    finally:
        sampler.close()
    assert cache.tail_batches > 2
