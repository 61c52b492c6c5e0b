"""Multi-process helpers for the port's P > 1 tests (no JAX here: the ranks
import only torch and the port).

``run_ranks(fn, W, *args, local=L)`` spawns W fresh processes that join
one gloo process group through a ``file://`` store (no TCP port to race
for under xdist), each holding L partitions (1 by default), calls
``fn(ranks, *args)`` on each rank, and returns what every rank returned,
in rank order. A rank that fails stops the others.

The rank functions below compute one process's part (its partitions
``[lo, hi)``) of a sliced P-way batch:
``shuffle_rank`` the boundary shuffle and its gradient, ``gat_shuffle_rank``
GAT's two shuffles and their gradients, ``split_rank`` the logits, loss,
gradients and all-to-all counts of a step with lr 0, ``adam_rank`` the
weights after Adam steps, ``gat_variant_rank`` split_rank of GAT under
each attention lowering. ``ddp_rank`` and ``quiver_rank`` run one step of
the data-parallel and quiver baselines on this rank's shard.
``exchange_rank`` runs the three shuffles of a process of several
partitions, and ``device_innermost_rank`` its device-synthesized layers;
both also run in the test process with ``dist.single_process``.

``run_cli(argv, W)`` runs ``train.main(argv)`` as W ``--distributed``
processes, as the CLI's launcher does (in the test process when W = 1),
and returns each process's metrics and final weights.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

from occ_gnn_tpu_torch.parallel import dist

TIMEOUT_S = 50


def run_ranks(fn, world_size: int, *args, local: int = 1) -> list:
    with tempfile.TemporaryDirectory(prefix="occ_test_ranks_") as tmp:
        dist.spawn(_rank_entry, world_size, fn, tmp, args, local,
                   timeout=TIMEOUT_S)
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_entry(rank, world_size, store, fn, out_dir, args, local):
    ranks = dist.init_distributed(store, world_size, rank, cpu=True,
                                  local=local)
    try:
        result = fn(ranks, *args)
    finally:
        dist.close(ranks)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


# -- one rank's part of a P-way sliced batch --------------------------------


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _sampler(ranks, setup):
    """The graph, and a sampler that emits this rank's rows (with the
    scatter plans that split GAT's backward reads)."""
    from occ_gnn_tpu_torch.data import random_graph
    from occ_gnn_tpu_torch.sampling.slicer import SplitSampler

    g = random_graph(**setup["graph"])
    sampler = SplitSampler(
        g, g.train_nodes(), setup["pmap"], ranks.num_partitions,
        setup["fanouts"], setup["batch"], seed=setup["seed"], device="cpu",
        emit_range=dist.local_partition_range(ranks), scatter_plans=True)
    return g, sampler


def _frame(g, batch):
    from occ_gnn_tpu_torch.training import gather_features

    return gather_features(g.features, batch.input_nodes_host[0], "cpu")[None]


def _model(setup, kind, state):
    from occ_gnn_tpu_torch.parallel.model import SplitGAT, SplitGCN, SplitSAGE

    g = setup["graph"]
    dims = (g["feature_dim"], setup["hidden"], g["num_classes"],
            len(setup["fanouts"]))
    if kind == "gat":
        model = SplitGAT(*dims, num_heads=setup["heads"])
    else:
        model = {"sage": SplitSAGE, "gcn": SplitGCN}[kind](*dims)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def shuffle_rank(ranks, setup, neighs, weights):
    """``shuffle_merge`` of this rank's rows of ``neighs[l]`` (all P
    partitions' partial sums, ``[P, dst_cap, H]``) for each layer, and the
    gradient of ``sum(merged * weights[l][lo:hi])`` with respect to them,
    ``[L, ...]`` each."""
    from occ_gnn_tpu_torch.parallel.split import shuffle_merge

    g, sampler = _sampler(ranks, setup)
    batch = sampler.slice_raw(sampler._sample_raw(
        g.train_nodes()[: setup["batch"]]))
    out = []
    mine = slice(*dist.local_partition_range(ranks))
    for l, lyr in enumerate(batch.layers):
        neigh = torch.from_numpy(neighs[l][mine]).requires_grad_()
        merged = shuffle_merge(neigh, lyr.push_idx, lyr.recv_idx)
        (merged * torch.from_numpy(weights[l][mine])).sum().backward()
        out.append((_numpy(merged), _numpy(neigh.grad)))
    return out


def split_rank(ranks, setup, kind, state):
    """This rank's logits (forward), and the global loss, count, correct
    and the all-reduced gradients of one train step with lr 0, on the
    first batch of ``setup``."""
    from occ_gnn_tpu_torch.parallel.model import (
        make_split_forward,
        make_split_train_step,
    )
    from occ_gnn_tpu_torch.parallel.split import (
        reset_shuffle_counts,
        shuffle_counts,
    )

    g, sampler = _sampler(ranks, setup)
    batch = sampler.slice_raw(sampler._sample_raw(
        g.train_nodes()[: setup["batch"]]))
    x0 = _frame(g, batch)
    model = _model(setup, kind, state)
    logits = make_split_forward(model, ranks=ranks)(batch, x0)[0]
    step = make_split_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.0), ranks=ranks)
    reset_shuffle_counts()
    loss, correct, count = step(batch, x0)
    shuffles = shuffle_counts()
    grads = {n: _numpy(p.grad) for n, p in model.named_parameters()}
    return dict(logits=_numpy(logits), loss=float(loss),
                correct=int(correct), count=int(count), grads=grads,
                labels=_numpy(batch.labels[0]), shuffles=shuffles)


def adam_rank(ranks, setup, kind, state, num_steps, lr):
    """The weights after ``num_steps`` Adam steps on the sampler's first
    batches, and the global loss of each step."""
    from occ_gnn_tpu_torch.parallel.model import make_split_train_step

    g, sampler = _sampler(ranks, setup)
    model = _model(setup, kind, state)
    step = make_split_train_step(
        model, torch.optim.Adam(model.parameters(), lr=lr), ranks=ranks)
    losses = []
    for _, batch in zip(range(num_steps), sampler):
        loss, _, _ = step(batch, _frame(g, batch))
        losses.append(float(loss))
    return dict(losses=losses,
                weights={n: _numpy(p) for n, p in model.named_parameters()})


def everything_rank(ranks, setup, neighs, weights, states, num_steps, lr):
    """Every rank function above in one process group, for one spawn."""
    return dict(
        shuffle=shuffle_rank(ranks, setup, neighs, weights),
        split={k: split_rank(ranks, setup, k, s) for k, s in states.items()},
        adam={k: adam_rank(ranks, setup, k, s, num_steps, lr)
              for k, s in states.items()},
    )


def gat_shuffle_rank(ranks, setup, frames, mloc, sloc, vloc, weights):
    """For each layer: ``reverse_shuffle`` of this rank's rows of
    ``frames[l]`` (``[P, dst_cap, C]``) and the gradient of ``sum(out *
    weights[l][0][rank])``; ``shuffle_softmax_merge`` of this rank's rows
    of the partials ``mloc``, ``sloc``, ``vloc`` and the gradients of
    ``sum(s * weights[l][1][rank]) + sum(v * weights[l][2][rank])`` with
    respect to ``s`` and ``v``."""
    from occ_gnn_tpu_torch.parallel.split import (
        reverse_shuffle,
        shuffle_softmax_merge,
    )

    g, sampler = _sampler(ranks, setup)
    batch = sampler.slice_raw(sampler._sample_raw(
        g.train_nodes()[: setup["batch"]]))
    r = slice(*dist.local_partition_range(ranks))
    out = []
    for l, lyr in enumerate(batch.layers):
        w_er, w_s, w_v = (torch.from_numpy(w[r]) for w in weights[l])
        frame = torch.from_numpy(frames[l][r]).requires_grad_()
        er = reverse_shuffle(frame, lyr.push_idx, lyr.recv_idx)
        (er * w_er).sum().backward()
        s = torch.from_numpy(sloc[l][r]).requires_grad_()
        v = torch.from_numpy(vloc[l][r]).requires_grad_()
        s_out, v_out = shuffle_softmax_merge(
            torch.from_numpy(mloc[l][r]), s, v, lyr.push_idx, lyr.recv_idx)
        ((s_out * w_s).sum() + (v_out * w_v).sum()).backward()
        out.append(dict(er=_numpy(er), frame_grad=_numpy(frame.grad),
                        s=_numpy(s_out), v=_numpy(v_out),
                        s_grad=_numpy(s.grad), v_grad=_numpy(v.grad)))
    return out


def gat_rank(ranks, setup, shuffle_inputs, state, num_steps, lr):
    """Every GAT rank function in one process group, for one spawn."""
    return dict(shuffle=gat_shuffle_rank(ranks, setup, *shuffle_inputs),
                split=split_rank(ranks, setup, "gat", state),
                adam=adam_rank(ranks, setup, "gat", state, num_steps, lr))


# -- the baselines: one rank's shard ----------------------------------------


def _single_model(setup, kind, state):
    from occ_gnn_tpu_torch.models import get_model

    g = setup["graph"]
    kw = {"num_heads": setup["heads"]} if kind == "gat" else {}
    model = get_model(kind, g["feature_dim"], setup["hidden"],
                      g["num_classes"], len(setup["fanouts"]), **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def ddp_rank(ranks, setup, states, lr):
    """For each model kind, one DDP step on the first batch of this rank's
    shard: with lr 0 the global loss, correct and count and the
    all-reduced gradients; with Adam at ``lr`` the weights after it."""
    from occ_gnn_tpu_torch.data import random_graph
    from occ_gnn_tpu_torch.parallel.dp import make_dp_train_step
    from occ_gnn_tpu_torch.sampling.neighbor import NeighborSampler
    from occ_gnn_tpu_torch.training import gather_features

    g = random_graph(**setup["graph"])
    r = ranks.rank
    sampler = NeighborSampler(g, setup["shards"][r], setup["fanouts"],
                              setup["per_dev"], capacities=setup["caps"],
                              seed=setup["seed"] + r, drop_last=True,
                              device="cpu")
    batch = next(iter(sampler))
    x0 = gather_features(g.features, batch.input_nodes, "cpu")
    out = {}
    for kind, state in states.items():
        model = _single_model(setup, kind, state)
        loss, correct, count = make_dp_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.0), ranks)(
                batch, x0)
        grads = {n: _numpy(p.grad) for n, p in model.named_parameters()}
        model = _single_model(setup, kind, state)
        make_dp_train_step(model, torch.optim.Adam(model.parameters(), lr=lr),
                           ranks)(batch, x0)
        out[kind] = dict(loss=float(loss), correct=int(correct),
                         count=int(count), grads=grads,
                         weights={n: _numpy(p) for n, p in
                                  model.named_parameters()})
    return out


def quiver_rank(ranks, setup, state, lr):
    """One quiver step (``DeviceSampleTrainer``) on this rank's row of the
    first batch: the global loss, correct and count and the weights after
    Adam at ``lr``."""
    from occ_gnn_tpu_torch.data.graph import Graph
    from occ_gnn_tpu_torch.sampling.device_sampler import DeviceSampleTrainer

    g = Graph(**setup["ring"])
    model = _single_model(setup, "sage", state)
    trainer = DeviceSampleTrainer(
        g, setup["fanouts"], setup["batch"], model,
        torch.optim.Adam(model.parameters(), lr=lr), seed=setup["seed"],
        device="cpu", ranks=ranks)
    loss, correct, count = trainer.step(*next(trainer.epoch_batches(
        g.train_nodes())))
    return dict(loss=float(loss), correct=int(correct), count=int(count),
                weights={n: _numpy(p) for n, p in model.named_parameters()})


def gat_variant_rank(ranks, setup, state, variants):
    """``split_rank`` of GAT under each ``(attention, remat)`` lowering of
    ``variants`` (``ops/config.py``), in one process group."""
    from occ_gnn_tpu_torch.ops import config

    out = {}
    for attention, remat in variants:
        config.set_gat_attention_impl(attention)
        config.set_gat_remat_impl(remat)
        out[attention, remat] = split_rank(ranks, setup, "gat", state)
    return out


# -- several partitions per process -----------------------------------------


def exchange_rank(ranks, setup, inputs):
    """The three shuffles of this process's partitions ``[lo, hi)`` on the
    first batch of ``setup``, forward and backward: for each layer,
    ``shuffle_merge`` of ``inputs[l]["neigh"]``, ``reverse_shuffle`` of
    ``["frame"]`` and ``shuffle_softmax_merge`` of ``["m"]``, ``["s"]``,
    ``["v"]`` (all P partitions' rows; this process takes its own), each
    with the gradient of its weighted sum; and the exchange counts."""
    from occ_gnn_tpu_torch.parallel.split import (
        collective_count,
        reset_shuffle_counts,
        reverse_shuffle,
        shuffle_counts,
        shuffle_merge,
        shuffle_softmax_merge,
    )

    g, sampler = _sampler(ranks, setup)
    batch = sampler.slice_raw(sampler._sample_raw(
        g.train_nodes()[: setup["batch"]]))
    mine = slice(*dist.local_partition_range(ranks))
    reset_shuffle_counts()
    out = []
    for lyr, ins in zip(batch.layers, inputs):
        t = {k: torch.from_numpy(v[mine]) for k, v in ins.items()}
        push, recv = lyr.push_idx, lyr.recv_idx
        neigh = t["neigh"].requires_grad_()
        merged = shuffle_merge(neigh, push, recv)
        (merged * t["w_merge"]).sum().backward()
        frame = t["frame"].requires_grad_()
        er = reverse_shuffle(frame, push, recv)
        (er * t["w_er"]).sum().backward()
        s, v = t["s"].requires_grad_(), t["v"].requires_grad_()
        s_out, v_out = shuffle_softmax_merge(t["m"], s, v, push, recv)
        ((s_out * t["w_s"]).sum() + (v_out * t["w_v"]).sum()).backward()
        out.append(dict(merged=_numpy(merged), neigh_grad=_numpy(neigh.grad),
                        er=_numpy(er), frame_grad=_numpy(frame.grad),
                        s=_numpy(s_out), v=_numpy(v_out),
                        s_grad=_numpy(s.grad), v_grad=_numpy(v.grad)))
    return dict(layers=out, shuffles=shuffle_counts(),
                collectives=collective_count())


def device_innermost_rank(ranks, setup, state):
    """This process's partitions' layer 0, synthesized on the device (the
    CPU here) from the resident CSR under a replicated cache, partition p
    from its own generator ``rank_seed(seed, p)``, and the logits of the
    SAGE forward over them; the C++ service emits ``[lo, hi)``."""
    from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
    from occ_gnn_tpu_torch.data import random_graph
    from occ_gnn_tpu_torch.parallel.model import (
        _local_layers,
        _materialize_layers,
        make_device_csr,
        make_split_forward,
    )
    from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler

    g = random_graph(**setup["graph"])
    lo, hi = dist.local_partition_range(ranks)
    P = ranks.num_partitions
    cache = SplitFeatureCache(CachePlan(g, setup["pmap"], P, 1.0,
                                        refresh_cap=8),
                              device="cpu", partitions=(lo, hi))
    sampler = NativeSplitSampler(
        g, g.train_nodes(), setup["pmap"], P, setup["fanouts"],
        setup["batch"], seed=setup["seed"], cache=cache, num_workers=1,
        innermost="device", emit_range=(lo, hi), device="cpu")
    try:
        batch = sampler.sample_batch(g.train_nodes()[: setup["batch"]])
    finally:
        sampler.close()
    csr = make_device_csr(g, "cpu")

    def gens():
        return [torch.Generator().manual_seed(dist.rank_seed(setup["seed"], p))
                for p in range(lo, hi)]

    parts = _materialize_layers(_local_layers(batch, ranks), csr, gens())
    model = _model(setup, "sage", state)
    logits = make_split_forward(model, csr=csr, ranks=ranks)(
        batch, cache.frames, sample_generator=gens())
    return dict(nbr=[_numpy(layers[0].nbr_idx) for layers in parts],
                logits=_numpy(logits))


# -- the CLI, as its launcher runs it ----------------------------------------


def run_cli(argv: list[str], world_size: int) -> list[dict]:
    """``train.main(argv)`` as ``world_size`` processes joined by
    ``--distributed`` at a ``file://`` store, as ``dist.launch`` runs them
    (in this process when there is one): each process's ``metrics`` and
    the final ``weights`` of the model its mode built, in rank order."""
    if world_size == 1:
        return [_cli_process(argv)]
    with tempfile.TemporaryDirectory(prefix="occ_test_cli_") as tmp:
        dist.spawn(_cli_rank, world_size, argv, tmp, timeout=TIMEOUT_S)
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _cli_process(argv: list[str]) -> dict:
    from occ_gnn_tpu_torch import models, train

    built = []
    real = models.get_model

    def get_model(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    models.get_model = get_model
    try:
        metrics = train.main(argv)
    finally:
        models.get_model = real
    return dict(metrics=metrics, weights={
        n: _numpy(p) for n, p in built[-1].named_parameters()})


def _cli_rank(rank, world_size, store, argv, out_dir):
    out = _cli_process(argv + [
        "--distributed", "--coordinator-address", store,
        "--num-processes", str(world_size), "--process-id", str(rank)])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
