"""Multi-process helpers for the port's P > 1 tests (no JAX here: the ranks
import only torch and the port).

``run_ranks(fn, P, *args)`` spawns P fresh processes that join one gloo
process group through a ``file://`` store (no TCP port to race for under
xdist), calls ``fn(ranks, *args)`` on each rank, and returns what every
rank returned, in rank order. A rank that fails stops the others.

The rank functions below compute one rank's part of a sliced P-way batch:
``shuffle_rank`` the boundary shuffle and its gradient, ``gat_shuffle_rank``
GAT's two shuffles and their gradients, ``split_rank`` the logits, loss,
gradients and all-to-all counts of a step with lr 0, ``adam_rank`` the
weights after Adam steps. ``ddp_rank`` and ``quiver_rank`` run one step of
the data-parallel and quiver baselines on this rank's shard.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

from occ_gnn_tpu_torch.parallel import dist

TIMEOUT_S = 50


def run_ranks(fn, world_size: int, *args) -> list:
    with tempfile.TemporaryDirectory(prefix="occ_test_ranks_") as tmp:
        dist.spawn(_rank_entry, world_size, fn, tmp, args, timeout=TIMEOUT_S)
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_entry(rank, world_size, store, fn, out_dir, args):
    ranks = dist.init_distributed(store, world_size, rank, cpu=True)
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
    """The graph, and a sampler that emits this rank's rows."""
    from occ_gnn_tpu_torch.data import random_graph
    from occ_gnn_tpu_torch.sampling.slicer import SplitSampler

    g = random_graph(**setup["graph"])
    sampler = SplitSampler(
        g, g.train_nodes(), setup["pmap"], ranks.world_size,
        setup["fanouts"], setup["batch"], seed=setup["seed"], device="cpu",
        emit_range=(ranks.rank, ranks.rank + 1))
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
    gradient of ``sum(merged * weights[l][rank])`` with respect to them."""
    from occ_gnn_tpu_torch.parallel.split import shuffle_merge

    g, sampler = _sampler(ranks, setup)
    batch = sampler.slice_raw(sampler._sample_raw(
        g.train_nodes()[: setup["batch"]]))
    out = []
    for l, lyr in enumerate(batch.layers):
        lp = lyr.partition(0)
        neigh = torch.from_numpy(neighs[l][ranks.rank]).requires_grad_()
        merged = shuffle_merge(neigh, lp.push_idx, lp.recv_idx)
        (merged * torch.from_numpy(weights[l][ranks.rank])).sum().backward()
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
    r = ranks.rank
    out = []
    for l, lyr in enumerate(batch.layers):
        lp = lyr.partition(0)
        w_er, w_s, w_v = (torch.from_numpy(w[r]) for w in weights[l])
        frame = torch.from_numpy(frames[l][r]).requires_grad_()
        er = reverse_shuffle(frame, lp.push_idx, lp.recv_idx)
        (er * w_er).sum().backward()
        s = torch.from_numpy(sloc[l][r]).requires_grad_()
        v = torch.from_numpy(vloc[l][r]).requires_grad_()
        s_out, v_out = shuffle_softmax_merge(
            torch.from_numpy(mloc[l][r]), s, v, lp.push_idx, lp.recv_idx)
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
