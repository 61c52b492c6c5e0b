"""Entry points of the port: the twin of the JAX package's ``__graft_entry__``.

``entry()``             the 3-layer GraphSAGE forward over padded blocks on
                        the tiny graph, as ``(fn, example_args)``.
``dryrun_multichip(n)`` one process holding n partitions runs one full
                        split-parallel training step three ways (the
                        boundary exchange of every layer between its
                        partitions, the global loss, an Adam update):
                        SAGE fed by the C++ service with a refreshing 0.05
                        cache, GAT with 2 heads, and SAGE with its
                        innermost layer sampled on the device under a
                        replicated cache.

Both run on the CUDA device unless the caller passes ``device="cpu"``; with
no visible GPU and no device they stop. No step falls back to another
sampler: a C++ service that fails to build raises.

    python -m occ_gnn_tpu_torch.entry [--cpu] [--partitions N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

DRYRUN_FANOUTS, DRYRUN_BATCH = [4, 4], 64


def _device(device) -> torch.device:
    """``device``, or the CUDA device when it is None; never a fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device is visible to torch; pass "
                         "device='cpu' (--cpu) to run on the CPU")
    return torch.device("cuda")


def tiny_graph(num_nodes=2000, avg_degree=8, feature_dim=64, num_classes=16,
               seed=0):
    """The JAX entry points' graph (``__graft_entry__.py:16-26``)."""
    from occ_gnn_tpu_torch.data import random_graph

    return random_graph(num_nodes=num_nodes, avg_degree=avg_degree,
                        feature_dim=feature_dim, num_classes=num_classes,
                        seed=seed)


def entry(device=None):
    """``(fn, (params, batch, x0))``: ``fn(params, batch, x0)`` is the
    3-layer SAGE forward (hidden 128) of the tiny graph's first batch
    (fan-out 10,10,10, batch 256), returning logits ``[T_cap, C]``;
    ``params`` are the model's weights by their JAX keys
    (``layer_{i}/w``, ``layer_{i}/b``), so JAX weights load through
    ``utils.checkpoint.params_from_jax``."""
    from occ_gnn_tpu_torch.models import SAGEModel
    from occ_gnn_tpu_torch.sampling.neighbor import NeighborSampler
    from occ_gnn_tpu_torch.training import gather_features

    device = _device(device)
    g = tiny_graph()
    sampler = NeighborSampler(g, g.train_nodes(), [10, 10, 10], 256, seed=0,
                              device=device)
    batch = next(iter(sampler))
    model = SAGEModel(g.feature_dim, 128, g.num_classes, 3,
                      generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    params = {k: v.detach() for k, v in model.named_parameters()}
    x0 = gather_features(g.features, batch.input_nodes, device)

    def fn(params, batch, x0):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (batch, x0))

    return fn, (params, batch, x0)


def dryrun_graph():
    """The dry run's graph (``__graft_entry__.py:67-68``)."""
    return tiny_graph(num_nodes=800, avg_degree=6, feature_dim=32,
                      num_classes=8)


def sage_step(g, pmap, n: int, device, model, optimizer):
    """The dry run's first step: one process holding all ``n`` partitions,
    fed by the C++ service (``emit_range=(0, n)``) through a 0.05 cache
    that refreshes every batch; ``model`` (a ``SplitSAGE``) takes one
    ``optimizer`` step. Returns ``(loss, correct, count)``."""
    from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
    from occ_gnn_tpu_torch.parallel.model import make_split_train_step
    from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler

    cache = SplitFeatureCache(CachePlan(g, pmap, n, 0.05, refresh_cap=512),
                              device=device, partitions=(0, n))
    sampler = NativeSplitSampler(g, g.train_nodes(), pmap, n, DRYRUN_FANOUTS,
                                 DRYRUN_BATCH, seed=0, cache=cache,
                                 num_workers=1, emit_range=(0, n),
                                 device=device)
    try:
        batch = next(iter(sampler))
        step = make_split_train_step(model, optimizer)
        return step(batch, cache.frames)
    finally:
        sampler.close()


def dryrun_multichip(n: int, device=None) -> list[float]:
    """One split-parallel train step over ``n`` partitions held by this
    process, three ways (``__graft_entry__.py:50-163``): SAGE through the
    C++ service and the refreshing cache, GAT with 2 heads, and SAGE with
    its innermost layer synthesized on the device under the replicated
    cache. Each asserts a finite loss and a count above 0 and prints a
    line; returns the three losses."""
    from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
    from occ_gnn_tpu_torch.data.partition import partition_graph
    from occ_gnn_tpu_torch.parallel.dist import rank_seed
    from occ_gnn_tpu_torch.parallel.model import (
        SplitGAT,
        SplitSAGE,
        make_device_csr,
        make_split_train_step,
    )
    from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
    from occ_gnn_tpu_torch.sampling.slicer import SplitSampler
    from occ_gnn_tpu_torch.training import gather_features

    device = _device(device)
    g = dryrun_graph()
    pmap = partition_graph(g, n, mode="greedy")
    model = SplitSAGE(g.feature_dim, 32, g.num_classes, 2,
                      generator=torch.Generator().manual_seed(0)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    loss, correct, count = sage_step(g, pmap, n, device, model, opt)
    losses = [_checked("", loss, count)]
    print(f"dryrun_multichip({n}): loss={losses[0]:.4f} "
          f"acc={int(correct)}/{int(count)} OK")

    # GAT on the same partitions: each layer's reverse shuffle and softmax
    # merge, on a batch of the numpy slicer with gathered frames.
    gat = SplitGAT(g.feature_dim, 16, g.num_classes, 2, num_heads=2,
                   generator=torch.Generator().manual_seed(1)).to(device)
    gat_sampler = SplitSampler(g, g.train_nodes(), pmap, n, DRYRUN_FANOUTS,
                               DRYRUN_BATCH, seed=1,
                               scatter_plans=gat.needs_scatter_plans,
                               device=device)
    gat_batch = gat_sampler.sample_batch(g.train_nodes()[:DRYRUN_BATCH])
    xs = torch.stack([gather_features(g.features, ids, device)
                      for ids in gat_batch.input_nodes_host])
    gat_step = make_split_train_step(
        gat, torch.optim.Adam(gat.parameters(), lr=1e-2))
    gat_loss, _, gat_count = gat_step(gat_batch, xs)
    losses.append(_checked(" GAT", gat_loss, gat_count))
    print(f"dryrun_multichip({n}) GAT: loss={losses[1]:.4f} OK")

    # Device-innermost sampling: the replicated identity frame, held once,
    # and layer 0 synthesized per partition from the resident CSR with
    # that partition's own generator. The SAGE model and its optimizer
    # state carry on from the first step, as in JAX.
    cache_r = SplitFeatureCache(CachePlan(g, pmap, n, 1.0, refresh_cap=8),
                                device=device, partitions=(0, n))
    dev_sampler = NativeSplitSampler(
        g, g.train_nodes(), pmap, n, DRYRUN_FANOUTS, DRYRUN_BATCH, seed=2,
        cache=cache_r, num_workers=1, innermost="device", emit_range=(0, n),
        device=device)
    try:
        dev_batch = dev_sampler.sample_batch(g.train_nodes()[:DRYRUN_BATCH])
        dstep = make_split_train_step(model, opt,
                                      csr=make_device_csr(g, device))
        gens = [torch.Generator(device).manual_seed(rank_seed(3, p))
                for p in range(n)]
        dloss, _, dcount = dstep(dev_batch, cache_r.frames,
                                 sample_generator=gens)
    finally:
        dev_sampler.close()
    losses.append(_checked(" device-innermost", dloss, dcount))
    print(f"dryrun_multichip({n}) device-innermost: loss={losses[2]:.4f} OK")
    return losses


def _checked(what: str, loss, count) -> float:
    value = float(loss)
    if not np.isfinite(value):
        raise AssertionError(f"non-finite{what} loss {value}")
    if int(count) <= 0:
        raise AssertionError(f"no valid target in the{what} step")
    return value


def main(argv=None) -> None:
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("--cpu", action="store_true",
                     help="run on the CPU instead of the CUDA device")
    cli.add_argument("--partitions", type=int, default=4,
                     help="partitions of the dry run, all in this process")
    opts = cli.parse_args(argv)
    device = "cpu" if opts.cpu else None
    fn, args = entry(device)
    print("entry forward:", tuple(fn(*args).shape))
    dryrun_multichip(opts.partitions, device)


if __name__ == "__main__":
    main()
