"""The benchmark's graph: ogbn-products' published sizes, made from the
seed on the device in a few large calls, then copied to the host.

Each undirected edge joins a node drawn by popularity ``u ** (1 / a)``
(``a`` the config's ``popularity_exponent``; the port's
``data/synthetic.random_graph`` draws its sources so) to a uniform node,
and is stored both ways, so a node's in-neighbours are its neighbours. A
pair that would be a self loop moves its second end to the next node, so
the edge count is exact. Repeated pairs are kept. The graph is an
in-neighbour CSR sorted by (node, neighbour). Features are standard
normal, labels uniform, and the train / val / test nodes OGB's counts
over one seeded permutation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class GraphData:
    """Host arrays, as the port's ``Graph`` takes them."""

    indptr: np.ndarray      # int64 [N + 1]
    indices: np.ndarray     # int64 [E], sorted within each node's run
    features: np.ndarray    # float32 [N, F]
    labels: np.ndarray      # int32 [N]
    train_mask: np.ndarray  # bool [N]
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    def train_nodes(self) -> np.ndarray:
        return np.nonzero(self.train_mask)[0].astype(np.int64)


def make_graph(cfg: dict, seed: int, device) -> GraphData:
    """The config's graph from ``seed`` (a 63-bit sub-seed), built on
    ``device`` and returned on the host."""
    n, m = int(cfg["num_nodes"]), int(cfg["num_undirected_edges"])
    f, c = int(cfg["feature_dim"]), int(cfg["num_classes"])
    splits = [int(cfg[k]) for k in ("train_nodes", "val_nodes", "test_nodes")]
    if sum(splits) > n:
        raise ValueError(f"splits {splits} exceed {n} nodes")
    gen = torch.Generator(device).manual_seed(seed)
    pop = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    pop = pop ** (1.0 / float(cfg["popularity_exponent"]))
    cdf = torch.cumsum(pop, 0)
    cdf /= cdf[-1].clone()
    del pop
    u = torch.searchsorted(cdf, torch.rand(m, generator=gen, device=device,
                                           dtype=torch.float64))
    u = u.clamp_(max=n - 1)
    del cdf
    v = torch.randint(0, n, (m,), generator=gen, device=device)
    v = torch.where(v == u, (v + 1) % n, v)
    # Key dst * n + src over both directions, sorted: the CSR by dst with
    # each run sorted by src.
    keys = torch.cat([v * n + u, u * n + v])
    del u, v
    keys = torch.sort(keys).values
    dst = torch.div(keys, n, rounding_mode="floor")
    indices = (keys - dst * n).cpu().numpy()
    del keys
    deg = torch.bincount(dst, minlength=n)
    del dst
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(deg, 0)
    features = torch.randn(n, f, generator=gen, device=device)
    labels = torch.randint(0, c, (n,), generator=gen, device=device,
                           dtype=torch.int32)
    order = torch.randperm(n, generator=gen, device=device)
    split_of = torch.full((n,), 3, dtype=torch.int8, device=device)
    lo = 0
    for k, size in enumerate(splits):
        split_of[order[lo:lo + size]] = k
        lo += size
    split_of = split_of.cpu().numpy()
    return GraphData(
        indptr=indptr.cpu().numpy(), indices=indices,
        features=features.cpu().numpy(), labels=labels.cpu().numpy(),
        train_mask=split_of == 0, val_mask=split_of == 1,
        test_mask=split_of == 2, num_classes=c)
