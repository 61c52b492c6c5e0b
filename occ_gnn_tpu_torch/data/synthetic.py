"""Synthetic graph generators for tests and the chip smoke run.

The same numpy RNG calls, in the same order, as the JAX package's
``data/synthetic.py``, so one seed gives identical arrays in both packages.
``block_graph`` follows the reference's synthetic converter (k blocks with
a controlled cross-block edge fraction); ``random_graph`` is a random graph
with skewed source popularity.
"""

from __future__ import annotations

import numpy as np

from occ_gnn_tpu_torch.data.graph import Graph, from_edge_list


def random_graph(
    num_nodes: int = 1000,
    avg_degree: int = 8,
    feature_dim: int = 32,
    num_classes: int = 8,
    seed: int = 0,
    power_law: float = 0.8,
) -> Graph:
    """Random directed graph with skewed in-degrees and random node data."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    # Skewed source popularity to exercise cache policies.
    pop = rng.random(num_nodes) ** (1.0 / max(power_law, 1e-3))
    pop /= pop.sum()
    src = rng.choice(num_nodes, size=num_edges, p=pop)
    dst = rng.integers(0, num_nodes, size=num_edges)
    keep = src != dst  # self loops are added by the sampler, not the graph
    src, dst = src[keep], dst[keep]
    features = rng.standard_normal((num_nodes, feature_dim)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    g = from_edge_list(src, dst, num_nodes, features, labels, num_classes)
    g.default_masks(seed)
    return g


def block_graph(
    num_nodes: int = 1024,
    num_blocks: int = 4,
    avg_degree: int = 8,
    cross_fraction: float = 0.1,
    feature_dim: int = 32,
    num_classes: int = 8,
    seed: int = 0,
) -> Graph:
    """Blocked community graph: labels follow blocks, so GNNs can learn it.

    Features are noisy one-hot block signatures — a model that aggregates
    neighbors correctly reaches near-perfect accuracy.
    """
    rng = np.random.default_rng(seed)
    block = rng.integers(0, num_blocks, size=num_nodes)
    num_edges = num_nodes * avg_degree
    dst = rng.integers(0, num_nodes, size=num_edges)
    cross = rng.random(num_edges) < cross_fraction
    src = np.empty(num_edges, dtype=np.int64)
    # Same-block edges: pick a random node, then snap to one sharing the block.
    by_block = [np.nonzero(block == b)[0] for b in range(num_blocks)]
    for b in range(num_blocks):
        sel = np.nonzero((block[dst] == b) & ~cross)[0]
        src[sel] = rng.choice(by_block[b], size=sel.shape[0])
    sel = np.nonzero(cross)[0]
    src[sel] = rng.integers(0, num_nodes, size=sel.shape[0])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    num_classes = max(num_classes, num_blocks)
    features = 0.5 * rng.standard_normal((num_nodes, feature_dim)).astype(np.float32)
    features[np.arange(num_nodes), block % feature_dim] += 2.0
    labels = block.astype(np.int32)
    g = from_edge_list(src, dst, num_nodes, features, labels, num_classes)
    g.default_masks(seed)
    return g
