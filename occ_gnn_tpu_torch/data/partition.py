"""Static graph partitioning (node -> partition id).

The JAX package's ``data/partition.py``, with the same numpy, so one graph
and seed give the same map in both packages:

  * ``round_robin`` / ``random``: node ``v`` on ``v % P``, or on a seeded
    uniform draw.
  * ``greedy``: weighted Linear Deterministic Greedy (LDG), a streaming
    partitioner over the nodes in high-degree-first order. It is a Python
    loop over every adjacency entry: minutes at millions of edges.
  * ``metis``: the multilevel coarsen / partition / refine partitioner of
    ``csrc/partition.cpp`` (a verbatim copy of the JAX package's), built
    with ``g++`` into the port's ``build/`` directory (``ops.build``).

Two differences from the JAX package. When the C++ partitioner cannot be
built or fails, ``metis`` raises, where the JAX package falls back to LDG
without a word. And an external ``gpmetis`` on ``PATH`` is never used:
``metis`` always means the in-repo partitioner.
"""

from __future__ import annotations

import ctypes

import numpy as np

from occ_gnn_tpu_torch.data.graph import Graph
from occ_gnn_tpu_torch.ops.build import load_partitioner

MODES = ("greedy", "metis", "random", "round_robin")


def partition_graph(
    graph: Graph,
    num_partitions: int,
    mode: str = "greedy",
    seed: int = 0,
    attach: bool = True,
) -> np.ndarray:
    """int32 ``[num_nodes]`` partition ids in ``[0, num_partitions)``;
    ``attach`` also stores the map as ``graph.partition_map``."""
    if mode == "round_robin":
        pmap = (np.arange(graph.num_nodes) % num_partitions).astype(np.int32)
    elif mode == "random":
        rng = np.random.default_rng(seed)
        pmap = rng.integers(0, num_partitions,
                            size=graph.num_nodes).astype(np.int32)
    elif mode == "greedy":
        pmap = _ldg_partition(graph, num_partitions)
    elif mode == "metis":
        pmap = _multilevel_partition(graph, num_partitions, seed=seed)
    else:
        raise ValueError(f"unknown partition mode: {mode}")
    if attach:
        graph.partition_map = pmap
    return pmap


def edge_cut_fraction(graph: Graph, pmap: np.ndarray) -> float:
    """Fraction of edges whose endpoints live in different partitions."""
    dst = np.repeat(np.arange(graph.num_nodes), graph.in_degrees())
    cut = pmap[graph.indices] != pmap[dst]
    return float(np.mean(cut)) if cut.size else 0.0


def _ldg_partition(graph: Graph, k: int) -> np.ndarray:
    """Weighted LDG streaming partitioner, high-degree nodes first.

    score(p) = |neighbours already in p| * (1 - load_p / capacity); a
    node weighs degree + 1, so the partitions balance work."""
    n = graph.num_nodes
    deg_in = graph.in_degrees()
    deg_out = graph.out_degrees()
    weight = (deg_in + deg_out + 1).astype(np.float64)
    capacity = weight.sum() / k * 1.05
    order = np.argsort(-(deg_in + deg_out), kind="stable")
    pmap = np.full(n, -1, dtype=np.int32)
    load = np.zeros(k, dtype=np.float64)
    indptr, indices = graph.indptr, graph.indices
    # Out-neighbour CSR, so both edge directions vote.
    dst_of_edge = np.repeat(np.arange(n), deg_in)
    out_order = np.argsort(indices, kind="stable")
    out_indices = dst_of_edge[out_order]
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(out_indptr, indices + 1, 1)
    out_indptr = np.cumsum(out_indptr)

    counts = np.zeros(k, dtype=np.float64)
    for v in order:
        counts[:] = 0.0
        for nb in indices[indptr[v]:indptr[v + 1]]:
            p = pmap[nb]
            if p >= 0:
                counts[p] += 1.0
        for nb in out_indices[out_indptr[v]:out_indptr[v + 1]]:
            p = pmap[nb]
            if p >= 0:
                counts[p] += 1.0
        score = counts * np.maximum(1.0 - load / capacity, 0.0)
        if score.max() <= 0.0:
            p_best = int(np.argmin(load))
        else:
            p_best = int(np.argmax(score))
        pmap[v] = p_best
        load[p_best] += weight[v]
    return pmap


def _library() -> ctypes.CDLL:
    lib = load_partitioner()
    lib.occ_metis_partition.restype = ctypes.c_int32
    lib.occ_metis_partition.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_uint64, ctypes.c_double, ctypes.c_void_p,
    ]
    return lib


def _multilevel_partition(graph: Graph, k: int, seed: int = 0,
                          imbalance: float = 1.05) -> np.ndarray:
    """Multilevel coarsen / partition / refine (``csrc/partition.cpp``)."""
    lib = _library()
    indptr = np.ascontiguousarray(graph.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(graph.indices, dtype=np.int64)
    out = np.empty(graph.num_nodes, dtype=np.int32)
    rc = lib.occ_metis_partition(
        graph.num_nodes, indptr.ctypes.data, indices.ctypes.data, k,
        seed + 1, imbalance, out.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"the multilevel partitioner failed (code {rc}) "
                           f"for {k} partitions of {graph.num_nodes} nodes")
    return out
