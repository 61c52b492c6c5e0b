"""Host-side fanout neighbor sampling -> padded Blocks (single-chip path).

The numpy code of the JAX package's ``sampling/neighbor.py``, unchanged,
so one seed gives the same batches in both packages; only the packing
into torch tensors on a device is new.

Sampling semantics follow the reference: per seed node take all
in-neighbors when degree <= fanout, else draw ``fanout`` uniformly *with
replacement* (the C++ slicer's ``rand % deg``), and append a self-loop
edge for every seed. Frontier deduplication uses first-occurrence order
with the dst nodes first, so each layer's dst frame is a prefix of the
next layer's src frame ("dst-first" frames — see ``ops.blocks``).
"""

from __future__ import annotations

import numpy as np
import torch

from occ_gnn_tpu_torch.data.graph import Graph
from occ_gnn_tpu_torch.ops.blocks import SampledBatch, block_from_numpy, pad_to


def plan_capacities(
    batch_size: int,
    fanouts: list[int],
    num_nodes: int,
    safety: float = 1.0,
    num_edges: int | None = None,
) -> dict:
    """Static padding budget per layer.

    ``frame_caps[l]`` is the src-frame capacity of (innermost-first) layer l;
    ``edge_caps[l]`` the edge capacity. Worst case each frontier node fans
    out to ``fanout`` new nodes plus itself; everything is clipped at
    ``num_nodes`` since frames are deduplicated.
    """
    # Walk outermost (targets) -> innermost to size frontiers. A negative
    # fanout means full neighborhood: the frontier is bounded only by the
    # node count.
    sizes = [batch_size]
    for f in fanouts:
        nxt = sizes[-1] * (f + 1) if f >= 0 else num_nodes
        sizes.append(min(int(nxt * safety), num_nodes))
    # sizes[0]=targets ... sizes[L]=deepest frontier. Frames innermost-first.
    frame_caps = list(reversed(sizes))
    edge_caps = []
    full_edge_bound = (num_edges if num_edges is not None
                       else num_nodes * 32) + num_nodes
    for l, f in enumerate(reversed(fanouts)):
        # innermost-first block l: dst frame = frame_caps[l + 1]
        dst = frame_caps[l + 1]
        edge_caps.append(dst * (f + 1) if f >= 0
                         else min(full_edge_bound, dst * num_nodes))
    return {"frame_caps": frame_caps, "edge_caps": edge_caps}


def measure_capacities(
    graph: Graph,
    train_nodes: np.ndarray,
    fanouts: list[int],
    batch_size: int,
    num_batches: int = 3,
    margin: float = 1.6,
    seed: int = 0,
    replace: bool = True,
) -> dict:
    """Empirical padding budgets: sample a few batches, record the
    per-layer frame/edge maxima, return them with headroom (rounded up to
    multiples of 128 for edges, 8 for frames).

    The worst-case ``plan_capacities`` pads the deepest frame to
    batch * prod(fanout+1), which at products scale is far larger than the
    real (deduplicated) frontier; measured budgets keep the padded feature
    transfer proportional to the work. A later batch above budget still
    raises the overflow error of ``pad_to``."""
    rng = np.random.default_rng(seed)
    nodes = np.asarray(train_nodes, dtype=np.int64)
    L = len(fanouts)
    max_frame = [0] * (L + 1)   # outermost-first while measuring
    max_edge = [0] * L
    for b in range(num_batches):
        lo = b * batch_size
        batch = nodes[lo : lo + batch_size]
        if batch.size == 0:
            break
        frontier = np.unique(batch)
        max_frame[0] = max(max_frame[0], frontier.shape[0])
        for l, fanout in enumerate(fanouts):
            e_dst, e_src_global = sample_layer_edges(
                graph, frontier, fanout, rng, replace=replace
            )
            frontier, _, _ = dedup_first_occurrence(frontier, e_src_global)
            max_edge[l] = max(max_edge[l], e_dst.shape[0])
            max_frame[l + 1] = max(max_frame[l + 1], frontier.shape[0])

    def up(v, m):
        return int(-(-int(v * margin) // m) * m)

    return {
        "frame_caps": [up(v, 8) for v in reversed(max_frame)],
        "edge_caps": [up(v, 128) for v in reversed(max_edge)],
    }


def sample_layer_edges(
    graph: Graph, frontier: np.ndarray, fanout: int,
    rng: np.random.Generator, replace: bool = True
):
    """Sample in-edges for each frontier node; returns (dst_local, src_global).

    Edge order is dst-major: for each frontier node, a self-loop edge first,
    then its sampled neighbors — all of them when degree <= fanout, else
    ``fanout`` draws. ``replace=True`` matches the reference's C++ slicer;
    ``replace=False`` matches DGL ``sample_neighbors`` semantics.
    """
    indptr, indices = graph.indptr, graph.indices
    n = frontier.shape[0]
    deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
    offs = indptr[frontier]
    if fanout < 0:  # full neighborhood (reference fanout=-1)
        fanout = int(deg.max()) if n else 0
    take = np.minimum(deg, fanout)
    counts = take + 1  # +1 for the self loop
    total = int(counts.sum())
    starts = np.cumsum(counts) - counts

    e_dst = np.repeat(np.arange(n, dtype=np.int64), counts)
    pos = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    e_src = np.empty(total, dtype=np.int64)
    e_src[starts] = frontier  # self loop at position 0 of each group

    tail = pos > 0
    node = e_dst[tail]
    j = pos[tail] - 1
    small_edge = deg[node] <= fanout
    # take-all nodes: CSR order
    e_src_tail = np.empty(node.shape[0], dtype=np.int64)
    e_src_tail[small_edge] = indices[offs[node[small_edge]] + j[small_edge]]
    lg = ~small_edge
    if lg.any():
        if replace:
            draws = rng.integers(0, deg[node[lg]])
            e_src_tail[lg] = indices[offs[node[lg]] + draws]
        else:
            # Without replacement per dst, vectorized: one random key per
            # candidate neighbor of every large-degree node, sort keys
            # within each node's segment, take the first ``fanout``.
            lg_nodes = np.unique(node[lg])
            degs = deg[lg_nodes]
            tot = int(degs.sum())
            seg = np.repeat(np.arange(lg_nodes.shape[0]), degs)
            seg_starts = np.cumsum(degs) - degs
            within = np.arange(tot, dtype=np.int64) - np.repeat(seg_starts, degs)
            order = np.lexsort((rng.random(tot), seg))
            # first ``fanout`` entries of each segment, in key order
            sel = within[order[(seg_starts[:, None]
                                + np.arange(fanout)[None, :])]]
            row_seg = np.searchsorted(lg_nodes, node[lg])
            e_src_tail[lg] = indices[offs[node[lg]] + sel[row_seg, j[lg]]]
    e_src[tail] = e_src_tail
    return e_dst, e_src


def dedup_first_occurrence(prefix: np.ndarray, extra: np.ndarray):
    """Frame = prefix nodes followed by unseen nodes of ``extra`` in first-
    occurrence order. Returns (frame, uniq, rank) where rank maps any value
    of ``extra`` to its frame row via searchsorted on the sorted uniques."""
    allv = np.concatenate([prefix, extra])
    uniq, first_idx = np.unique(allv, return_index=True)
    order = np.argsort(first_idx, kind="stable")
    frame = uniq[order]
    rank = np.empty(uniq.shape[0], dtype=np.int64)
    rank[order] = np.arange(uniq.shape[0])
    return frame, uniq, rank


class NeighborSampler:
    """Iterator over padded SampledBatch minibatches on ``device``.

    Shuffles training nodes per epoch, yields one padded batch per
    ``batch_size`` seeds (the reference Sampler's iterator protocol).
    """

    def __init__(
        self,
        graph: Graph,
        train_nodes: np.ndarray,
        fanouts: list[int],
        batch_size: int,
        capacities: dict | None = None,
        seed: int = 0,
        drop_last: bool = False,
        replace: bool = True,
        *,
        device: torch.device | str,
    ):
        self.graph = graph
        self.train_nodes = np.asarray(train_nodes, dtype=np.int64)
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.replace = replace
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.caps = capacities or plan_capacities(
            batch_size, self.fanouts, graph.num_nodes,
            num_edges=graph.num_edges,
        )
        self.drop_last = drop_last

    def __iter__(self):
        for batch in self.seed_batches():
            yield self.sample_batch(batch)

    def seed_batches(self):
        """One epoch's shuffled seed-node batches, before sampling; the
        same draws as iterating the sampler."""
        order = self.rng.permutation(self.train_nodes.shape[0])
        nodes = self.train_nodes[order]
        for i in range(0, nodes.shape[0], self.batch_size):
            batch = nodes[i : i + self.batch_size]
            if self.drop_last and batch.shape[0] < self.batch_size:
                break
            yield batch

    def __len__(self):
        n = self.train_nodes.shape[0]
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def sample_batch(self, batch: np.ndarray) -> SampledBatch:
        g = self.graph
        frame_caps = self.caps["frame_caps"]
        edge_caps = self.caps["edge_caps"]
        num_layers = len(self.fanouts)

        frontier = np.unique(np.asarray(batch, dtype=np.int64))
        frames = [frontier]
        raw_blocks = []  # outermost-first (dst_local, src_local, frame sizes)
        for fanout in self.fanouts:
            e_dst, e_src_global = sample_layer_edges(
                g, frontier, fanout, self.rng, replace=self.replace
            )
            new_frame, uniq, rank = dedup_first_occurrence(frontier, e_src_global)
            e_src = rank[np.searchsorted(uniq, e_src_global)]
            raw_blocks.append((e_dst, e_src, frontier.shape[0], new_frame.shape[0]))
            frontier = new_frame
            frames.append(frontier)

        # Pack innermost-first for the model.
        blocks = []
        for l in range(num_layers):
            mi = num_layers - 1 - l  # model layer l consumes sampled layer mi
            e_dst, e_src, n_dst, n_src = raw_blocks[mi]
            blocks.append(
                block_from_numpy(
                    e_src,
                    e_dst,
                    num_src=n_src,
                    num_dst=n_dst,
                    edge_cap=edge_caps[l],
                    dst_cap=frame_caps[l + 1],
                    src_cap=frame_caps[l],
                    device=self.device,
                )
            )
        input_nodes = pad_to(frames[-1].astype(np.int32), frame_caps[0], -1)
        labels = pad_to(
            g.labels[frames[0]].astype(np.int32), frame_caps[-1], -1
        )
        return SampledBatch(
            blocks=blocks,
            input_nodes=torch.from_numpy(input_nodes).to(self.device),
            labels=torch.from_numpy(labels).to(self.device),
        )
