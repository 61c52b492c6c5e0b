"""The judge of a step's sample, and the computation graph it hands the
reference.

The port's samples are outputs of the timed path: the split sampler's
layers (the C++ service's and the device-synthesised layer 0) and
quiver's device-drawn frontiers. Each is judged against the benchmark's
own graph (``graph.GraphData``), and every breach is counted as a
violation:

- split, each layer: every node's slots hold the node itself once and
  ``min(deg, K)`` more, each an in-neighbour; where ``deg <= K`` they are
  its whole adjacency; a layer's nodes are distinct; each slot of a layer
  above the first is a node of the layer below; the last layer's nodes
  are the batch: distinct training nodes, with their graph labels.
- quiver: each frontier begins with the one before it; each draw is an
  in-neighbour of its node, or the node itself where it has none; the
  first frontier is the batch the benchmark handed the port.

A ``Refs`` is what the reference computes over: for each layer, innermost
first, ``self_ref [n]`` and ``slot_ref [n, S]`` (-1 for an empty slot),
which at the first layer are node ids (rows of the feature table) and
above it rows of the layer below's output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Refs:
    layers: list[tuple[torch.Tensor, torch.Tensor]]
    targets: torch.Tensor  # int64 [B] node ids of the logits' rows


class GraphIndex:
    """The graph's CSR and its sorted edge keys ``dst * N + src`` on a
    device, for membership tests."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, device):
        self.n = indptr.shape[0] - 1
        self.indptr = torch.from_numpy(indptr).to(device)
        self.indices = torch.from_numpy(indices).to(device)
        deg = self.indptr[1:] - self.indptr[:-1]
        dst = torch.repeat_interleave(
            torch.arange(self.n, device=device), deg)
        self.keys = dst * self.n + self.indices
        del dst
        if self.keys.numel() > 1 and not bool(
                (self.keys[1:] >= self.keys[:-1]).all()):
            self.keys = torch.sort(self.keys).values

    def degree(self, nodes: torch.Tensor) -> torch.Tensor:
        return self.indptr[nodes + 1] - self.indptr[nodes]

    def is_edge(self, dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        """Whether ``src`` is an in-neighbour of ``dst``, elementwise."""
        if self.keys.numel() == 0:
            return torch.zeros_like(dst, dtype=torch.bool)
        q = dst * self.n + src
        pos = torch.searchsorted(self.keys, q).clamp_(
            max=self.keys.numel() - 1)
        return self.keys[pos] == q


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum())


def _layer_violations(gi: GraphIndex, nodes: torch.Tensor,
                      slots: torch.Tensor, fanout: int) -> dict:
    """One split layer's breaches, by kind."""
    out = {}
    valid = slots >= 0
    in_range = (nodes >= 0) & (nodes < gi.n)
    out["node_out_of_range"] = _count(~in_range)
    out["slot_out_of_range"] = _count(valid & (slots >= gi.n))
    nodes = nodes.clamp(0, gi.n - 1)
    safe = torch.where(valid, slots, 0).clamp_(max=gi.n - 1)
    is_self = valid & (safe == nodes[:, None])
    out["self_slots_not_one"] = _count(is_self.sum(1) != 1)
    other = valid & ~is_self
    member = gi.is_edge(nodes[:, None].expand_as(safe), safe)
    out["slot_not_a_neighbour"] = _count(other & ~member)
    deg = gi.degree(nodes)
    out["slot_count"] = _count(other.sum(1) != deg.clamp(max=fanout))
    out["repeated_nodes"] = nodes.numel() - torch.unique(nodes).numel()
    small = deg <= fanout
    if bool(small.any()) and fanout > 0:
        v = nodes[small]
        k = torch.arange(fanout, device=v.device)
        d = deg[small]
        pos = (gi.indptr[v][:, None] + k).clamp_(max=max(
            gi.indices.numel() - 1, 0))
        big = torch.iinfo(torch.int64).max
        want = torch.where(k < d[:, None], gi.indices[pos], big)
        got = torch.where(other[small], safe[small], big)
        got = torch.sort(got, dim=1).values[:, :fanout]
        if got.shape[1] < fanout:
            got = torch.nn.functional.pad(got, (0, fanout - got.shape[1]),
                                          value=big)
        want = torch.sort(want, dim=1).values
        out["not_whole_adjacency"] = _count((got != want).any(1))
    return out


def judge_split(gi: GraphIndex, layers, labels: torch.Tensor,
                fanouts: list[int], batch_size: int,
                train_mask: torch.Tensor, graph_labels: torch.Tensor):
    """``layers`` innermost first: ``(nodes [n] int64, slots [n, K + 1]
    int64, -1 empty)`` in global ids, ``labels [n_last]`` the port's
    labels of the last layer's nodes, ``fanouts`` outermost first (the
    port's order). Returns ``(violations by kind, Refs)``."""
    device = gi.indptr.device
    found: dict = {}

    def add(kind, v):
        found[kind] = found.get(kind, 0) + int(v)

    lut_prev = None
    refs = []
    depth = len(layers)
    for i, (nodes, slots) in enumerate(layers):
        nodes, slots = nodes.to(device), slots.to(device)
        for kind, v in _layer_violations(gi, nodes, slots,
                                         fanouts[depth - 1 - i]).items():
            add(kind, v)
        if lut_prev is None:
            self_ref = nodes.clamp(0, gi.n - 1)
            slot_ref = torch.where(slots >= 0, slots.clamp(0, gi.n - 1), -1)
        else:
            self_ref = lut_prev[nodes.clamp(0, gi.n - 1)]
            slot_ref = torch.where(slots >= 0,
                                   lut_prev[slots.clamp(0, gi.n - 1)], -1)
            add("node_not_below", (self_ref < 0).sum())
            add("slot_not_below", ((slots >= 0) & (slot_ref < 0)).sum())
            self_ref = self_ref.clamp(min=0)
            slot_ref = torch.where(slot_ref < 0, -1, slot_ref)
        refs.append((self_ref, slot_ref))
        lut_prev = torch.full((gi.n,), -1, dtype=torch.int64, device=device)
        lut_prev[nodes.clamp(0, gi.n - 1)] = torch.arange(
            nodes.numel(), device=device)
    targets = layers[-1][0].to(device).clamp(0, gi.n - 1)
    add("batch_size", abs(targets.numel() - batch_size))
    add("target_not_training", (~train_mask[targets]).sum())
    labels = labels.to(device)
    add("label", (labels.long() != graph_labels[targets].long()).sum())
    return found, Refs(refs, targets)


def judge_quiver(gi: GraphIndex, frontiers, targets: torch.Tensor,
                 fanouts: list[int]):
    """``frontiers`` outermost first, as the port draws them
    (``frontiers[l + 1] = cat(frontiers[l], draws.flatten())``);
    ``targets`` the batch the benchmark handed the port; ``fanouts``
    outermost first. Returns ``(violations by kind, Refs)``."""
    device = gi.indptr.device
    f = [t.to(device).long() for t in frontiers]
    found = {"frontier_count": abs(len(f) - len(fanouts) - 1)}
    targets = targets.to(device).long()
    found["targets"] = int(f[0].numel() != targets.numel()) or _count(
        f[0] != targets)
    draws = []
    for lvl, K in enumerate(fanouts):
        n = f[lvl].numel()
        if f[lvl + 1].numel() != n * (1 + K):
            found["frontier_size"] = found.get("frontier_size", 0) + 1
            return found, None
        found["prefix"] = found.get("prefix", 0) + _count(
            f[lvl + 1][:n] != f[lvl])
        d = f[lvl + 1][n:].view(n, K)
        bad = (d < 0) | (d >= gi.n)
        found["draw_out_of_range"] = found.get(
            "draw_out_of_range", 0) + _count(bad)
        d = d.clamp(0, gi.n - 1)
        node = f[lvl].clamp(0, gi.n - 1)[:, None].expand_as(d)
        deg = gi.degree(f[lvl].clamp(0, gi.n - 1))[:, None]
        ok = torch.where(deg > 0, gi.is_edge(node, d), d == node)
        found["draw_not_a_neighbour"] = found.get(
            "draw_not_a_neighbour", 0) + _count(~ok)
        draws.append(d)
    layers = []
    depth = len(fanouts)
    for i in range(depth):
        m = depth - 1 - i  # the hop this layer consumes
        n, K = f[m].numel(), fanouts[m]
        if i == 0:
            self_ref = f[m].clamp(0, gi.n - 1)
            slot_ref = torch.cat([self_ref[:, None], draws[m]], 1)
        else:
            self_ref = torch.arange(n, device=device)
            slot_ref = torch.cat([self_ref[:, None], n + self_ref[:, None] * K
                                  + torch.arange(K, device=device)], 1)
        layers.append((self_ref, slot_ref))
    return found, Refs(layers, targets)
