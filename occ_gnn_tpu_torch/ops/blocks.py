"""Static-shaped padded bipartite blocks — the device-side graph format.

The layout of the JAX package's ``ops/blocks.py``, as dataclasses of torch
tensors. A sampled layer is a fixed-capacity, padding-tolerant COO:

  * ``edge_src[E_cap]`` — local row in the layer's *source frame* (the
    deduplicated frontier; dst nodes occupy rows ``[0, num_dst)`` of the
    frame, newly discovered nodes follow — "dst-first" ordering, so the
    dst frame of layer L IS the src frame of layer L+1). Padding edges
    carry 0, a valid row, so a gather through them never goes out of range.
  * ``edge_dst[E_cap]`` — local dst row in ``[0, num_dst)``, sorted
    ascending; padding edges carry the sentinel ``dst_cap``, which the
    segment ops drop (the sorted segment-sum never visits them, the plain
    versions send them to a sink row).
  * self-loop edges are materialized in the COO, so a mean over the edge
    list equals the reference's mean-with-self-loop numerics.

Capacities are Python ints and fix every tensor's shape; the "how full"
counts are Python ints too, since the host sampler knows them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Block:
    """One sampled layer as a padded COO bipartite graph."""

    edge_src: torch.Tensor  # i32[E_cap]
    edge_dst: torch.Tensor  # i32[E_cap], sorted, padding == dst_cap
    num_src: int            # valid rows in the src frame
    num_dst: int            # valid rows in the dst frame
    num_edges: int          # valid edges
    src_cap: int = 0
    dst_cap: int = 0

    @property
    def edge_cap(self) -> int:
        return self.edge_src.shape[0]


@dataclasses.dataclass
class SampledBatch:
    """A full sampled minibatch for the single-chip path.

    ``blocks`` are ordered innermost-first (model consumption order): the
    src frame of ``blocks[0]`` is the deepest frontier, whose global node
    ids are ``input_nodes``; the dst frame of ``blocks[-1]`` are the batch
    target nodes, labeled by ``labels`` (padding label == -1 is masked out
    of the loss).
    """

    blocks: list[Block]
    input_nodes: torch.Tensor  # i32[F0_cap] global ids, padding == -1
    labels: torch.Tensor       # i32[T_cap], padding == -1

    @property
    def num_layers(self) -> int:
        return len(self.blocks)


def pad_to(a: np.ndarray, cap: int, fill) -> np.ndarray:
    """Host-side: pad 1-D array to capacity with fill; truncation is an error."""
    if a.shape[0] > cap:
        raise ValueError(
            f"capacity overflow: need {a.shape[0]}, cap {cap} — raise the "
            f"capacity config (static shapes are chosen up front)"
        )
    out = np.full((cap,), fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def block_from_numpy(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    num_src: int,
    num_dst: int,
    edge_cap: int,
    dst_cap: int,
    src_cap: int,
    device: torch.device | str,
) -> Block:
    """Pack host COO (already deduplicated/localized) into a padded Block
    on ``device``."""
    order = np.argsort(edge_dst, kind="stable")
    edge_src = edge_src[order].astype(np.int32)
    edge_dst = edge_dst[order].astype(np.int32)
    return Block(
        edge_src=torch.from_numpy(pad_to(edge_src, edge_cap, 0)).to(device),
        edge_dst=torch.from_numpy(
            pad_to(edge_dst, edge_cap, dst_cap)).to(device),
        num_src=int(num_src),
        num_dst=int(num_dst),
        num_edges=int(edge_src.shape[0]),
        src_cap=src_cap,
        dst_cap=dst_cap,
    )
