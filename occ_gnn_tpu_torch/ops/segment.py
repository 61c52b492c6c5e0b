"""Segment reductions and sparse message passing over padded blocks.

The JAX package's ``ops/segment.py`` for the ops the SAGE slice runs.
``spmm_mean`` is the reference's ``update_all(copy_u, mean)``; ``spmm_sum``
sends 2-D messages through the sorted segment-sum kernel, as the JAX
``spmm_sum`` sends them to its Pallas kernel.

Padding convention: segment ids equal to ``num_segments`` are dropped, so
padded edges need no masks. ``segment_max``, ``segment_softmax`` and
``spmm_sym`` come with the GCN/GAT slice (ROADMAP.md, queue 1, item 9).
"""

from __future__ import annotations

import torch

from occ_gnn_tpu_torch.ops.segment_sum_sorted import (
    segment_sum_sorted,
    segment_sum_sorted_reference,
)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of ``data`` rows per segment, for ids in any order; ids equal to
    ``num_segments`` are dropped."""
    return segment_sum_sorted_reference(data, segment_ids, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(segment_ids.shape[:1], dtype=data.dtype,
                      device=data.device)
    count = segment_sum(ones, segment_ids, num_segments).clamp(min=1.0)
    return total / count.reshape((num_segments,) + (1,) * (data.dim() - 1))


def spmm_sum(x_src: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: torch.Tensor, num_dst: int,
             edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """sum_{(u -> v) in E} w_uv * x[u] per dst v, over a dst-sorted COO.

    Padding edges have ``edge_src == 0``, a valid row: the gather stays in
    range (torch raises on an out-of-range index where JAX clamps), and the
    segment-sum drops their messages by ``edge_dst``."""
    msgs = x_src[edge_src]
    if edge_weight is not None:
        msgs = msgs * edge_weight.reshape((-1,) + (1,) * (msgs.dim() - 1))
    if msgs.dim() == 2:
        return segment_sum_sorted(msgs, edge_dst, num_dst)
    return segment_sum(msgs, edge_dst, num_dst)


def spmm_mean(x_src: torch.Tensor, edge_src: torch.Tensor,
              edge_dst: torch.Tensor, num_dst: int) -> torch.Tensor:
    """Mean over valid in-edges; zero-degree rows give 0. Accumulates in f32
    whatever the input dtype."""
    total = spmm_sum(x_src.float(), edge_src, edge_dst, num_dst)
    ones = torch.ones(edge_dst.shape[:1], dtype=torch.float32,
                      device=edge_dst.device)
    count = segment_sum(ones, edge_dst, num_dst)
    return total / count.clamp(min=1.0)[:, None]
