"""Segment reductions and sparse message passing over padded blocks.

The JAX package's ``ops/segment.py``. ``spmm_mean`` is the reference's
``update_all(copy_u, mean)``; ``segment_softmax`` followed by a sum of
``score * value`` is its ``attention_gather`` (the GAT models fuse the two
into one sum, ``models.gat.coo_attention``). ``spmm_sum`` sends 2-D
messages through the sorted segment-sum kernel, as the JAX ``spmm_sum``
sends them to its Pallas kernel, and so do the softmax denominators.

Padding convention: segment ids equal to ``num_segments`` are dropped, so
padded edges need no masks. ``segment_softmax`` and ``spmm_sum`` take a
COO sorted by dst, as every block of the port is (``ops/blocks.py``).
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


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of ``data`` rows (``[E]`` or ``[E, ...]``) per segment, for ids in
    any order. An empty segment is ``-inf``, as in ``jax.ops.segment_max``;
    ids equal to ``num_segments`` land in a sink row that is sliced off."""
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]),
                        float("-inf"))
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    out.scatter_reduce_(0, ids.expand_as(data), data, "amax",
                        include_self=True)
    return out[:num_segments]


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of f32 ``scores`` (``[E]`` or ``[E, heads]``) within each
    segment of a dst-sorted COO (GAT attention); padding rows come back 0.

    The max is a shift the softmax does not depend on, so it is detached,
    as flash attention does (its gradient is zero in exact arithmetic).
    Padding scores are masked to -inf before the exp, so no inf reaches the
    backward. The denominators go through the sorted segment-sum."""
    valid = (segment_ids < num_segments).reshape(
        (-1,) + (1,) * (scores.dim() - 1))
    smax = segment_max(scores.detach(), segment_ids, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    safe_ids = segment_ids.clamp(max=num_segments - 1)
    shifted = (scores - smax.index_select(0, safe_ids)).masked_fill(
        ~valid, float("-inf"))
    expv = torch.exp(shifted)
    flat = expv.reshape(expv.shape[0], -1)
    denom = segment_sum_sorted(flat, segment_ids, num_segments)
    denom = denom.reshape((num_segments,) + tuple(scores.shape[1:]))
    return expv / denom.clamp(min=1e-16).index_select(0, safe_ids)


def spmm_sum(x_src: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: torch.Tensor, num_dst: int,
             edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """sum_{(u -> v) in E} w_uv * x[u] per dst v, over a dst-sorted COO.

    Padding edges have ``edge_src == 0``, a valid row: the gather stays in
    range (torch raises on an out-of-range index where JAX clamps), and the
    segment-sum drops their messages by ``edge_dst``. The gather is an
    ``index_select``, whose backward is an ``index_add_``."""
    msgs = x_src.index_select(0, edge_src)
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
