"""Segment reductions and sparse message passing over padded blocks.

The JAX package's ``ops/segment.py``. ``spmm_mean`` is the reference's
``update_all(copy_u, mean)``; ``segment_softmax`` followed by a sum of
``score * value`` is its ``attention_gather`` (the GAT models fuse the two
into one sum, ``models.gat.coo_attention``). ``spmm_sum`` sends 2-D rows
through the fused gather and sorted segment-sum kernel
(``gather_segment_sum``), as the JAX ``spmm_sum`` sends its messages to
its Pallas kernel, and so do ``spmm_mean`` and ``spmm_sym`` (GCN
``norm="sym"``, with its edge weights); the softmax denominators go
through the messages' entry, ``segment_sum_sorted``.

Padding convention: segment ids equal to ``num_segments`` are dropped, so
padded edges need no masks. ``segment_softmax`` and ``spmm_sum`` take a
COO sorted by dst, as every block of the port is (``ops/blocks.py``).
"""

from __future__ import annotations

import torch

from occ_gnn_tpu_torch.ops.segment_sum_sorted import (
    gather_segment_sum,
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
    segment-sum drops them by ``edge_dst``. 2-D rows (f32 or bf16) go to
    ``gather_segment_sum``, which reads ``x[u]`` inside the kernel and sums
    in f32, so the result is f32 whatever the frame's type. Rows of higher
    rank take an ``index_select`` and the plain segment-sum."""
    if x_src.dim() == 2:
        return gather_segment_sum(x_src, edge_src, edge_dst, num_dst,
                                  edge_weight)
    msgs = x_src.index_select(0, edge_src)
    if edge_weight is not None:
        msgs = msgs * edge_weight.reshape((-1,) + (1,) * (msgs.dim() - 1))
    return segment_sum(msgs, edge_dst, num_dst)


def spmm_sym(x_src: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: torch.Tensor, num_dst: int,
             num_src: int) -> torch.Tensor:
    """Kipf-Welling symmetric normalization over the sampled block (JAX
    ``ops/segment.py:113-136``): ``out[v] = sum_{(u -> v)} x[u] /
    sqrt(d_out(u) * d_in(v))``, degrees counted within the block (the
    sampler's self loops included). The degrees are plain segment sums
    (padding edges add 0 to ``deg_out`` and land in ``deg_in``'s sink
    row); the weighted sum goes through ``spmm_sum``, so through the fused
    gather kernel on a CUDA tensor, which reads the frame in its own type
    and sums in f32."""
    valid = (edge_dst < num_dst).float()
    deg_in = segment_sum(valid, edge_dst, num_dst)
    deg_out = segment_sum(valid, edge_src, num_src)
    safe_dst = edge_dst.clamp(max=num_dst - 1)
    coeff = valid * torch.rsqrt(
        deg_out.index_select(0, edge_src).clamp(min=1.0)
        * deg_in.index_select(0, safe_dst).clamp(min=1.0))
    return spmm_sum(x_src, edge_src, edge_dst, num_dst, edge_weight=coeff)


def spmm_mean(x_src: torch.Tensor, edge_src: torch.Tensor,
              edge_dst: torch.Tensor, num_dst: int) -> torch.Tensor:
    """Mean over valid in-edges; zero-degree rows give 0. Accumulates in f32
    whatever the input dtype (the fused kernel reads a bf16 frame as it
    is)."""
    total = spmm_sum(x_src, edge_src, edge_dst, num_dst)
    ones = torch.ones(edge_dst.shape[:1], dtype=torch.float32,
                      device=edge_dst.device)
    count = segment_sum(ones, edge_dst, num_dst)
    return total / count.clamp(min=1.0)[:, None]
