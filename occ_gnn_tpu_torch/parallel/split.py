"""Split-parallel batch structures, the per-partition layer ops and the
boundary shuffle.

The JAX package's ``parallel/split.py`` as torch ops. The layout is the
same. The JAX step holds all P partitions in one SPMD program; a process
of the port holds L of them, ``[lo, hi)`` (``parallel.dist``), so a
batch's leading axis is L (this process's rows), and the P-slot axes of
``push_idx`` / ``recv_idx`` stay P wide:

  edge_src[L, E_cap]   local src row in partition p's input frame
  edge_dst[L, E_cap]   local dst row in p's dst frame, sorted (pad=dst_cap)
  push_idx[L, P, S_cap] rows of p's dst frame to send to q (pad=-1)
  recv_idx[L, P, S_cap] where partials arriving from r land (pad=dst_cap)
  owned_idx[L, O_cap]  rows of p's dst frame owned by p (pad=-1)
  owned_deg[L, O_cap]  total sampled in-degree (pad=1)
  self_idx[L, O_cap]   row of p's input frame holding the owned node's own
                       feature
  nbr_idx[L, K_cap, D_cap] dense neighbour matrix; padding points at the
                       frame's reserved zero row ``src_cap - 1``
  plan_offsets[L, src_cap], plan_slots[L, K_cap * D_cap],
  plan_long[L, long_capacity(K_cap * D_cap)], plan_num_long[L]
                       nbr_idx's transpose (``ops.dense_gather_sum.
                       ScatterPlan``), which the per-slot scatter of
                       split GAT's backward reads; only on split GAT's
                       training batches, and only past layer 0

The owned output rows of layer l are layer l+1's input frame rows, so
layers chain with no gather. Each partition aggregates partial sums and
``shuffle_merge`` sends the boundary partials to the owner of each dst:
the send buffer ``[L, P, S_cap, ...]`` of a process's partitions is
regrouped by destination process and crosses in one all-to-all over the
process group when there are several processes, and in none when one
process holds every partition (then the exchange is a transposition in
device memory). With one partition they are the whole sums and nothing
is shuffled. Distributed GAT adds two shuffles a layer on the same index
tensors: ``reverse_shuffle`` sends each owned dst's attention term to
the partitions that hold its edges, and ``shuffle_softmax_merge`` merges
the partitions' streaming-softmax partials at the owner. Each of the
three is an autograd Function whose backward is one more exchange;
``shuffle_counts()`` counts them per partition, and
``collective_count()`` the all-to-alls this process issued.

Index semantics. JAX gathers clamp out-of-range indices and its scatters
drop them; torch raises. Every padded index is therefore made valid
before use: ``owned_idx`` -1 and ``dst_global`` -1 read row 0 and are
masked, ``edge_dst`` padding (``dst_cap``) is dropped by the segment-sum,
``nbr_idx`` padding reads the reserved zero row, ``push_idx`` -1 reads
row 0 and is masked, and ``recv_idx`` padding (``dst_cap``) lands in a
sink row that is sliced off. Index tensors stay int32: ``index_select``
and ``index_add_`` take them as they are.

Aggregation. A COO layer goes through the fused gather and sorted
segment-sum kernel (``ops/segment_sum_sorted.gather_segment_sum``); a
dense layer through the ``dense_gather_sum`` kernel, one launch a layer
forward and one of ``dense_scatter_add`` backward
(``ops/dense_gather_sum.py``, the port's counterpart of the fusion XLA
makes of JAX ``parallel/split.py:161-197``).

Lowerings (``ops/config.py``, as JAX ``occ_gnn_tpu/ops/config.py``):
``OCC_DENSE_AGG=tiled`` runs ``local_aggregate_dense`` over dst tiles of
``DENSE_TILE`` rows (JAX ``parallel/split.py:171-190``), one kernel
launch a tile, with the same sums in the same order;
``OCC_DEVICE_SAMPLE`` picks the draws of ``synthesize_device_innermost``
(JAX ``split.py:200-287``): ``randint``, ``bitsf32``, ``bitsf32_dk`` or
``window``, the last over the doubled CSR of
``parallel/model.make_device_csr``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from occ_gnn_tpu_torch.ops.config import dense_agg_impl, device_sample_impl
from occ_gnn_tpu_torch.ops.dense_gather_sum import (
    ScatterPlan,
    dense_gather_sum,
)
from occ_gnn_tpu_torch.ops.device_sample import (
    InnermostFields,
    innermost_fields,
    synthesize_innermost,
)
from occ_gnn_tpu_torch.ops.segment_sum_sorted import gather_segment_sum

# Dst rows a tile of the ``tiled`` dense aggregation (JAX ``_DENSE_TILE``).
DENSE_TILE = 8192
# Sentinel words after the doubled adjacency of the ``window`` sampler
# (``parallel/model.make_device_csr``): a K-slice that starts in the last
# span never leaves the array, which bounds the fanout of that sampler.
WINDOW_PAD = 1024

_TENSOR_FIELDS = ("edge_src", "edge_dst", "push_idx", "recv_idx",
                  "owned_idx", "owned_deg", "self_idx", "owned_mask",
                  "num_owned", "nbr_idx", "plan_offsets", "plan_slots",
                  "plan_long", "plan_num_long", "dst_global")


@dataclasses.dataclass
class SplitLayer:
    """One sliced layer. ``edge_src``/``edge_dst`` are None when the layer
    ships only the dense ``nbr_idx``; a device-sampled layer carries only
    ``dst_global`` (global ids of its dst frame, pad -1), and
    ``synthesize_device_innermost`` builds the rest from a resident CSR."""

    edge_src: torch.Tensor | None = None   # i32[P, E_cap]
    edge_dst: torch.Tensor | None = None   # i32[P, E_cap], pad=dst_cap
    push_idx: torch.Tensor | None = None   # i32[P, P, S_cap], pad=-1
    recv_idx: torch.Tensor | None = None   # i32[P, P, S_cap], pad=dst_cap
    owned_idx: torch.Tensor | None = None  # i32[P, O_cap], pad=-1
    owned_deg: torch.Tensor | None = None  # f32[P, O_cap], pad=1
    self_idx: torch.Tensor | None = None   # i32[P, O_cap], pad=0
    owned_mask: torch.Tensor | None = None  # bool[P, O_cap]
    num_owned: torch.Tensor | None = None  # i32[P]
    nbr_idx: torch.Tensor | None = None    # i32[P, K_cap, D_cap]
    # nbr_idx's ScatterPlan, when the sampler was asked for one.
    plan_offsets: torch.Tensor | None = None   # i32[P, src_cap]
    plan_slots: torch.Tensor | None = None     # i32[P, K_cap * D_cap]
    plan_long: torch.Tensor | None = None      # i32[P, long_capacity]
    plan_num_long: torch.Tensor | None = None  # i32[P]
    dst_global: torch.Tensor | None = None  # i32[P, D_cap], pad=-1
    src_cap: int = 0
    dst_cap: int = 0
    out_cap: int = 0
    fanout: int = 0

    @property
    def scatter_plan(self) -> ScatterPlan | None:
        """The plan of one partition's layer (``partition(p)``), or None
        when the batch carries none."""
        if self.plan_offsets is None:
            return None
        return ScatterPlan(self.plan_offsets, self.plan_slots,
                           self.plan_long, self.plan_num_long)

    @property
    def device_sampled(self) -> bool:
        return self.dst_global is not None and self.nbr_idx is None

    def partition(self, p: int) -> "SplitLayer":
        """The layer of partition ``p``: every tensor without its leading
        P axis (the JAX step's per-device view inside shard_map)."""
        return dataclasses.replace(self, **{
            f: getattr(self, f)[p] for f in _TENSOR_FIELDS
            if getattr(self, f) is not None})


@dataclasses.dataclass
class SplitBatch:
    """One sliced minibatch. Layers are innermost-first; layer l's
    out_cap == layer l+1's src_cap.

    ``input_nodes_host`` is a host copy of ``input_nodes``, set by the
    samplers, so the per-batch feature gather reads the ids without a
    round trip through the device."""

    layers: list[SplitLayer]
    input_nodes: torch.Tensor | None   # i32[P, F0_cap], pad=-1
    labels: torch.Tensor               # i32[P, T_cap], pad=-1
    target_nodes: torch.Tensor | None = None  # i32[P, T_cap], pad=-1
    input_nodes_host: np.ndarray | None = None

    @property
    def num_partitions(self) -> int:
        return self.labels.shape[0]


def count_layer_edges(lyr: SplitLayer, per_partition: bool = False):
    """Valid edge count of a sliced layer, from the COO when present, else
    from the dense nbr matrix (padding slots hold ``src_cap - 1``)."""
    if lyr.edge_dst is not None:
        valid = lyr.edge_dst.cpu().numpy() < lyr.dst_cap
        return valid.sum(axis=1) if per_partition else int(valid.sum())
    valid = lyr.nbr_idx.cpu().numpy() != (lyr.src_cap - 1)
    return valid.sum(axis=(1, 2)) if per_partition else int(valid.sum())


# ---------------------------------------------------------------------------
# Per-partition ops: every argument is one partition's (no leading P axis;
# P-slot axes such as push_idx's first one remain).
# ---------------------------------------------------------------------------


def local_aggregate(x: torch.Tensor, edge_src: torch.Tensor,
                    edge_dst: torch.Tensor, dst_cap: int) -> torch.Tensor:
    """Partial neighbour SUM over this partition's COO, accumulated in f32
    by the fused gather and sorted segment-sum (the Hopper kernel on a CUDA
    tensor, which reads the frame's rows in its own type). Padding edges
    are dropped by ``edge_dst == dst_cap``."""
    with record_function("local_aggregate"):
        return gather_segment_sum(x, edge_src, edge_dst, dst_cap)


def local_aggregate_dense(x: torch.Tensor, nbr_idx: torch.Tensor):
    """Partial neighbour SUM through the dense ``[K_cap, D_cap]`` neighbour
    matrix; padding slots read the frame's reserved zero row. Returns
    f32 ``[D_cap, H]``, as ``local_aggregate`` does: one launch of the
    ``dense_gather_sum`` kernel on a CUDA tensor (its backward one launch
    of ``dense_scatter_add``). Under ``OCC_DENSE_AGG=tiled`` a frame of
    more than ``DENSE_TILE`` dst rows is summed one tile at a time, one
    launch a tile; the backward is the same."""
    tile = DENSE_TILE if dense_agg_impl() == "tiled" else None
    with record_function("local_aggregate_dense"):
        return dense_gather_sum(x, nbr_idx, tile)


def aggregate(x: torch.Tensor, lyr: SplitLayer) -> torch.Tensor:
    """Partial neighbour sums of one layer: the dense gather path when the
    slicer emitted ``nbr_idx``, the COO segment-sum otherwise."""
    if lyr.nbr_idx is not None:
        return local_aggregate_dense(x, lyr.nbr_idx)
    return local_aggregate(x, lyr.edge_src, lyr.edge_dst, lyr.dst_cap)


# Exchanges of a partition, by direction, and the payload bytes a
# partition sent to the other partitions: every shuffle below counts here,
# the same whichever process holds the partition. ``collectives`` counts
# the all-to-alls this process issued (none in a run of one process).
_SHUFFLES = {"forward": 0, "backward": 0, "bytes_sent": 0}
_COLLECTIVES = [0]


def reset_shuffle_counts() -> None:
    for key in _SHUFFLES:
        _SHUFFLES[key] = 0
    _COLLECTIVES[0] = 0


def shuffle_counts() -> dict:
    return dict(_SHUFFLES)


def collective_count() -> int:
    """The all-to-alls this process issued since the last reset."""
    return _COLLECTIVES[0]


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _exchange(send: torch.Tensor, direction: str) -> torch.Tensor:
    """Move ``send [L, P, S_cap, C]`` (local partition j's rows for
    partition q) to ``recv [L, P, S_cap, C]`` (the rows partition p sent
    to local partition j). The buffer is regrouped by destination process,
    ``[W, L_src, L_dst, S_cap, C]``, crosses in one
    ``all_to_all_single`` with equal splits when there are W > 1
    processes, and is transposed into the receive layout; with one
    process the transposition is all there is. Counted under
    ``direction`` ("forward" or "backward")."""
    L, P = send.shape[:2]
    W = P // L
    rest = tuple(send.shape[2:])
    if W == 1:
        recv = send.transpose(0, 1)
    else:
        buf = send.view(L, W, L, *rest).transpose(0, 1).contiguous()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf)
        _COLLECTIVES[0] += 1
        # out[k, l, j]: what partition k * L + l sent to local partition j.
        recv = out.permute(2, 0, 1, *range(3, 3 + len(rest))).reshape(
            L, P, *rest)
    _SHUFFLES[direction] += 1
    _SHUFFLES["bytes_sent"] += (
        send.numel() // (L * P) * (P - 1) * send.element_size())
    return recv


def _check_group(push_idx: torch.Tensor, name: str,
                 *f32: torch.Tensor) -> None:
    """P == W * L: the batch's P-slot axes span every process's
    partitions."""
    L, P = push_idx.shape[:2]
    W = _world()
    if P != W * L:
        raise ValueError(f"{name}: the batch has {L} partitions of {P} in "
                         f"this process, but the run has {W} processes "
                         f"(P must be W * L)")
    for t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} moves f32 rows, got {t.dtype}")


def _flat(idx: torch.Tensor, d: int) -> torch.Tensor:
    """Rows of ``idx [L, P, S_cap]`` (each partition's own frame of ``d``
    rows) in the flat ``[L * (d + 1)]`` frames with a sink row each:
    padding, -1 (``push_idx``) or ``d`` (``recv_idx``), goes to the
    partition's sink. int64 (``index_copy_`` and ``index_fill_`` take no
    int32)."""
    L = idx.shape[0]
    base = torch.arange(L, device=idx.device, dtype=torch.int64) * (d + 1)
    rows = torch.where(idx < 0, d, idx).long()
    return (rows + base.view(L, *([1] * (idx.dim() - 1)))).reshape(-1)


def _sink_frames(rows: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """``rows [L, d, ...]`` with one row of ``fill`` appended to each
    partition's frame: ``[L, d + 1, ...]``, the target of padded
    indices."""
    L, d = rows.shape[:2]
    out = rows.new_empty((L, d + 1) + tuple(rows.shape[2:]))
    out[:, :d].copy_(rows)
    out[:, d].fill_(fill)
    return out


class _ShuffleMerge(torch.autograd.Function):
    """Forward: gather the push rows, exchange, add the received rows at
    ``recv_idx``. Backward, the transpose: the gradient passes through to
    ``neigh``, is gathered at ``recv_idx``, crosses back in the same
    exchange (its own transpose) and is added at ``push_idx``."""

    @staticmethod
    def forward(ctx, neigh, push_idx, recv_idx):
        L, d, h = neigh.shape
        push, recv = _flat(push_idx, d), _flat(recv_idx, d)
        ctx.save_for_backward(push, recv)
        ctx.slots = tuple(push_idx.shape[1:])
        frame = _sink_frames(neigh)
        flat = frame.view(-1, h)
        got = _exchange(flat.index_select(0, push).view(
            push_idx.shape + (h,)), "forward")
        flat.index_add_(0, recv, got.reshape(-1, h))
        return frame[:, :d]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        push, recv = ctx.saved_tensors
        L, d, h = grad.shape
        dneigh = _sink_frames(grad)
        flat = dneigh.view(-1, h)
        back = _exchange(flat.index_select(0, recv).view(
            (L,) + ctx.slots + (h,)), "backward")
        flat.index_add_(0, push, back.reshape(-1, h))
        return dneigh[:, :d], None, None


def shuffle_merge(neigh: torch.Tensor, push_idx: torch.Tensor,
                  recv_idx: torch.Tensor) -> torch.Tensor:
    """Send this process's boundary partial sums to their owners and add
    the partials that arrive into its own dst frames.

    ``neigh`` is f32 ``[L, dst_cap, H]``, the partial sums of the
    process's L partitions (they stay f32 under bf16 storage, as in JAX);
    ``push_idx`` / ``recv_idx`` are their ``[L, P, S_cap]`` rows. The run
    has P = W * L partitions over the W processes of the default process
    group (or one process and no group). ``shuffle_counts()`` counts the
    exchanges and the payload bytes each partition sends to the others."""
    _check_group(push_idx, "shuffle_merge", neigh)
    with record_function("shuffle_merge"):
        return _ShuffleMerge.apply(neigh, push_idx, recv_idx)


class _ReverseShuffle(torch.autograd.Function):
    """Forward: each owner gathers its rows at ``recv_idx`` (padding reads
    the zero sink row), exchange, and each edge holder writes what it
    received at ``push_idx`` of a copy of its frame. Backward, the
    transpose of that write: the written rows take no gradient, the
    gradient at ``push_idx`` crosses back in the same exchange and is
    added at the owner's ``recv_idx`` rows."""

    @staticmethod
    def forward(ctx, frame, push_idx, recv_idx):
        L, d, c = frame.shape
        push, recv = _flat(push_idx, d), _flat(recv_idx, d)
        ctx.save_for_backward(push, recv)
        ctx.slots = tuple(push_idx.shape[1:])
        out = _sink_frames(frame)
        flat = out.view(-1, c)
        got = _exchange(flat.index_select(0, recv).view(
            recv_idx.shape + (c,)), "forward")
        flat.index_copy_(0, push, got.reshape(-1, c))
        return out[:, :d]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        push, recv = ctx.saved_tensors
        L, d, c = grad.shape
        dframe = _sink_frames(grad)
        flat = dframe.view(-1, c)
        back = _exchange(flat.index_select(0, push).view(
            (L,) + ctx.slots + (c,)), "backward")
        flat.index_fill_(0, push, 0.0)
        flat.index_add_(0, recv, back.reshape(-1, c))
        return dframe[:, :d], None, None


def reverse_shuffle(frame: torch.Tensor, push_idx: torch.Tensor,
                    recv_idx: torch.Tensor) -> torch.Tensor:
    """Owner -> edge-holder shuffle, the reverse of ``shuffle_merge`` on
    the same index tensors: owner q sends the rows of its f32 dst frame
    (``frame [L, dst_cap, C]``, this process's partitions) listed in
    ``recv_idx[q, p]`` to partition p, which writes them at
    ``push_idx[p, q]`` of its own frame. Distributed GAT sends each dst's
    attention term to the partitions that hold its edges."""
    _check_group(push_idx, "reverse_shuffle", frame)
    with record_function("reverse_shuffle"):
        return _ReverseShuffle.apply(frame, push_idx, recv_idx)


def _merge_scales(m_loc, r_m, recv):
    """The streaming-softmax rescaling at the owner: ``m* = max`` of the
    local and received maxima (padding is -inf and lands in the sink),
    then ``exp(m - m*)`` for the local partials and for each received one,
    0 where a max is -inf (a row or partial with no edge). ``m_loc [L,
    d, K]``, ``r_m [n, K]`` landing at the flat rows ``recv``."""
    L, d, k = m_loc.shape
    m_star = _sink_frames(m_loc, float("-inf")).view(-1, k)
    m_star.scatter_reduce_(0, recv[:, None].expand(-1, k), r_m, "amax",
                           include_self=True)
    safe = torch.where(torch.isfinite(m_star), m_star, 0.0)
    scale_loc = torch.where(torch.isfinite(m_loc),
                            torch.exp(m_loc - safe.view(L, d + 1, k)[:, :d]),
                            0.0)
    r_scale = torch.where(torch.isfinite(r_m), torch.exp(r_m - safe[recv]),
                          0.0)
    return scale_loc, r_scale


class _ShuffleSoftmaxMerge(torch.autograd.Function):
    """Forward: one exchange of the pushed ``(m, s, v)`` rows (padding
    sends m = -inf and zero sums), then the streaming-softmax merge at the
    owner. The maxima are shifts the layer's output does not depend on, so
    they take no gradient (as in flash attention); the backward carries
    ``(s, v)`` only: scaled by ``exp(m_loc - m*)`` locally, and for the
    received rows gathered at ``recv_idx``, scaled by ``r_scale``, sent
    back in the same exchange and added at ``push_idx``."""

    @staticmethod
    def forward(ctx, m_loc, s_loc, v_loc, push_idx, recv_idx):
        L, d, k = s_loc.shape
        dv = v_loc.shape[-1]
        push, recv = _flat(push_idx, d), _flat(recv_idx, d)
        payload = torch.cat([m_loc, s_loc, v_loc.reshape(L, d, -1)], dim=-1)
        frame = _sink_frames(payload)
        frame[:, d, :k] = float("-inf")
        got = _exchange(frame.view(-1, payload.shape[-1]).index_select(
            0, push).view(push_idx.shape + (-1,)), "forward")
        got = got.reshape(-1, payload.shape[-1])
        r_m, r_s, r_v = got[:, :k], got[:, k:2 * k], got[:, 2 * k:]
        scale_loc, r_scale = _merge_scales(m_loc, r_m, recv)
        ctx.save_for_backward(push, recv, scale_loc, r_scale)
        ctx.slots = tuple(push_idx.shape[1:])
        s_out = _sink_frames(s_loc * scale_loc).view(-1, k)
        s_out.index_add_(0, recv, r_s * r_scale)
        v_out = _sink_frames((v_loc * scale_loc[..., None]).reshape(L, d, -1))
        v_out.view(-1, k * dv).index_add_(
            0, recv, (r_v.reshape(-1, k, dv) * r_scale[..., None])
            .reshape(r_v.shape))
        return (s_out.view(L, d + 1, k)[:, :d],
                v_out[:, :d].reshape(v_loc.shape))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_s, g_v):
        push, recv, scale_loc, r_scale = ctx.saved_tensors
        L, d, k, dv = g_v.shape
        gs_r = _sink_frames(g_s).view(-1, k).index_select(0, recv) * r_scale
        gv_r = (_sink_frames(g_v.reshape(L, d, -1)).view(-1, k * dv)
                .index_select(0, recv).reshape(-1, k, dv)
                * r_scale[..., None])
        back = _exchange(
            torch.cat([gs_r, gv_r.reshape(-1, k * dv)], -1).view(
                (L,) + ctx.slots + (-1,)), "backward")
        back = back.reshape(-1, k + k * dv)
        ds = _sink_frames(g_s * scale_loc)
        ds.view(-1, k).index_add_(0, push, back[:, :k])
        dv_loc = _sink_frames((g_v * scale_loc[..., None]).reshape(L, d, -1))
        dv_loc.view(-1, k * dv).index_add_(0, push, back[:, k:])
        return (None, ds[:, :d], dv_loc[:, :d].reshape(L, d, k, dv), None,
                None)


def shuffle_softmax_merge(m_loc: torch.Tensor, s_loc: torch.Tensor,
                          v_loc: torch.Tensor, push_idx: torch.Tensor,
                          recv_idx: torch.Tensor):
    """Exact distributed segment softmax in one exchange: the local max
    ``m_loc [L, dst_cap, K]`` of this process's partitions (-inf for a row
    with no local edge), sum of exps ``s_loc [L, dst_cap, K]`` and
    weighted values ``v_loc [L, dst_cap, K, Dh]``, all f32, go to the
    owners of their rows in one payload, and each owner merges them with
    its own: ``m* = max``, every partial rescaled by ``exp(m_p - m*)``.
    Returns the merged ``(s, v)``; ``m_loc`` takes no gradient."""
    _check_group(push_idx, "shuffle_softmax_merge", m_loc, s_loc, v_loc)
    with record_function("shuffle_softmax_merge"):
        return _ShuffleSoftmaxMerge.apply(m_loc.detach(), s_loc,
                                          v_loc.contiguous(), push_idx,
                                          recv_idx)


def shuffle_merge_reference(neighs: torch.Tensor, push_idx: torch.Tensor,
                            recv_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``shuffle_merge`` over all P partitions in one
    process, for tests: ``neighs [P, dst_cap, H]``, ``push_idx`` and
    ``recv_idx [P, P, S_cap]``; partition r's rows for q are moved to q by
    explicit transposition. Differentiable by autograd."""
    P, D, H = neighs.shape
    merged = []
    for p in range(P):
        frame = torch.cat([neighs[p], neighs.new_zeros(1, H)])
        for r in range(P):
            rows = push_idx[r, p].long()
            sent = neighs[r][rows.clamp(min=0)] * (rows >= 0)[:, None]
            frame = frame.index_add(0, recv_idx[p, r].long(), sent)
        merged.append(frame[:D])
    return torch.stack(merged)


def reverse_shuffle_reference(frames: torch.Tensor, push_idx: torch.Tensor,
                              recv_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``reverse_shuffle`` over all P partitions in one
    process, for tests: ``frames [P, dst_cap, C]``; partition p writes the
    rows owner q lists in ``recv_idx[q, p]`` at its ``push_idx[p, q]``.
    Differentiable by autograd."""
    P, D, C = frames.shape
    out = []
    for p in range(P):
        frame = torch.cat([frames[p], frames.new_zeros(1, C)])
        for q in range(P):
            owner = torch.cat([frames[q], frames.new_zeros(1, C)])
            rows = owner[recv_idx[q, p].long()]
            tgt = push_idx[p, q].long()
            frame = frame.index_copy(0, torch.where(tgt < 0, D, tgt), rows)
        out.append(frame[:D])
    return torch.stack(out)


def shuffle_softmax_merge_reference(m_loc: torch.Tensor, s_loc: torch.Tensor,
                                    v_loc: torch.Tensor,
                                    push_idx: torch.Tensor,
                                    recv_idx: torch.Tensor):
    """Plain version of ``shuffle_softmax_merge`` over all P partitions in
    one process, for tests: ``m_loc``, ``s_loc [P, dst_cap, K]`` and
    ``v_loc [P, dst_cap, K, Dh]``; owner p merges the rows partition r
    pushes (``push_idx[r, p]``) at ``recv_idx[p, r]`` with its own. The
    maxima are detached, as in the all-to-all version; differentiable in
    ``s`` and ``v`` by autograd."""
    m_loc = m_loc.detach()
    P, D, K = s_loc.shape
    s_out, v_out = [], []
    for p in range(P):
        m_star = torch.cat([m_loc[p], m_loc.new_full((1, K), float("-inf"))])
        pushed = []
        for r in range(P):
            rows = push_idx[r, p].long()
            valid = (rows >= 0)[:, None]
            safe = rows.clamp(min=0)
            r_m = torch.where(valid, m_loc[r][safe], float("-inf"))
            tgt = recv_idx[p, r].long()
            m_star = m_star.scatter_reduce(0, tgt[:, None].expand(-1, K),
                                           r_m, "amax", include_self=True)
            pushed.append((tgt, r_m, s_loc[r][safe] * valid,
                           v_loc[r][safe] * valid[..., None]))
        m_star = torch.where(torch.isfinite(m_star), m_star, 0.0)
        scale = torch.where(torch.isfinite(m_loc[p]),
                            torch.exp(m_loc[p] - m_star[:D]), 0.0)
        s = torch.cat([s_loc[p] * scale, s_loc.new_zeros(1, K)])
        v = torch.cat([v_loc[p] * scale[..., None],
                       v_loc.new_zeros((1,) + tuple(v_loc.shape[2:]))])
        for tgt, r_m, r_s, r_v in pushed:
            r_scale = torch.where(torch.isfinite(r_m),
                                  torch.exp(r_m - m_star[tgt]), 0.0)
            s = s.index_add(0, tgt, r_s * r_scale)
            v = v.index_add(0, tgt, r_v * r_scale[..., None])
        s_out.append(s[:D])
        v_out.append(v[:D])
    return torch.stack(s_out), torch.stack(v_out)


def neigh_mean(merged: torch.Tensor, lyr: SplitLayer) -> torch.Tensor:
    """Owned rows of the merged sums divided by their global degree."""
    owned_sum = merged.index_select(0, lyr.owned_idx.clamp(min=0))
    return owned_sum / lyr.owned_deg[:, None]


def slice_owned(merged: torch.Tensor, lyr: SplitLayer, x: torch.Tensor):
    """Select owned rows, finish the mean, fetch self features.

    Returns (self_x[O_cap, H] f32, neigh_mean[O_cap, H], mask[O_cap, 1])."""
    with record_function("slice_owned"):
        self_x = x.index_select(0, lyr.self_idx).float()
        return self_x, neigh_mean(merged, lyr), lyr.owned_mask[:, None]


def synthesize_device_innermost(lyr: SplitLayer, indptr: torch.Tensor,
                                indices: torch.Tensor,
                                generator: torch.Generator) -> SplitLayer:
    """Build the innermost layer on the device from a resident CSR.

    The same sample the C++ worker would build: the self slot first, then
    all neighbours in adjacency order when deg <= fanout (bit-identical
    to the host path, whatever the lowering), else ``fanout`` draws from
    the adjacency row. Needs a replicated identity cache (frame row ==
    global id), so every dst row is owned in rank order and the layer has
    no shuffle. ``indptr`` / ``indices`` come from
    ``parallel/model.make_device_csr``, whose layout must be the one the
    lowering reads; another raises ``ValueError``.

    The draws at deg > fanout, by ``OCC_DEVICE_SAMPLE``:
    - ``randint`` (the default): K uniform draws with replacement.
      ``torch.randint`` takes one upper bound, not one per dst, so each
      draw is a 62-bit uniform integer reduced modulo the dst's degree:
      the modulo bias of a value is below deg / 2^62 (under 1e-12 for any
      degree below 4 million), far below what any sample can show. The
      draws are made here and the rest is one call of
      ``ops/device_sample.synthesize_innermost``: its kernel on the card,
      its plain version on the CPU.
    - ``bitsf32``: K draws of 24 random bits, ``floor(bits / 2^24 *
      deg)`` in f32, capped at deg - 1: exact for deg < 2^24.
    - ``bitsf32_dk``: the draws of ``bitsf32`` for the same generator
      state, the CSR read dst-major and transposed back: the same layer.
    - ``window``: one uniform start a dst and the K neighbours from it,
      wrapping around the adjacency through its second copy in the
      doubled CSR: uniform marginals, no neighbour twice.
    The last three stay torch ops, with no kernel of their own.
    """
    with record_function("synthesize_device_innermost"):
        return _synthesize(lyr, indptr, indices, generator)


def _synthesize(lyr, indptr, indices, generator):
    dg = lyr.dst_global
    K = lyr.fanout
    if K <= 0:
        raise ValueError("device-innermost synthesis needs a bounded fanout")
    impl = device_sample_impl()
    want = "doubled" if impl == "window" else "plain"
    layout = getattr(indices, "csr_layout", None)
    if layout != want:
        raise ValueError(
            f"OCC_DEVICE_SAMPLE={impl} reads the {want} CSR layout, but the "
            f"indices given are {layout or 'untagged'}: build the CSR with "
            "make_device_csr under the same OCC_DEVICE_SAMPLE")
    if impl == "window" and K > WINDOW_PAD:
        raise ValueError(f"window sampling pads the doubled CSR by "
                         f"{WINDOW_PAD}; fanout {K} would slice past it")
    D = dg.shape[0]
    if impl == "randint":
        draws = torch.randint(0, 2**62, (K, D), generator=generator,
                              device=dg.device)
        return _as_layer(lyr, synthesize_innermost(
            dg, indptr, indices, draws, K, lyr.src_cap, lyr.out_cap))
    valid = dg >= 0
    g = dg.clamp(min=0)
    off = indptr.index_select(0, g)
    deg = torch.where(valid, indptr.index_select(0, g + 1) - off, 0)
    take = deg.clamp(max=K)
    kr = torch.arange(K, device=dg.device)[:, None]
    if impl == "window":
        # Node g's doubled span starts at 2 * off. deg <= K: the slice at
        # the span start is the adjacency in order (slots >= take read on
        # and are masked below); deg > K: the window [start, start + K)
        # runs into the second copy. WINDOW_PAD keeps it in the array.
        start = (torch.randint(0, 2**62, (D,), generator=generator,
                               device=dg.device) % deg.clamp(min=1))
        base = 2 * off + torch.where(deg > K, start, 0)
        src = indices[base[None, :] + kr]
    else:
        bits = torch.randint(0, 1 << 24, (K, D), generator=generator,
                             device=dg.device)
        u = bits.float() * (1.0 / (1 << 24))
        draws = torch.minimum(
            torch.floor(u * deg.float()[None, :]).long(),
            (deg - 1).clamp(min=0)[None, :])
        sel = torch.where(deg[None, :] > K, draws, kr)
        # Slots k >= take are masked below; clamp keeps their reads in
        # range (JAX clamps the same gather silently).
        last = indices.shape[0] - 1
        if impl == "bitsf32_dk":
            src = indices[(off[:, None] + sel.T).clamp_(max=last)].T
        else:
            src = indices[(off[None, :] + sel).clamp_(max=last)]
    zero_row = lyr.src_cap - 1  # reserved zero row of the cache frame
    nbr_main = torch.where(kr < take[None, :], src, zero_row)
    return _as_layer(lyr, innermost_fields(g, valid, take, nbr_main,
                                           lyr.src_cap, lyr.out_cap))


def _as_layer(lyr: SplitLayer, f: InnermostFields) -> SplitLayer:
    """The synthesized fields as the owned-rank-order layer."""
    return SplitLayer(
        owned_idx=f.owned_idx,
        owned_deg=f.owned_deg,
        self_idx=f.self_idx,
        owned_mask=f.owned_mask,
        num_owned=f.num_owned,
        nbr_idx=f.nbr,
        src_cap=lyr.src_cap,
        dst_cap=lyr.dst_cap,
        out_cap=lyr.out_cap,
        fanout=lyr.fanout,
    )
