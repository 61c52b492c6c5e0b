"""Sorted segment-sum: the hand-written Hopper kernel's two entry points,
their plain versions, and the autograd rules around them.

``segment_sum_sorted`` replaces the TPU kernel
``occ_gnn_tpu/ops/pallas_spmm_blocked.py::segment_sum_sorted`` (its
``pl.pallas_call`` at line 190) with the same contract: f32 ``msgs
[E, H]``, int32 ``edge_dst [E]`` sorted ascending with padding entries
equal to ``num_segments``, and an f32 ``[num_segments, H]`` result.

``gather_segment_sum`` is that file's ``spmm_sum_blocked`` (line 213, the
row gather followed by the segment-sum) and ``ops/segment.spmm_sum`` with
an edge weight: ``out[d] = sum over valid e with edge_dst[e] == d of
w[e] * float(x[edge_src[e]])``, with ``x`` f32 or bf16 ``[S, H]``. The
kernel reads each valid edge's row of ``x`` itself, in the frame's own
type, so neither an ``[E, H]`` message tensor nor an f32 copy of a bf16
frame is ever written.

Both run on one source, ``csrc/segment_sum_sorted.cu``, bound by
device-memory bytes. Its design: the valid edges are cut into tiles of
``TILE_EDGES``; a team of threads (one for each column group of a row)
sums one tile's rows in f32 registers and writes each row once. A row cut
by a tile's edge is summed whole by the tile where it begins when it ends
in the next tile; a longer one leaves partial sums in a ``[num_tiles, 2,
H]`` f32 scratch buffer, which a second pass adds up in tile order. No
search per row, no atomics (the same inputs give the same bits), and the
padding tail is never read.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from occ_gnn_tpu_torch.ops.build import check_launch, load_kernel

# Valid edges a tile. The kernel takes it as an argument, so the wrapper,
# the scratch it allocates and the tests' model of the tiles agree.
TILE_EDGES = 64


def segment_sum_sorted_reference(msgs: torch.Tensor, edge_dst: torch.Tensor,
                                 num_segments: int) -> torch.Tensor:
    """Plain version: ``out[d] = sum of msgs[e] with edge_dst[e] == d``,
    for any row shape and any order of ``edge_dst``.

    ``jax.ops.segment_sum`` drops ids equal to ``num_segments``;
    ``index_add_`` has no drop mode, so padding lands in a sink row that is
    sliced off."""
    out = msgs.new_zeros((num_segments + 1,) + tuple(msgs.shape[1:]))
    out.index_add_(0, edge_dst.long(), msgs)
    return out[:num_segments]


def segment_sum_sorted_backward(grad: torch.Tensor, edge_dst: torch.Tensor,
                                num_segments: int) -> torch.Tensor:
    """``d msgs[e] = grad[edge_dst[e]]``, zero for padding edges: a gather
    from ``grad`` with one zero row appended at ``num_segments``, as the
    TPU kernel's ``_bwd`` does."""
    g_pad = torch.cat([grad, grad.new_zeros((1,) + tuple(grad.shape[1:]))])
    return g_pad[edge_dst.clamp(max=num_segments).long()]


def gather_segment_sum_reference(x: torch.Tensor, edge_src: torch.Tensor,
                                 edge_dst: torch.Tensor, num_segments: int,
                                 edge_weight: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain version: the rows ``x[edge_src]`` in f32, times the weight
    where given, then the plain segment-sum."""
    msgs = x.index_select(0, edge_src).float()
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    return segment_sum_sorted_reference(msgs, edge_dst, num_segments)


def gather_segment_sum_backward(grad: torch.Tensor, edge_src: torch.Tensor,
                                edge_dst: torch.Tensor, num_segments: int,
                                num_src: int,
                                edge_weight: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """``dx[s] = sum over valid e with edge_src[e] == s of w[e] *
    grad[edge_dst[e]]``, in f32: the segment-sum's backward (padding edges
    get a zero row) followed by the gather's transpose, an ``index_add_``."""
    g_edges = segment_sum_sorted_backward(grad, edge_dst, num_segments)
    if edge_weight is not None:
        g_edges = g_edges * edge_weight[:, None]
    dx = grad.new_zeros((num_src, grad.shape[1]))
    return dx.index_add_(0, edge_src, g_edges)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_kernel("segment_sum_sorted")
    lib.segment_sum_sorted_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.segment_sum_sorted_f32.restype = ctypes.c_int
    lib.gather_segment_sum.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gather_segment_sum.restype = ctypes.c_int
    return lib


def _buffers(like: torch.Tensor, num_edges: int, h: int, num_segments: int):
    """The f32 output and the kernel's scratch: two partial rows a tile,
    and a tile's owner flag (the valid-edge count after them)."""
    out = torch.empty((num_segments, h), dtype=torch.float32,
                      device=like.device)
    tiles = -(-num_edges // TILE_EDGES)
    partial = torch.empty(2 * tiles * h, dtype=torch.float32,
                          device=like.device)
    owner = torch.empty(tiles + 1, dtype=torch.int32, device=like.device)
    return out, partial, owner


def _on_cuda(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA tensors, got "
                         f"{t.device}")


def _launch(msgs: torch.Tensor, edge_dst: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    _on_cuda("segment_sum_sorted", msgs)
    num_edges, h = msgs.shape
    out, partial, owner = _buffers(msgs, num_edges, h, num_segments)
    if num_segments == 0 or h == 0:
        return out
    lib = _library()
    err = lib.segment_sum_sorted_f32(
        msgs.data_ptr(), edge_dst.data_ptr(), num_edges, h, num_segments,
        TILE_EDGES, partial.data_ptr(), owner.data_ptr(), out.data_ptr(),
        msgs.device.index,
        torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    check_launch(lib, err, "segment_sum_sorted")
    segment_sum_sorted.launches += 1
    return out


def _launch_gather(x: torch.Tensor, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, edge_weight: torch.Tensor | None,
                   num_segments: int) -> torch.Tensor:
    _on_cuda("gather_segment_sum", x)
    num_edges = edge_dst.shape[0]
    h = x.shape[1]
    out, partial, owner = _buffers(x, num_edges, h, num_segments)
    if num_segments == 0 or h == 0:
        return out
    lib = _library()
    err = lib.gather_segment_sum(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0],
        edge_src.data_ptr(), edge_dst.data_ptr(),
        None if edge_weight is None else edge_weight.data_ptr(), num_edges,
        h, num_segments, TILE_EDGES, partial.data_ptr(), owner.data_ptr(),
        out.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(lib, err, "gather_segment_sum")
    gather_segment_sum.launches += 1
    return out


class _SegmentSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, edge_dst, num_segments):
        ctx.save_for_backward(edge_dst)
        ctx.num_segments = num_segments
        return _launch(msgs, edge_dst, num_segments)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (edge_dst,) = ctx.saved_tensors
        return (segment_sum_sorted_backward(grad, edge_dst, ctx.num_segments),
                None, None)


class _GatherSegmentSum(torch.autograd.Function):
    """The forward: the plain version on the CPU, the kernel on the card.
    The backward is ``gather_segment_sum_backward`` on both: the gradient
    summed in f32 and cast to ``x``'s type once (autograd of the plain
    version would round each edge's row of a bf16 frame's gradient and
    add them in bf16)."""

    @staticmethod
    def forward(ctx, x, edge_src, edge_dst, edge_weight, num_segments):
        ctx.save_for_backward(edge_src, edge_dst, edge_weight)
        ctx.num_segments = num_segments
        ctx.num_src, ctx.x_dtype = x.shape[0], x.dtype
        if x.device.type == "cpu":
            return gather_segment_sum_reference(x, edge_src, edge_dst,
                                                num_segments, edge_weight)
        return _launch_gather(x, edge_src, edge_dst, edge_weight,
                              num_segments)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        edge_src, edge_dst, edge_weight = ctx.saved_tensors
        dx = gather_segment_sum_backward(grad, edge_src, edge_dst,
                                         ctx.num_segments, ctx.num_src,
                                         edge_weight)
        return dx.to(ctx.x_dtype), None, None, None, None


def _check_index(name: str, index: torch.Tensor, num_edges: int,
                 like: torch.Tensor) -> None:
    if index.dtype != torch.int32 or index.shape != (num_edges,):
        raise TypeError(f"{name} must be int32 [{num_edges}], got "
                        f"{index.dtype} {list(index.shape)}")
    if index.device != like.device:
        raise ValueError(f"{name} on {index.device}, rows on {like.device}")
    if not index.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_segments(num_segments: int) -> None:
    if not 0 <= num_segments < 2**31 - 1:
        raise ValueError(f"num_segments {num_segments} out of int32 range")


def _check(msgs: torch.Tensor, edge_dst: torch.Tensor,
           num_segments: int) -> None:
    if msgs.dtype != torch.float32 or msgs.dim() != 2:
        raise TypeError(f"msgs must be 2-D float32, got {msgs.dim()}-D "
                        f"{msgs.dtype}")
    if not msgs.is_contiguous():
        raise ValueError("msgs must be contiguous")
    _check_index("edge_dst", edge_dst, msgs.shape[0], msgs)
    _check_segments(num_segments)


def _check_gather(x: torch.Tensor, edge_src: torch.Tensor,
                  edge_dst: torch.Tensor, num_segments: int,
                  edge_weight: torch.Tensor | None) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"x must be 2-D float32 or bfloat16, got {x.dim()}-D "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[0] >= 2**31 or edge_dst.shape[0] >= 2**31:
        raise ValueError(f"{x.shape[0]} rows and {edge_dst.shape[0]} edges: "
                         f"past int32 indices")
    num_edges = edge_dst.shape[0] if edge_dst.dim() == 1 else -1
    _check_index("edge_dst", edge_dst, num_edges, x)
    _check_index("edge_src", edge_src, num_edges, x)
    if edge_weight is not None:
        if (edge_weight.dtype != torch.float32
                or edge_weight.shape != (num_edges,)):
            raise TypeError(f"edge_weight must be float32 [{num_edges}], got "
                            f"{edge_weight.dtype} {list(edge_weight.shape)}")
        if edge_weight.device != x.device or not edge_weight.is_contiguous():
            raise ValueError("edge_weight must be contiguous, on the rows' "
                             "device")
        if edge_weight.requires_grad:
            raise ValueError("edge_weight takes no gradient in "
                             "gather_segment_sum; detach it")
    _check_segments(num_segments)


def segment_sum_sorted(msgs: torch.Tensor, edge_dst: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment-sum of f32 ``msgs [E, H]`` over dst-sorted int32
    ``edge_dst`` (padding == ``num_segments``) -> f32 ``[num_segments, H]``.

    ``segment_sum_sorted.launches`` counts the kernel's launches."""
    _check(msgs, edge_dst, num_segments)
    if msgs.device.type == "cpu":
        return segment_sum_sorted_reference(msgs, edge_dst, num_segments)
    return _SegmentSumSorted.apply(msgs, edge_dst, num_segments)


segment_sum_sorted.launches = 0


def gather_segment_sum(x: torch.Tensor, edge_src: torch.Tensor,
                       edge_dst: torch.Tensor, num_segments: int,
                       edge_weight: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """``out[d] = sum over valid e with edge_dst[e] == d of w[e] *
    float(x[edge_src[e]])`` over a dst-sorted COO (padding dst ==
    ``num_segments``) -> f32 ``[num_segments, H]``. ``x`` is f32 or bf16
    ``[S, H]``; ``edge_weight``, f32 ``[E]``, takes no gradient. The
    gradient to ``x`` is summed in f32 and comes back in ``x``'s type,
    rounded once, on the CPU as on the card.

    Every ``edge_src`` entry must be a row of ``x``, as ``index_select``
    requires; on the card only valid edges' entries are read, and one out
    of range stops the kernel with a device-side assert.
    ``gather_segment_sum.launches`` counts the kernel's launches."""
    _check_gather(x, edge_src, edge_dst, num_segments, edge_weight)
    return _GatherSegmentSum.apply(x, edge_src, edge_dst, edge_weight,
                                   num_segments)


gather_segment_sum.launches = 0


def spmm_sum_blocked(x: torch.Tensor, edge_src: torch.Tensor,
                     edge_dst: torch.Tensor, num_dst: int) -> torch.Tensor:
    """JAX's ``spmm_sum_blocked``: ``x[edge_src]`` followed by the sorted
    segment-sum, which is ``gather_segment_sum``."""
    return gather_segment_sum(x, edge_src, edge_dst, num_dst)
