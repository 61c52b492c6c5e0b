"""Sorted segment-sum: the hand-written Hopper kernel, its plain version,
and the autograd rule around them.

``segment_sum_sorted`` replaces the TPU kernel
``occ_gnn_tpu/ops/pallas_spmm_blocked.py::segment_sum_sorted`` (its
``pl.pallas_call`` at line 190) with the same contract: f32 ``msgs
[E, H]``, int32 ``edge_dst [E]`` sorted ascending with padding entries
equal to ``num_segments``, and an f32 ``[num_segments, H]`` result.

The kernel, ``csrc/segment_sum_sorted.cu``, is bound by device-memory
bytes: it reads each valid edge row once and writes each output row once.
Its design: one warp per dst row finds the row's edge range by binary
search over the sorted ``edge_dst``, its lanes stride over H (float4 when
the rows allow), and the sum stays in f32 registers until one write, so
there are no atomics and the sum never visits the padding tail.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from occ_gnn_tpu_torch.ops.build import check_launch, load_kernel


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_kernel("segment_sum_sorted")
    lib.segment_sum_sorted_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.segment_sum_sorted_f32.restype = ctypes.c_int
    return lib


def _launch(msgs: torch.Tensor, edge_dst: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    if msgs.device.type != "cuda":
        raise ValueError(f"the segment_sum_sorted kernel runs on CUDA "
                         f"tensors, got {msgs.device}")
    num_edges, h = msgs.shape
    out = torch.empty((num_segments, h), dtype=torch.float32,
                      device=msgs.device)
    if num_segments == 0 or h == 0:
        return out
    lib = _library()
    err = lib.segment_sum_sorted_f32(
        msgs.data_ptr(), edge_dst.data_ptr(), num_edges, h, num_segments,
        out.data_ptr(), msgs.device.index,
        torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    check_launch(lib, err, "segment_sum_sorted")
    segment_sum_sorted.launches += 1
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


def _check(msgs: torch.Tensor, edge_dst: torch.Tensor,
           num_segments: int) -> None:
    if msgs.dtype != torch.float32 or msgs.dim() != 2:
        raise TypeError(f"msgs must be 2-D float32, got {msgs.dim()}-D "
                        f"{msgs.dtype}")
    if edge_dst.dtype != torch.int32 or edge_dst.shape != msgs.shape[:1]:
        raise TypeError(f"edge_dst must be int32 [{msgs.shape[0]}], got "
                        f"{edge_dst.dtype} {list(edge_dst.shape)}")
    if msgs.device != edge_dst.device:
        raise ValueError(f"msgs on {msgs.device}, edge_dst on "
                         f"{edge_dst.device}")
    if not (msgs.is_contiguous() and edge_dst.is_contiguous()):
        raise ValueError("msgs and edge_dst must be contiguous")
    if not 0 <= num_segments < 2**31 - 1:
        raise ValueError(f"num_segments {num_segments} out of int32 range")


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


def spmm_sum_blocked(x: torch.Tensor, edge_src: torch.Tensor,
                     edge_dst: torch.Tensor, num_dst: int) -> torch.Tensor:
    """``x[edge_src]`` followed by the sorted segment-sum."""
    return segment_sum_sorted(x[edge_src], edge_dst, num_dst)
