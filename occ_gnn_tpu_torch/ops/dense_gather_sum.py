"""Dense gather-sum: split's aggregation through the dense ``[K, D]``
neighbour matrix, its hand-written Hopper kernels, their plain versions,
and the autograd rule around them.

``dense_gather_sum(x, nbr)`` computes ``out[d] = sum over k = 0..K-1, in
order, of float(x[nbr[k, d]])`` for an f32 or bf16 frame ``x [S, H]``
whose last row ``S - 1`` is the reserved zero row that padding slots name,
and an int32 ``nbr [K, D]``; the result is f32 ``[D, H]``. Its gradient to
``x`` is ``dense_scatter_add``: ``dx[nbr[k, d]] += g[d]`` for every slot,
padding slots included (so ``dx[S - 1]`` holds their sum, as the
transpose of the gather gives it), returned in ``x``'s type.

Both replace what XLA makes of JAX's
``occ_gnn_tpu/parallel/split.py:161-197`` (``local_aggregate_dense``): its
unrolled branch (``:191-197``) compiles into one add fusion of K gathers,
and its transpose into the backward's scatter. There is no ``pallas_call``
to port; the port's counterpart of the fusion is one kernel a layer each
way, on one source, ``csrc/dense_gather_sum.cu``, bound by device-memory
bytes. A team of threads sums a dst row in f32 registers, adding the K
rows in the order of k, so the forward equals its plain version bit for
bit; the backward adds each ``g`` row into its K targets with f32 atomics
and sums the zero row's share within a block first.

Under ``tile`` (``OCC_DENSE_AGG=tiled``) each dst tile of ``tile`` columns
goes through the forward on its own, into its slice of the output: the
same sums in the same order. The backward is one launch either way.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from occ_gnn_tpu_torch.ops.build import check_launch, load_kernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C entries of csrc/dense_gather_sum.cu, argument for argument.
ARGTYPES = {
    # x, x_bf16, x_rows, h, nbr, ld, k, d, out, device, stream
    "dense_gather_sum": [_P, _I, _L, _I, _P, _L, _I, _L, _P, _I, _P],
    # g, nbr, ld, k, d, h, x_rows, dx, device, stream
    "dense_scatter_add": [_P, _P, _L, _I, _L, _I, _L, _P, _I, _P],
}


def dense_gather_sum_reference(x: torch.Tensor, nbr: torch.Tensor,
                               out: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Plain version: ``sum_k x[nbr[k]]`` in f32, k in order, into ``out``
    when given. K row-gathers, never one ``[K, D, H]`` gather."""
    first = x.index_select(0, nbr[0])
    acc = first.float() if out is None else out.copy_(first)
    for k in range(1, nbr.shape[0]):
        acc.add_(x.index_select(0, nbr[k]))
    return acc


def dense_scatter_add_reference(grad: torch.Tensor, nbr: torch.Tensor,
                                num_rows: int) -> torch.Tensor:
    """Plain version: ``grad`` added into one f32 ``[num_rows, H]`` buffer
    K times (``index_add_``), where autograd of K gathers would build K
    full buffers."""
    dx = grad.new_zeros((num_rows, grad.shape[1]))
    for k in range(nbr.shape[0]):
        dx.index_add_(0, nbr[k], grad)
    return dx


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_kernel("dense_gather_sum")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _on_cuda(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA tensors, got "
                         f"{t.device}")


def _launch_gather(x: torch.Tensor, nbr: torch.Tensor,
                   out: torch.Tensor) -> None:
    """One forward launch: ``nbr`` may be a column slice (row stride
    ``nbr.stride(0)``), ``out`` its contiguous ``[D, H]`` rows."""
    _on_cuda("dense_gather_sum", x)
    K, D = nbr.shape
    if D == 0 or x.shape[1] == 0:
        return
    lib = _library()
    err = lib.dense_gather_sum(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], x.shape[1],
        nbr.data_ptr(), nbr.stride(0), K, D, out.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(lib, err, "dense_gather_sum")
    dense_gather_sum.launches += 1


def _launch_scatter(grad: torch.Tensor, nbr: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    _on_cuda("dense_scatter_add", grad)
    K, D = nbr.shape
    h = grad.shape[1]
    dx = torch.zeros((num_rows, h), dtype=torch.float32, device=grad.device)
    if D == 0 or h == 0:
        return dx
    lib = _library()
    err = lib.dense_scatter_add(
        grad.data_ptr(), nbr.data_ptr(), nbr.stride(0), K, D, h, num_rows,
        dx.data_ptr(), grad.device.index,
        torch.cuda.current_stream(grad.device).cuda_stream,
    )
    check_launch(lib, err, "dense_scatter_add")
    dense_scatter_add.launches += 1
    return dx


def _forward(x: torch.Tensor, nbr: torch.Tensor,
             tile: int | None) -> torch.Tensor:
    """Each dst tile of ``tile`` columns (all D at once by default) into
    its rows of the output: the plain version on the CPU, a kernel launch
    on the card."""
    D = nbr.shape[1]
    out = torch.empty((D, x.shape[1]), dtype=torch.float32, device=x.device)
    step = max(D if tile is None else tile, 1)
    for t0 in range(0, D, step):
        cols, rows = nbr[:, t0:t0 + step], out[t0:t0 + step]
        if x.device.type == "cpu":
            dense_gather_sum_reference(x, cols, rows)
        else:
            _launch_gather(x, cols, rows)
    return out


class _DenseAggregate(torch.autograd.Function):
    """The forward saves only ``nbr``; the backward is
    ``dense_scatter_add``, its result cast to ``x``'s type."""

    @staticmethod
    def forward(ctx, x, nbr, tile):
        ctx.save_for_backward(nbr)
        ctx.num_rows, ctx.x_dtype = x.shape[0], x.dtype
        return _forward(x, nbr, tile)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (nbr,) = ctx.saved_tensors
        dx = dense_scatter_add(grad.contiguous(), nbr, ctx.num_rows)
        return dx.to(ctx.x_dtype), None, None


def _check_nbr(nbr: torch.Tensor, like: torch.Tensor) -> None:
    if nbr.dtype != torch.int32 or nbr.dim() != 2:
        raise TypeError(f"nbr must be 2-D int32 [K, D], got {nbr.dim()}-D "
                        f"{nbr.dtype}")
    if nbr.shape[0] < 1:
        raise ValueError("nbr must have at least one row (K >= 1)")
    if nbr.device != like.device:
        raise ValueError(f"nbr on {nbr.device}, rows on {like.device}")
    if not nbr.is_contiguous():
        raise ValueError("nbr must be contiguous")
    if nbr.shape[1] >= 2**31:
        raise ValueError(f"{nbr.shape[1]} dst columns: past int32")


def dense_gather_sum(x: torch.Tensor, nbr: torch.Tensor,
                     tile: int | None = None) -> torch.Tensor:
    """``out[d] = sum over k in order of float(x[nbr[k, d]])`` -> f32
    ``[D, H]``, for f32 or bf16 ``x [S, H]`` and int32 ``nbr [K, D]``;
    ``tile`` sums the dst columns ``tile`` at a time. Differentiable in
    ``x`` (the gradient comes back in ``x``'s type).

    Every ``nbr`` entry must be a row of ``x``, as ``index_select``
    requires; on the card one out of range stops the kernel with a
    device-side assert. ``dense_gather_sum.launches`` counts the forward
    kernel's launches (one a dst tile)."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"x must be 2-D float32 or bfloat16, got {x.dim()}-D "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check_nbr(nbr, x)
    if tile is not None and tile < 1:
        raise ValueError(f"tile {tile} must be at least 1")
    return _DenseAggregate.apply(x, nbr, tile)


dense_gather_sum.launches = 0


def dense_scatter_add(grad: torch.Tensor, nbr: torch.Tensor,
                      num_rows: int) -> torch.Tensor:
    """``dx[nbr[k, d]] += grad[d]`` for every slot of int32 ``nbr [K, D]``
    -> f32 ``[num_rows, H]``, for f32 ``grad [D, H]``: the gradient of
    ``dense_gather_sum`` to an ``x`` of ``num_rows`` rows.
    ``dense_scatter_add.launches`` counts the kernel's launches."""
    if grad.dtype != torch.float32 or grad.dim() != 2:
        raise TypeError(f"grad must be 2-D float32, got {grad.dim()}-D "
                        f"{grad.dtype}")
    if not grad.is_contiguous():
        raise ValueError("grad must be contiguous")
    _check_nbr(nbr, grad)
    if nbr.shape[1] != grad.shape[0]:
        raise ValueError(f"nbr has {nbr.shape[1]} dst columns, grad "
                         f"{grad.shape[0]} rows")
    if not 1 <= num_rows < 2**31:
        raise ValueError(f"num_rows {num_rows} out of [1, 2^31)")
    if grad.device.type == "cpu":
        return dense_scatter_add_reference(grad, nbr, num_rows)
    return _launch_scatter(grad, nbr, num_rows)


dense_scatter_add.launches = 0
