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
bytes. The forward sums a dst row in f32 registers, adding the K rows in
the order of k, so it equals its plain version bit for bit (a bf16 frame's
rows read as 16-byte words of their aligned window on large layers). The
backward is one cooperative launch that transposes ``nbr`` into a plan
(``dense_scatter_plan`` is its plain version: each row's slots in slot
order, and each column's padding slots) in a workspace the wrapper
allocates, then writes every row of ``dx`` once, summing its slots'
gradient rows in slot order (a row of more than 256 slots in 8
contiguous parts, added in order); no memset, no atomics on rows, the
same bits from every launch. The zero row is ``sum over d of c_d * g[d]``, reduced
in a tree fixed by D.

``dense_scatter_slots(rows, nbr, num_rows, plan)`` sums a row a slot:
each slot adds its own row ``rows[k * D + d]`` (GAT's attention backward
writes one a valid slot) in place of ``g[d]``, each row's slots in slot
order as the backward above; the zero row is written as zeros and padding
slots' rows are not read. Its kernel is one plain launch with no grid
barrier, no sort, no workspace and no atomics: the transpose of ``nbr``
(``ScatterPlan``) is built on the host beside ``nbr`` and shipped with the
batch (the C++ sampling service, or ``slots_plan``, the plain version that
the numpy slicer calls), never on the card.

The gradient to a bf16 frame is summed in f32 and rounded to bf16 once;
JAX rounds every partial sum to bf16. The port's is the nearer to the
exact sum (``tests/test_torch_dense_gather.py``).

Under ``tile`` (``OCC_DENSE_AGG=tiled``) each dst tile of ``tile`` columns
goes through the forward on its own, into its slice of the output: the
same sums in the same order. The backward is one launch either way.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from occ_gnn_tpu_torch.ops.build import check_launch, load_kernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C entries of csrc/dense_gather_sum.cu, argument for argument, and
# what they return.
ARGTYPES = {
    # x, x_bf16, x_rows, h, nbr, ld, k, d, out, device, stream
    "dense_gather_sum": [_P, _I, _L, _I, _P, _L, _I, _L, _P, _I, _P],
    # k, d, h, x_rows
    "dense_scatter_workspace_bytes": [_I, _L, _I, _L],
    # g, nbr, ld, k, d, h, x_rows, dx, workspace, device, stream
    "dense_scatter_add": [_P, _P, _L, _I, _L, _I, _L, _P, _P, _I, _P],
    # rows, num_slots, h, offsets, slots, long_rows, num_long, long_cap,
    # span, x_rows, dx, device, stream
    "dense_scatter_slots": [_P, _L, _I, _P, _P, _P, _P, _L, _I, _L, _P, _I,
                            _P],
}
RESTYPES = {"dense_scatter_workspace_bytes": _L}
# A row of more than SPAN slots is summed by a whole block of the
# per-slot kernel; the plan lists such rows. The one owner of the value:
# the kernel and the C++ sampling service take it as an argument.
SPAN = 256


class ScatterPlan(NamedTuple):
    """``dense_scatter_slots``' plan of one int32 ``nbr [K, D]`` whose
    sources are rows of a frame of ``S`` rows (the last, ``S - 1``, the
    zero row that padding slots name), int32 on the device of the rows it
    sums:

    * ``offsets [S]``: the exclusive scan of the slots naming each row ``s
      < S - 1``, so ``offsets[S - 1]`` is the valid slot count;
    * ``slots [K * D]``: each row's slot ids ``k * D + d`` in slot order,
      row ``s``'s at ``offsets[s]:offsets[s + 1]``; the tail past
      ``offsets[S - 1]`` is unread (the plain version writes -1 there,
      the C++ service leaves it as it was);
    * ``long_rows [long_capacity(K * D)]``: the rows of more than SPAN
      slots, in increasing order, then -1;
    * ``num_long []``: their number."""

    offsets: torch.Tensor
    slots: torch.Tensor
    long_rows: torch.Tensor
    num_long: torch.Tensor


def plans_equal(a: ScatterPlan, b: ScatterPlan) -> bool:
    """Whether two plans agree on all that the kernel reads: every field,
    ``slots`` as far as ``offsets[-1]``."""
    n = int(a.offsets[-1])
    return (torch.equal(a.offsets, b.offsets)
            and torch.equal(a.slots[:n], b.slots[:n])
            and torch.equal(a.long_rows, b.long_rows)
            and torch.equal(a.num_long, b.num_long))


def long_capacity(num_slots: int) -> int:
    """Room for the rows of more than SPAN of ``num_slots`` slots."""
    return num_slots // (SPAN + 1) + 1


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


def dense_scatter_slots_reference(rows: torch.Tensor, nbr: torch.Tensor,
                                  num_rows: int) -> torch.Tensor:
    """Plain version of the per-slot mode: each slot's own row ``rows[k *
    D + d]`` added into ``dx[nbr[k, d]]`` (one ``index_add_``), then the
    zero row ``num_rows - 1`` set to 0, whatever its padding slots' rows
    hold."""
    dx = rows.new_zeros((num_rows, rows.shape[1]))
    dx.index_add_(0, nbr.reshape(-1), rows)
    dx[num_rows - 1] = 0.0
    return dx


def dense_scatter_plan(nbr: torch.Tensor, num_rows: int):
    """Plain version of the backward kernel's plan: the transpose of
    ``nbr [K, D]`` by source row. Returns ``(counts, offsets, slots,
    pad)``: ``counts [S - 1]`` the slots naming each row ``s < S - 1``,
    ``offsets [S]`` their exclusive scan, ``slots`` the slot ids ``k * D
    + d`` of row ``s`` at ``offsets[s]:offsets[s + 1]`` in slot order, and
    ``pad [D]`` each column's padding slots (naming row ``S - 1``), all
    int64 on ``nbr``'s device."""
    K, D = nbr.shape
    flat = nbr.reshape(-1).long()
    ids = torch.arange(K * D, device=nbr.device)
    valid = flat != num_rows - 1
    # A stable sort by row keeps each row's slots in slot order.
    rows, order = torch.sort(flat[valid], stable=True)
    slots = ids[valid][order]
    counts = torch.bincount(rows, minlength=num_rows - 1)
    offsets = torch.zeros(num_rows, dtype=torch.long, device=nbr.device)
    offsets[1:] = torch.cumsum(counts, 0)
    pad = (~valid).reshape(K, D).sum(0)
    return counts, offsets, slots, pad


def slots_plan(nbr: torch.Tensor, num_rows: int) -> ScatterPlan:
    """The plain version of ``dense_scatter_slots``' plan of ``nbr [K,
    D]`` (rows of a frame of ``num_rows``), from ``dense_scatter_plan``, on
    ``nbr``'s device. The C++ sampling service writes the same plan beside
    ``nbr`` (``csrc/occ_sampler.cpp``). ``slots_plan.on_card`` counts the
    builds on a CUDA ``nbr``: the main path builds none."""
    if nbr.device.type == "cuda":
        slots_plan.on_card += 1
    counts, offsets, slots, _ = dense_scatter_plan(nbr, num_rows)
    n = nbr.numel()
    dev = nbr.device
    full = torch.full((n,), -1, dtype=torch.int32, device=dev)
    full[:slots.numel()] = slots
    longs = torch.nonzero(counts > SPAN).reshape(-1)
    long_rows = torch.full((long_capacity(n),), -1, dtype=torch.int32,
                           device=dev)
    long_rows[:longs.numel()] = longs
    return ScatterPlan(offsets.int(), full, long_rows,
                       torch.tensor(longs.numel(), dtype=torch.int32,
                                    device=dev))


slots_plan.on_card = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_kernel("dense_gather_sum")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
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
    """One launch of the backward kernel; it writes every row of ``dx``
    and builds its plan in a workspace allocated here."""
    _on_cuda("dense_scatter_add", grad)
    K, D = nbr.shape
    h = grad.shape[1]
    if D == 0 or h == 0:
        return torch.zeros((num_rows, h), dtype=torch.float32,
                           device=grad.device)
    if K * D >= 2**31:
        raise ValueError(f"{K} x {D} slots: slot ids past int32")
    dx = torch.empty((num_rows, h), dtype=torch.float32, device=grad.device)
    lib = _library()
    workspace = torch.empty(
        lib.dense_scatter_workspace_bytes(K, D, h, num_rows),
        dtype=torch.uint8, device=grad.device)
    err = lib.dense_scatter_add(
        grad.data_ptr(), nbr.data_ptr(), nbr.stride(0), K, D, h, num_rows,
        dx.data_ptr(), workspace.data_ptr(), grad.device.index,
        torch.cuda.current_stream(grad.device).cuda_stream,
    )
    check_launch(lib, err, "dense_scatter_add")
    dense_scatter_add.launches += 1
    return dx


def _launch_slots(rows: torch.Tensor, plan: ScatterPlan,
                  num_rows: int) -> torch.Tensor:
    """One launch of the per-slot kernel through ``plan``; it writes every
    row of ``dx``."""
    _on_cuda("dense_scatter_slots", rows)
    h = rows.shape[1]
    dx = torch.empty((num_rows, h), dtype=torch.float32, device=rows.device)
    if h == 0:
        return dx
    if rows.shape[0] >= 2**31:
        raise ValueError(f"{rows.shape[0]} slots: slot ids past int32")
    lib = _library()
    err = lib.dense_scatter_slots(
        rows.data_ptr(), rows.shape[0], h, plan.offsets.data_ptr(),
        plan.slots.data_ptr(), plan.long_rows.data_ptr(),
        plan.num_long.data_ptr(), plan.long_rows.numel(), SPAN, num_rows,
        dx.data_ptr(), rows.device.index,
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    check_launch(lib, err, "dense_scatter_slots")
    dense_scatter_slots.launches += 1
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


def _check_plan(plan: ScatterPlan, num_slots: int, num_rows: int,
                like: torch.Tensor) -> None:
    want = {"offsets": (num_rows,), "slots": (num_slots,),
            "long_rows": (long_capacity(num_slots),), "num_long": ()}
    for name, shape in want.items():
        t = getattr(plan, name)
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"plan.{name} must be int32 {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != like.device:
            raise ValueError(f"plan.{name} on {t.device}, rows on "
                             f"{like.device}")
        if not t.is_contiguous():
            raise ValueError(f"plan.{name} must be contiguous")


def dense_scatter_slots(rows: torch.Tensor, nbr: torch.Tensor,
                        num_rows: int, plan: ScatterPlan | None = None
                        ) -> torch.Tensor:
    """``dx[nbr[k, d]] += rows[k * D + d]`` for every slot of int32 ``nbr
    [K, D]`` -> f32 ``[num_rows, H]``, for f32 ``rows [K * D, H]`` (a
    gradient row a slot, as GAT's attention backward writes them): each
    row's slots summed in slot order, as ``dense_scatter_add`` sums them,
    every row of ``dx`` written once, the zero row ``num_rows - 1`` as
    zeros (its slots are padding, whose rows are not read and may hold
    anything).

    ``plan`` is ``nbr``'s ``ScatterPlan``, which the card's kernel reads in
    place of ``nbr``; on a CPU tensor the plain version runs and a plan is
    only checked. ``dense_scatter_slots.launches`` counts the kernel's
    launches."""
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise TypeError(f"rows must be 2-D float32, got {rows.dim()}-D "
                        f"{rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    _check_nbr(nbr, rows)
    if nbr.shape[0] * nbr.shape[1] != rows.shape[0]:
        raise ValueError(f"nbr has {nbr.shape[0]} x {nbr.shape[1]} slots, "
                         f"rows {rows.shape[0]} rows")
    if not 1 <= num_rows < 2**31:
        raise ValueError(f"num_rows {num_rows} out of [1, 2^31)")
    if plan is not None:
        _check_plan(plan, rows.shape[0], num_rows, rows)
    if rows.device.type == "cpu":
        return dense_scatter_slots_reference(rows, nbr, num_rows)
    if plan is None:
        raise ValueError(
            f"dense_scatter_slots on {rows.device}: the CUDA kernel reads "
            "nbr's plan (ScatterPlan), which the host builds beside nbr: "
            "split GAT's samplers ship it with every dense layer past layer "
            "0 (SplitLayer.scatter_plan; NativeSplitSampler and "
            "SplitSampler with scatter_plans=True), and "
            "slots_plan(nbr.cpu(), num_rows) builds one")
    return _launch_slots(rows, plan, num_rows)


dense_scatter_slots.launches = 0
