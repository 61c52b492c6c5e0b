"""GAT's dense attention: split GAT's local softmax partials through the
dense ``[K, D]`` neighbour matrix, its hand-written Hopper kernels, their
plain versions, and the autograd rule around them.

For an f32 or bf16 frame ``x [S, H]`` whose last row ``S - 1`` is the
reserved zero row that padding slots name, int32 ``nbr [K, D]``, f32
``wl [H, heads]`` (the attention vector ``a_l`` contracted into ``W``),
``w3 [H, heads, Dh]`` and ``er [D, heads]``, ``gat_attention`` computes
for each dst column ``d`` and head ``c``:

* ``z[k, d, c] = leaky_relu(x[nbr[k, d]] . wl[:, c] + er[d, c], 0.2)``
  (the dot and the sum in f64, rounded to f32 once: ``attention_pre``),
  and -inf on padding slots;
* ``m[d, c]``, the max over k (detached), ``pw = exp(z - m)`` (0 on
  padding) and ``s[d, c] = sum_k pw``;
* ``agg[d, c, :] = sum_k pw[k, d, c] * x[nbr[k, d]]`` and ``v[d, c, :] =
  agg[d, c, :] @ w3[:, c, :]``;

and returns f32 ``(m, s, v)``. A column with no valid slot has ``m =
-inf`` and ``s = v = 0``. Under a bf16 frame ``wl`` and ``pw`` are
rounded to bf16 before their products and the sums are taken in f32, as
JAX's bf16 dots with f32 accumulation compute them.

This is JAX's ``occ_gnn_tpu/parallel/model.py:294-363``, the batched
branch of ``SplitGAT.layer`` (its default), which XLA lowers; there is no
``pallas_call`` to port. The plain version, ``gat_attention_reference``,
materialises the ``[K, D, H]`` leaves ``x[nbr]`` and keeps them for the
backward (1.29 GB at split GAT A's layer 0). The kernels,
``csrc/gat_attention.cu``, never write them. Each block of a persistent
grid takes tiles of ``tile`` consecutive dst columns in a static order,
a warp a column; a warp copies every valid slot's leaf row of its column
into shared memory once, by bulk copies (TMA), its next column's copies
in flight while it computes:

* ``gat_attention_fwd`` scores the staged rows (f64 sums, rounded once),
  takes the exact max, the weights and their sum, and writes ``m``, ``s``
  and ``agg [D, heads, H]``, reading each leaf from device memory once;
  the per-head projection ``v = agg @ w3`` is ``torch.einsum`` beside it
  (JAX's own einsum, a large product);
* ``gat_attention_bwd`` stages the leaves and the column's ``dagg`` rows,
  recomputes ``z`` and ``pw`` from the saved ``m``, and writes ``der``,
  one partial of ``dwl`` a block (summed here in a fixed order) and, when
  ``x`` takes a gradient, each valid slot's row of ``dx`` into an f32
  ``[K * D, H]`` workspace, which ``dense_scatter_slots`` sums into
  ``dx`` in slot order through ``nbr``'s plan, the ``plan`` argument of
  ``gat_attention`` that the samplers ship with the batch (padding slots'
  rows are neither written nor read).

The host plans each launch (``attention_plan``) and owns the staged
kernels' shared-memory layout (``layout``), which it passes to them: the
most warps an SM that the blocks' shared memory allows, with a tile that
still gives every SM one. A shape whose column leaves too few warps an
SM (``MIN_STAGED_WARPS``), or does not fit a block at all (wide rows,
many heads or slots), or whose rows are read less than 8 bytes at a time,
takes the ``_any`` kernels: a warp a column
reading its leaves through L1 and L2, the row in tiles of 128 columns,
one ``dwl`` partial a warp. Any row width and head count: heads go
through both in groups of 4.

The autograd Function saves ``x``, ``nbr``, ``wl``, ``er`` and ``m``; the
projection of ``agg`` (``_Projection``) keeps ``agg`` and ``w3`` and gives
``dagg = dv @ w3^T`` and ``dw3 = agg^T dv``, torch products, the latter
summed over chunks of the dst columns.

The leaky ReLU's slope at exactly 0 is torch's (``pre > 0`` takes 1, so 0
takes 0.2), where JAX's ``where(x >= 0, ...)`` takes 1: the port's plain
version and the kernels agree, and differ from JAX only on a score that is
exactly 0. Under a bf16 frame the gradients follow the plain version's
casts: the part of ``dpw`` that comes through the rounded ``pw`` and the
summed ``dwl`` are rounded to bf16, as autograd rounds a gradient that
passes a bf16 tensor. A bf16 ``x`` that takes a gradient gets its
gradient summed in f32 and rounded once (the plain autograd would add
bf16 rows); split GAT's frames past layer 0 are f32.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math

import torch
from torch.nn import functional as F

from occ_gnn_tpu_torch.models.gat import NEGATIVE_SLOPE
from occ_gnn_tpu_torch.ops.build import check_launch, load_kernel
from occ_gnn_tpu_torch.ops.dense_gather_sum import (
    ScatterPlan,
    dense_scatter_slots,
)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# The C entries of csrc/gat_attention.cu, argument for argument.
ARGTYPES = {
    # x, x_bf16, x_rows, h, nbr, k, d, wl, er, heads, slope, layout, tile,
    # grid, m, s, agg, device, stream
    "gat_attention_fwd": [_P, _I, _L, _I, _P, _I, _L, _P, _P, _I, _F, _P,
                          _I, _I, _P, _P, _P, _I, _P],
    # x, x_bf16, x_rows, h, nbr, k, d, wl, er, heads, slope, layout, tile,
    # grid, m, ds, dagg, der, dwl_part, dxg, device, stream
    "gat_attention_bwd": [_P, _I, _L, _I, _P, _I, _L, _P, _P, _I, _F, _P,
                          _I, _I, _P, _P, _P, _P, _P, _P, _I, _P],
    # x, x_bf16, x_rows, h, k, d, heads, layout, tile, backward, device,
    # per_sm
    "gat_attention_occupancy": [_P, _I, _L, _I, _I, _L, _I, _P, _I, _I, _I,
                                _P],
}
# The staged kernels' shared memory, as `layout` plans it and the kernels
# take it (csrc/gat_attention.cu's `Layout`: an int each, in this order).
LAYOUT_FIELDS = ("read", "bulk", "stride", "nvec", "groups", "wunit",
                 "stages", "wl64", "wl32", "rows", "dagg", "ids", "z", "pw",
                 "dwl", "bar", "dstage", "warp", "per_warp", "total")
Layout = collections.namedtuple("Layout", LAYOUT_FIELDS)
# The staged kernels' plan: a block's warps (a dst column of a tile each)
# at most, as the kernels' launch bounds take them; the heads a group (the
# kernels' 4-wide registers); the stages of a warp's ring of staged columns
# (one more of slot ids; a deeper ring, fewer warps, was slower); the warps
# an SM the kernels' registers allow; and a block's (and an SM's, less 1 KB
# a resident block) shared memory on sm_90.
MAX_WARPS = 8
HEAD_GROUP = 4
STAGES = 2
WARPS_AN_SM = 16
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1024
# Where the staged kernels beat the `_any` kernels (`tools/gat_ab.py
# routes` on an H100, PERF.md §6): at least this many warps an SM,
# forward and backward (fewer hide too little of a column's shared-memory
# and f64 latencies: H = 1024 leaves 2 and 1), and a read unit of at least
# this many bytes (bf16 rows of odd width, read 2 or 4 bytes at a time,
# were slower). Any other shape, and one whose column does not fit a
# block, takes the `_any` kernels: 8 warps a block (a column each) and,
# backward, 2 blocks an SM.
MIN_STAGED_WARPS = (4, 2)
MIN_STAGED_READ = 8
ANY_WARPS = 8
ANY_BLOCKS_AN_SM = 2
# The dst columns' chunks (at most) that the projection's weight gradient
# dw3 = agg^T dv is summed over: one [H, D] @ [D, Dh] product a head ran
# on a handful of thread blocks (3.88 ms of split GAT A's 8.35 ms busy
# step on the H100, chip_smoke.py's profiled step), a product a chunk and
# head fills the card.
PROJECTION_CHUNKS = 64
# Leaf rows (at least one leading index of the leaves) a chunk of
# attention_pre's transient f64 product: 105 MB of f64 at H = 100.
PRE_CHUNK_LEAVES = 1 << 17


class _AttentionPre(torch.autograd.Function):
    """``attention_pre``: the f64 product about ``PRE_CHUNK_LEAVES`` leaf
    rows at a time, so no f64 copy of the leaves is kept, and f32
    gradients from the f32 inputs it saves."""

    @staticmethod
    def forward(ctx, xg, wl, er):
        ctx.save_for_backward(xg, wl)
        ctx.er_shape = er.shape
        shape = xg.shape[:-1] + wl.shape[1:]
        er = er.expand(shape)
        wl64 = wl.double()
        out = xg.new_empty(shape, dtype=torch.float32)
        step = max(1, PRE_CHUNK_LEAVES // max(1, math.prod(shape[1:-1])))
        for i in range(0, shape[0], step):
            j = i + step
            out[i:j] = (xg[i:j].double() @ wl64 + er[i:j].double()).float()
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xg, wl = ctx.saved_tensors
        dxg = dwl = der = None
        if ctx.needs_input_grad[0]:
            dxg = g @ wl.t()
        if ctx.needs_input_grad[1]:
            dwl = xg.reshape(-1, xg.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[2]:
            der = g.sum_to_size(ctx.er_shape)
        return dxg, dwl, der


def attention_pre(xg: torch.Tensor, wl: torch.Tensor,
                  er: torch.Tensor) -> torch.Tensor:
    """The scores' pre-activations ``xg @ wl + er`` (``er`` broadcast to
    the product), their products and sums in f64, rounded to f32 once.
    Every form of the attention in the port (the kernels, the plain
    version, the lowerings) computes them so, and so takes the same leaky
    ReLU slope at a score near 0, where f32 sums in two orders can fall on
    either side of it; any two f64 orders round to the same f32 but within
    about 2^-40 of a value of a rounding boundary. JAX sums in f32: the
    scores differ from its by that rounding. The f64 product is transient
    (``PRE_CHUNK_LEAVES`` leaf rows at a time); the gradients are f32
    products, as autograd of the f32 form computes them."""
    return _AttentionPre.apply(xg, wl, er)


def attention_scores(x: torch.Tensor, nbr: torch.Tensor, wl: torch.Tensor,
                     er: torch.Tensor):
    """The batched form's leaves and softmax weights, differentiable: the
    f32 leaves ``xg [K, D, H]``, the weights ``pw [K, D, heads]`` (0 on
    padding) and the detached max ``m [D, heads]``. Under a bf16 frame
    ``wl`` is rounded to bf16 before the product."""
    K, D = nbr.shape
    xg = x.index_select(0, nbr.reshape(-1)).reshape(K, D, -1)
    valid = (nbr != x.shape[0] - 1)[..., None]
    if x.dtype != torch.float32:
        wl = wl.to(x.dtype).float()
        xg = xg.float()
    z = F.leaky_relu(attention_pre(xg, wl, er[None]), NEGATIVE_SLOPE)
    m = z.detach().masked_fill(~valid, float("-inf")).amax(dim=0)
    safe = torch.where(torch.isfinite(m), m, 0.0)
    pw = torch.exp((z - safe[None]).masked_fill(~valid, float("-inf")))
    return xg, pw, m


def _partials_reference(x, nbr, wl, er):
    """``(m, s, agg)`` of the plain version."""
    xg, pw, m = attention_scores(x, nbr, wl, er)
    s = pw.sum(dim=0)
    if x.dtype != torch.float32:
        pw = pw.to(x.dtype).float()
    return m, s, torch.einsum("kdc,kdh->dch", pw, xg)


def gat_attention_reference(x: torch.Tensor, nbr: torch.Tensor,
                            wl: torch.Tensor, w3: torch.Tensor,
                            er: torch.Tensor):
    """Plain version, differentiable by autograd: the leaves gathered
    whole, the exact softmax over K, the weighted sum in leaf space per
    head, then the per-head projection. Returns f32 ``(m, s, v)``."""
    m, s, agg = _partials_reference(x, nbr, wl, er)
    return m, s, torch.einsum("dch,hco->dco", agg, w3)


def gat_attention_backward_reference(x: torch.Tensor, nbr: torch.Tensor,
                                     wl: torch.Tensor, er: torch.Tensor,
                                     m: torch.Tensor, ds: torch.Tensor,
                                     dagg: torch.Tensor, need_dx: bool):
    """Plain version of the backward kernel, term by term: from the
    forward's inputs, its max ``m`` and the gradients ``ds [D, heads]``
    and ``dagg [D, heads, H]``, returns ``(dxg, dwl, der)``: each slot's
    gradient row ``dxg [K * D, H]`` at ``k * D + d`` (zero on padding
    slots here, where the kernel leaves them unwritten; None unless
    ``need_dx``), ``dwl [H, heads]`` and ``der [D, heads]``, all f32."""
    K, D = nbr.shape
    S, H = x.shape
    low = x.dtype != torch.float32
    xg = x.index_select(0, nbr.reshape(-1)).reshape(K, D, H).float()
    valid = (nbr != S - 1)[..., None]
    wl_c = wl.to(x.dtype).float() if low else wl
    pre = attention_pre(xg, wl_c, er[None])             # [K, D, heads]
    z = torch.where(pre > 0, pre, NEGATIVE_SLOPE * pre)
    safe = torch.where(torch.isfinite(m), m, 0.0)
    pw = torch.exp((z - safe[None]).masked_fill(~valid, float("-inf")))
    # dagg . leaf, rounded to bf16 where the forward rounded pw.
    t = torch.einsum("dch,kdh->kdc", dagg, xg)
    if low:
        t = t.to(x.dtype).float()
    dpre = pw * (ds[None] + t) * torch.where(pre > 0, 1.0, NEGATIVE_SLOPE)
    der = dpre.sum(dim=0)
    dwl = torch.einsum("kdh,kdc->hc", xg, dpre)
    if low:
        dwl = dwl.to(x.dtype).float()
    dxg = None
    if need_dx:
        pw_c = pw.to(x.dtype).float() if low else pw
        dxg = (torch.einsum("kdc,dch->kdh", pw_c, dagg)
               + dpre @ wl_c.t()).reshape(K * D, H)
    return dxg, dwl, der


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def row_layout(H: int, elt: int, x_align: int = 16):
    """How the staged kernels stage a leaf row: ``(read, bulk, stride,
    nvec)``, the read unit (the widest of 16, 8, 4 and 2 bytes that divides
    the row's bytes and the frame's address alignment ``x_align``), whether
    rows go by bulk copies of their 16-byte-aligned windows (rows of 16
    bytes or more; such a window starts up to ``16 - read`` bytes before
    its row), the bytes between staged rows (an odd number of 16 bytes:
    lanes reading one 16-byte unit of different rows hit different banks)
    and the read units a row."""
    rowbytes = H * elt
    read = 16
    while read > 2 and (rowbytes % read or x_align % read):
        read //= 2
    bulk = rowbytes >= 16
    window = _a16(rowbytes + (16 - read if bulk and read < 16 else 0))
    return read, bulk, ((window // 16) | 1) * 16, rowbytes // read


def layout(K: int, H: int, heads: int, elt: int, tile: int, backward: bool,
           x_align: int = 16) -> Layout:
    """A staged kernel's shared memory for a tile of ``tile`` columns, in
    bytes from its start: wl in f64 a head group, a read unit's elements'
    heads padded by 16 bytes (``wunit`` doubles a unit), and backward wl
    in f32 too; then for each of the tile's warps (``per_warp`` bytes from
    ``warp`` on) its ring of staged rows (and, backward, of its column's
    dagg), its ring of slot ids, its scores (backward: dpre and pw),
    backward its dwl partial, and the mbarriers of its bulk copies."""
    read, bulk, stride, nvec = row_layout(H, elt, x_align)
    groups = -(-heads // HEAD_GROUP)
    groups_h = _a16(4 * groups * H * HEAD_GROUP)
    slots = _a16(4 * K * groups * HEAD_GROUP)
    dstage = _a16(4 * heads * H)
    rows = 0
    dagg = rows + _a16(STAGES * K * stride)
    ids = dagg + (STAGES * dstage if backward else 0)
    z = ids + _a16(4 * (STAGES + 1) * K)
    pw = z + slots
    dwl = pw + (slots if backward else 0)
    bar = dwl + (groups_h if backward else 0)
    per_warp = bar + _a16(8 * STAGES)
    wunit = read // elt * HEAD_GROUP + 2
    wl32 = _a16(8 * groups * nvec * wunit)
    warp = wl32 + (groups_h if backward else 0)
    return Layout(read, int(bulk), stride, nvec, groups, wunit, STAGES, 0,
                  wl32, rows, dagg, ids, z, pw, dwl, bar, dstage, warp,
                  per_warp, warp + tile * per_warp)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's plan. The staged kernels (``layout`` set): ``tile``
    columns a tile (a warp each), ``per_sm`` blocks an SM that their shared
    memory allows, ``grid`` blocks (block b takes tiles b, b + grid, ...),
    a dwl partial a block. The ``_any`` kernels (``layout`` None): ``grid``
    blocks of ``tile`` warps, a column each (block b takes tiles b, b +
    grid, ...: the forward's a tile each), a dwl partial a warp."""
    tile: int
    per_sm: int
    grid: int
    layout: Layout | None

    @property
    def partials(self) -> int:
        return self.grid if self.layout is not None else self.grid * self.tile

    @property
    def warps_an_sm(self) -> int:
        return self.per_sm * self.tile


def staged_plan(K: int, H: int, heads: int, elt: int, D: int, sms: int,
                backward: bool, x_align: int = 16) -> Plan | None:
    """The staged kernels' plan: the most warps an SM (at most
    ``WARPS_AN_SM``), then the widest tile, whose blocks' shared memory
    fits the SM, with a tile of at most ``MAX_WARPS`` columns and at most
    ``D // sms``, so that every SM gets a tile; None if one column does not
    fit a block."""
    cap = max(1, min(MAX_WARPS, D // sms))
    best = None
    for per_sm in range(1, WARPS_AN_SM + 1):
        limit = min(SMEM_BLOCK, SMEM_SM // per_sm - SMEM_RESERVED)
        for tile in range(min(cap, WARPS_AN_SM // per_sm), 0, -1):
            lay = layout(K, H, heads, elt, tile, backward, x_align)
            if lay.total <= limit:
                plan = Plan(tile, per_sm, min(-(-D // tile), per_sm * sms),
                            lay)
                if best is None or ((plan.warps_an_sm, tile)
                                    > (best.warps_an_sm, best.tile)):
                    best = plan
                break
    return best


@functools.cache
def attention_plan(K: int, H: int, heads: int, elt: int, D: int, sms: int,
                   backward: bool, x_align: int = 16) -> Plan:
    """The staged kernels' plan where it puts ``MIN_STAGED_WARPS`` warps on
    an SM and reads ``MIN_STAGED_READ`` bytes at a time, else the ``_any``
    kernels'. Cached: a training run plans the same few shapes every
    step."""
    plan = staged_plan(K, H, heads, elt, D, sms, backward, x_align)
    if (plan is not None and plan.warps_an_sm >= MIN_STAGED_WARPS[backward]
            and plan.layout.read >= MIN_STAGED_READ):
        return plan
    return any_plan(D, sms, backward)


def any_plan(D: int, sms: int, backward: bool) -> Plan:
    """The ``_any`` kernels' plan: the forward a block for each
    ``ANY_WARPS`` columns, the backward at most ``ANY_BLOCKS_AN_SM`` blocks
    an SM, strided over the columns."""
    tiles = -(-D // ANY_WARPS)
    return Plan(ANY_WARPS, ANY_BLOCKS_AN_SM,
                min(tiles, ANY_BLOCKS_AN_SM * sms) if backward else tiles,
                None)


def _align(t: torch.Tensor) -> int:
    p = t.data_ptr() % 16
    return 16 if p == 0 else p & -p


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(x: torch.Tensor, nbr: torch.Tensor, heads: int,
          backward: bool) -> Plan:
    K, D = nbr.shape
    return attention_plan(K, x.shape[1], heads, x.element_size(), D,
                          _sms(x.device), backward, _align(x))


@functools.cache
def _c_layout(lay: Layout | None):
    """The layout as the C entries take it: a host array of its ints, in
    LAYOUT_FIELDS' order (None: the ``_any`` kernels). Cached, so that the
    array outlives the launch."""
    return None if lay is None else (ctypes.c_int * len(lay))(*lay)


def blocks_an_sm(x: torch.Tensor, nbr: torch.Tensor, heads: int,
                 backward: bool, plan: Plan) -> int:
    """The blocks of a staged plan's kernel that one SM of x's card holds
    at once (its shared memory, registers and threads), as the runtime
    counts them; the plan counts on ``plan.per_sm``."""
    _on_cuda(x)
    K, D = nbr.shape
    lib = _library()
    out = ctypes.c_int(0)
    err = lib.gat_attention_occupancy(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], x.shape[1],
        K, D, heads, _c_layout(plan.layout), plan.tile, int(backward),
        x.device.index, ctypes.addressof(out))
    check_launch(lib, err, "gat_attention_occupancy")
    return out.value


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_kernel("gat_attention")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the gat_attention kernels run on CUDA tensors, "
                         f"got {x.device}")


def gat_attention_fwd(x: torch.Tensor, nbr: torch.Tensor, wl: torch.Tensor,
                      er: torch.Tensor):
    """The forward's partials ``(m, s, agg)``, f32 ``[D, heads]``, ``[D,
    heads]`` and ``[D, heads, H]``, without autograd: the plain version on
    the CPU, one kernel launch on the card.
    ``gat_attention_fwd.launches`` counts the launches."""
    if x.device.type == "cpu":
        with torch.no_grad():
            return _partials_reference(x, nbr, wl, er)
    K, D = nbr.shape
    H, heads = wl.shape
    _on_cuda(x)
    m = torch.empty((D, heads), dtype=torch.float32, device=x.device)
    s = torch.empty_like(m)
    agg = torch.empty((D, heads, H), dtype=torch.float32, device=x.device)
    if D == 0:
        return m, s, agg
    plan = _plan(x, nbr, heads, False)
    lib = _library()
    err = lib.gat_attention_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], H,
        nbr.data_ptr(), K, D, wl.data_ptr(), er.data_ptr(), heads,
        NEGATIVE_SLOPE, _c_layout(plan.layout), plan.tile, plan.grid,
        m.data_ptr(), s.data_ptr(),
        agg.data_ptr(), x.device.index, _stream(x))
    check_launch(lib, err, "gat_attention_fwd")
    gat_attention_fwd.launches += 1
    return m, s, agg


gat_attention_fwd.launches = 0


def gat_attention_bwd(x: torch.Tensor, nbr: torch.Tensor, wl: torch.Tensor,
                      er: torch.Tensor, m: torch.Tensor, ds: torch.Tensor,
                      dagg: torch.Tensor, need_dx: bool):
    """The backward's ``(dxg, dwl, der)`` as
    ``gat_attention_backward_reference`` returns them: the plain version on
    the CPU, one kernel launch on the card (its ``dwl`` partials, one a
    block or a warp, summed here; ``dxg``'s rows of padding slots left unwritten).
    ``gat_attention_bwd.launches`` counts the launches."""
    if x.device.type == "cpu":
        return gat_attention_backward_reference(x, nbr, wl, er, m, ds, dagg,
                                                need_dx)
    K, D = nbr.shape
    H, heads = wl.shape
    _on_cuda(x)
    der = torch.empty((D, heads), dtype=torch.float32, device=x.device)
    dxg = (torch.empty((K * D, H), dtype=torch.float32, device=x.device)
           if need_dx else None)
    if D == 0:
        if dxg is not None:
            dxg.zero_()
        return dxg, wl.new_zeros((H, heads)), der
    if K * D >= 2**31:
        raise ValueError(f"{K} x {D} slots: slot ids past int32")
    plan = _plan(x, nbr, heads, True)
    part = torch.empty((plan.partials, H, heads), dtype=torch.float32,
                       device=x.device)
    lib = _library()
    err = lib.gat_attention_bwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], H,
        nbr.data_ptr(), K, D, wl.data_ptr(), er.data_ptr(), heads,
        NEGATIVE_SLOPE, _c_layout(plan.layout), plan.tile, plan.grid,
        m.data_ptr(), ds.data_ptr(),
        dagg.data_ptr(), der.data_ptr(), part.data_ptr(),
        None if dxg is None else dxg.data_ptr(), x.device.index, _stream(x))
    check_launch(lib, err, "gat_attention_bwd")
    gat_attention_bwd.launches += 1
    dwl = part.sum(dim=0)
    if x.dtype != torch.float32:
        dwl = dwl.to(x.dtype).float()
    return dxg, dwl, der


gat_attention_bwd.launches = 0


class _Projection(torch.autograd.Function):
    """``v = einsum("dch,hco->dco", agg, w3)``, the per-head projection;
    its backward's ``dw3`` sums over the dst columns in
    ``gcd(D, PROJECTION_CHUNKS)`` chunks of products, then adds them."""

    @staticmethod
    def forward(ctx, agg, w3):
        ctx.save_for_backward(agg, w3)
        return torch.einsum("dch,hco->dco", agg, w3)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dv):
        agg, w3 = ctx.saved_tensors
        dagg = dw3 = None
        if ctx.needs_input_grad[0]:
            dagg = torch.einsum("dco,hco->dch", dv, w3)
        if ctx.needs_input_grad[1]:
            D, heads, H = agg.shape
            n = math.gcd(D, PROJECTION_CHUNKS)
            dw3 = torch.einsum(
                "ndch,ndco->nhco", agg.reshape(n, D // n, heads, H),
                dv.reshape(n, D // n, heads, dv.shape[-1])).sum(dim=0)
        return dagg, dw3


class _GatAttention(torch.autograd.Function):
    """``(m, s, agg)``, ``m`` not differentiable. Saves ``x``, ``nbr``,
    ``wl``, ``er`` and ``m``, never the leaves, and keeps ``nbr``'s
    ``plan``; the backward recomputes the scores and, when ``x`` takes a
    gradient, sums the slots' rows into ``dx`` with
    ``dense_scatter_slots`` through the plan."""

    @staticmethod
    def forward(ctx, x, nbr, wl, er, plan):
        m, s, agg = gat_attention_fwd(x, nbr, wl, er)
        ctx.save_for_backward(x, nbr, wl, er, m)
        ctx.plan = plan
        ctx.mark_non_differentiable(m)
        return m, s, agg

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dm, ds, dagg):
        x, nbr, wl, er, m = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        dxg, dwl, der = gat_attention_bwd(x, nbr, wl, er, m, ds.contiguous(),
                                          dagg.contiguous(), need_dx)
        dx = None
        if need_dx:
            dx = dense_scatter_slots(dxg, nbr, x.shape[0],
                                     ctx.plan).to(x.dtype)
        return dx, None, dwl, der, None


def _check(x, nbr, wl, w3, er) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"x must be 2-D float32 or bfloat16, got {x.dim()}-D "
                        f"{x.dtype}")
    if nbr.dtype != torch.int32 or nbr.dim() != 2 or nbr.shape[0] < 1:
        raise TypeError(f"nbr must be int32 [K >= 1, D], got {nbr.dtype} "
                        f"{list(nbr.shape)}")
    H = x.shape[1]
    heads = wl.shape[1] if wl.dim() == 2 else -1
    D = nbr.shape[1]
    for name, t, shape in (("wl", wl, (H, heads)),
                           ("w3", w3, (H, heads, w3.shape[-1])),
                           ("er", er, (D, heads))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be float32 {list(shape)}, got "
                            f"{t.dtype} {list(t.shape)}")
    for name, t in (("x", x), ("nbr", nbr), ("wl", wl), ("er", er)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape[0] >= 2**31 or D >= 2**31:
        raise ValueError(f"{x.shape[0]} rows and {D} columns: past int32")


def gat_attention(x: torch.Tensor, nbr: torch.Tensor, wl: torch.Tensor,
                  w3: torch.Tensor, er: torch.Tensor,
                  plan: ScatterPlan | None = None):
    """GAT's local softmax partials through the dense neighbour matrix:
    f32 ``(m [D, heads], s [D, heads], v [D, heads, Dh])`` for an f32 or
    bf16 frame ``x [S, H]`` (its row ``S - 1`` the zero row padding slots
    name), int32 ``nbr [K, D]``, f32 ``wl [H, heads]``, ``w3 [H, heads,
    Dh]`` and ``er [D, heads]``. Differentiable in ``x``, ``wl``, ``w3``
    and ``er``; ``m`` is not. ``plan`` is ``nbr``'s ``ScatterPlan``
    (``ops.dense_gather_sum``), which the gradient to ``x`` needs on the
    card.

    Every ``nbr`` entry must be a row of ``x``; on the card one out of
    range stops the kernel with a device-side assert (JAX clamps it)."""
    wl, er = wl.contiguous(), er.contiguous()
    _check(x, nbr, wl, w3, er)
    m, s, agg = _GatAttention.apply(x, nbr, wl, er, plan)
    return m, s, _Projection.apply(agg, w3)
