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

The layer's tail, ``gat_tail``, turns the (merged) partials into the
layer's output at its owned rows: ``v / max(s, 1e-16)`` at the owned
rows, then the bias and ELU on a hidden layer, the heads' mean on the
last, zeros at the pads; one kernel each way on the card
(``gat_tail_fwd``, ``gat_tail_bwd``), where the model ran a chain of
torch ops and their autograd backwards. The kernels take the owned rows
as the dst frame's prefix (owned row o is dst row o wherever it is
valid), as every layer builder makes them. The forward reads ``v`` through
its strides (the projection's head-major result, in place) and gives
the chain's bits; the backward writes ``dv`` in ``v``'s layout, every
row (zeros where no owned row names it), ``ds`` and the bias's gradient
as a partial a block, summed here in a fixed order.

UniMP's query-key attention, ``qk_attention``, takes the same pipeline
with a score vector per dst column and head: for an f32 frame ``x``,
``nbr`` and ``u [D, heads, H]`` (``W_k,c^T q[d, c] / sqrt(dh)``, in any
layout with unit stride along ``H``), ``z[k, d, c] = x[nbr[k, d]] .
u[d, c, :]`` (f64 sums rounded to f32 once, -inf on padding slots, no
leaky ReLU), then ``m``, ``s`` and ``agg`` as above and ``v = agg @ wv``
by ``_Projection``. The kernels ``qk_attn_fwd`` / ``qk_attn_bwd`` are the
staged kernels with the column's ``u`` staged beside its rows (the
backward writes ``du [D, heads, H] = sum_k dpre * leaf`` in ``u``'s
layout where GAT's sums ``dwl``, and reads ``u`` where GAT's read ``wl``
for ``dx``), and their ``_any`` forms where the plan finds too few warps
an SM (wide rows); ``qk_attention_counts()`` counts their launches by
path and direction.

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
    dense_scatter_slots_reference,
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
    # v, v_row, v_head, s, owned_mask, b, d, o, heads, dh, last, scale,
    # vec, grid, y, device, stream
    "gat_tail_fwd": [_P, _L, _L, _P, _P, _P, _L, _L, _I, _I, _I, _F, _I, _I,
                     _P, _I, _P],
    # dy, v, v_row, v_head, s, owned_mask, b, d, o, heads, dh, last, scale,
    # vec, grid, dv, dv_row, dv_head, ds, db_part, device, stream
    "gat_tail_bwd": [_P, _P, _L, _L, _P, _P, _P, _L, _L, _I, _I, _I, _F, _I,
                     _I, _P, _L, _L, _P, _P, _I, _P],
    # backward, last, vec, heads, dh, device, per_sm
    "gat_tail_occupancy": [_I, _I, _I, _I, _I, _I, _P],
    # x, x_rows, h, nbr, k, d, u, u_row, u_head, heads, layout, tile, grid,
    # m, s, agg, device, stream
    "qk_attn_fwd": [_P, _L, _I, _P, _I, _L, _P, _L, _L, _I, _P, _I, _I, _P,
                    _P, _P, _I, _P],
    # x, x_rows, h, nbr, k, d, u, u_row, u_head, heads, layout, tile, grid,
    # m, ds, dagg, du, dxg, device, stream
    "qk_attn_bwd": [_P, _L, _I, _P, _I, _L, _P, _L, _L, _I, _P, _I, _I, _P,
                    _P, _P, _P, _P, _I, _P],
}
# The staged kernels' shared memory, as `layout` plans it and the kernels
# take it (csrc/gat_attention.cu's `Layout`: an int each, in this order).
LAYOUT_FIELDS = ("read", "bulk", "stride", "nvec", "groups", "wunit",
                 "stages", "wl64", "wl32", "rows", "u", "dagg", "ids", "z",
                 "pw", "dwl", "bar", "dstage", "warp", "per_warp", "total")
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
           x_align: int = 16, qk: bool = False) -> Layout:
    """A staged kernel's shared memory for a tile of ``tile`` columns, in
    bytes from its start: wl in f64 a head group, a read unit's elements'
    heads padded by 16 bytes (``wunit`` doubles a unit), and backward wl
    in f32 too; then for each of the tile's warps (``per_warp`` bytes from
    ``warp`` on) its ring of staged rows (and, ``qk``, of its column's u;
    backward, of its dagg), its ring of slot ids, its scores (backward:
    dpre and pw), backward its dwl partial, and the mbarriers of its bulk
    copies. ``qk`` (UniMP's kernels) keeps no wl and no dwl partial."""
    read, bulk, stride, nvec = row_layout(H, elt, x_align)
    groups = -(-heads // HEAD_GROUP)
    groups_h = _a16(4 * groups * H * HEAD_GROUP)
    slots = _a16(4 * K * groups * HEAD_GROUP)
    dstage = _a16(4 * heads * H)
    rows = 0
    u = rows + _a16(STAGES * K * stride)
    dagg = u + (STAGES * dstage if qk else 0)
    ids = dagg + (STAGES * dstage if backward else 0)
    z = ids + _a16(4 * (STAGES + 1) * K)
    pw = z + slots
    dwl = pw + (slots if backward else 0)
    bar = dwl + (groups_h if backward and not qk else 0)
    per_warp = bar + _a16(8 * STAGES)
    wunit = read // elt * HEAD_GROUP + 2
    wl32 = 0 if qk else _a16(8 * groups * nvec * wunit)
    warp = 0 if qk else wl32 + (groups_h if backward else 0)
    return Layout(read, int(bulk), stride, nvec, groups, wunit, STAGES, 0,
                  wl32, rows, u, dagg, ids, z, pw, dwl, bar, dstage, warp,
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
                backward: bool, x_align: int = 16,
                qk: bool = False) -> Plan | None:
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
            lay = layout(K, H, heads, elt, tile, backward, x_align, qk)
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
                   backward: bool, x_align: int = 16,
                   qk: bool = False) -> Plan:
    """The staged kernels' plan where it puts ``MIN_STAGED_WARPS`` warps on
    an SM and reads ``MIN_STAGED_READ`` bytes at a time, else the ``_any``
    kernels'; ``qk`` plans UniMP's. Cached: a training run plans the same
    few shapes every step."""
    plan = staged_plan(K, H, heads, elt, D, sms, backward, x_align, qk)
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
          backward: bool, qk: bool = False) -> Plan:
    K, D = nbr.shape
    return attention_plan(K, x.shape[1], heads, x.element_size(), D,
                          _sms(x.device), backward, _align(x), qk)


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


# UniMP's query-key attention (``qk_attention``).


class _QkPre(torch.autograd.Function):
    """The scores ``xg [K, D, H] . u [D, heads, H]`` per head, summed in
    f64 about ``PRE_CHUNK_LEAVES`` leaf rows at a time and rounded once to
    the leaves' type; the gradients are products in that type."""

    @staticmethod
    def forward(ctx, xg, u):
        ctx.save_for_backward(xg, u)
        K, D = xg.shape[:2]
        out = xg.new_empty((K, D, u.shape[1]))
        u64 = u.double()
        step = max(1, PRE_CHUNK_LEAVES // max(1, D))
        for i in range(0, K, step):
            out[i:i + step] = torch.einsum(
                "kdh,dch->kdc", xg[i:i + step].double(), u64).to(xg.dtype)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xg, u = ctx.saved_tensors
        dxg = du = None
        if ctx.needs_input_grad[0]:
            dxg = torch.einsum("kdc,dch->kdh", g, u)
        if ctx.needs_input_grad[1]:
            du = torch.einsum("kdc,kdh->dch", g, xg)
        return dxg, du


def _qk_partials_reference(x, nbr, u):
    """``(m, s, agg)`` of the plain version, differentiable in ``x`` and
    ``u``, in ``x``'s type; ``m`` detached."""
    K, D = nbr.shape
    xg = x.index_select(0, nbr.reshape(-1)).reshape(K, D, -1)
    valid = (nbr != x.shape[0] - 1)[..., None]
    z = _QkPre.apply(xg, u)
    m = z.detach().masked_fill(~valid, float("-inf")).amax(dim=0)
    safe = torch.where(torch.isfinite(m), m, 0.0)
    pw = torch.exp((z - safe[None]).masked_fill(~valid, float("-inf")))
    return m, pw.sum(dim=0), torch.einsum("kdc,kdh->dch", pw, xg)


def qk_attention_reference(x: torch.Tensor, nbr: torch.Tensor,
                           u: torch.Tensor, wv: torch.Tensor):
    """Plain version, differentiable by autograd: the leaves gathered
    whole, the exact softmax over K, the weighted sum in leaf space per
    head, then the per-head projection ``wv [H, heads, dh]``. Returns
    ``(m, s, v)``."""
    m, s, agg = _qk_partials_reference(x, nbr, u)
    return m, s, torch.einsum("dch,hco->dco", agg, wv)


def qk_attention_backward_reference(x: torch.Tensor, nbr: torch.Tensor,
                                    u: torch.Tensor, m: torch.Tensor,
                                    ds: torch.Tensor, dagg: torch.Tensor,
                                    need_dx: bool):
    """Plain version of the backward kernel, term by term: from the
    forward's inputs, its max ``m`` and the gradients ``ds [D, heads]``
    and ``dagg [D, heads, H]``, returns ``(dxg, du)``: each slot's gradient
    row ``dxg [K * D, H]`` at ``k * D + d`` (zero on padding slots here,
    where the kernel leaves them unwritten; None unless ``need_dx``) and
    ``du [D, heads, H]``, in ``x``'s type."""
    K, D = nbr.shape
    S, H = x.shape
    xg = x.index_select(0, nbr.reshape(-1)).reshape(K, D, H)
    valid = (nbr != S - 1)[..., None]
    with torch.no_grad():
        pre = _QkPre.apply(xg, u)
    safe = torch.where(torch.isfinite(m), m, 0.0)
    pw = torch.exp((pre - safe[None]).masked_fill(~valid, float("-inf")))
    dpre = pw * (ds[None] + torch.einsum("dch,kdh->kdc", dagg, xg))
    du = torch.einsum("kdc,kdh->dch", dpre, xg)
    dxg = None
    if need_dx:
        dxg = (torch.einsum("kdc,dch->kdh", pw, dagg)
               + torch.einsum("kdc,dch->kdh", dpre, u)).reshape(K * D, H)
    return dxg, du


# The qk kernels' launches in this process, by direction and path.
_QK_LAUNCHES = collections.Counter()


def qk_attention_counts() -> dict:
    """The qk kernels' launches in this process: ``fwd_staged``,
    ``fwd_any``, ``bwd_staged`` and ``bwd_any``."""
    return {f"{d}_{p}": _QK_LAUNCHES[d, p] for d in ("fwd", "bwd")
            for p in ("staged", "any")}


def reset_qk_attention_counts() -> None:
    """Set every count of ``qk_attention_counts()`` to 0."""
    _QK_LAUNCHES.clear()


def _qk_u(u: torch.Tensor, plan: Plan) -> torch.Tensor:
    """``u`` as the kernels take it: unit stride along H, and the other
    strides whole read units (the staged kernels write ``du`` a unit at a
    time through them)."""
    unit = plan.layout.read // 4 if plan.layout is not None else 1
    if u.stride(-1) != 1 or u.stride(0) % unit or u.stride(1) % unit:
        return u.contiguous()
    return u


def qk_attn_fwd(x: torch.Tensor, nbr: torch.Tensor, u: torch.Tensor):
    """The forward's partials ``(m, s, agg)``, f32 ``[D, heads]``, ``[D,
    heads]`` and ``[D, heads, H]``, without autograd: the plain version on
    the CPU, one kernel launch on the card."""
    if x.device.type == "cpu":
        with torch.no_grad():
            return _qk_partials_reference(x, nbr, u)
    K, D = nbr.shape
    heads, H = u.shape[1:]
    _on_cuda(x)
    m = torch.empty((D, heads), dtype=torch.float32, device=x.device)
    s = torch.empty_like(m)
    agg = torch.empty((D, heads, H), dtype=torch.float32, device=x.device)
    if D == 0:
        return m, s, agg
    plan = _plan(x, nbr, heads, False, qk=True)
    u = _qk_u(u, plan)
    lib = _library()
    err = lib.qk_attn_fwd(
        x.data_ptr(), x.shape[0], H, nbr.data_ptr(), K, D, u.data_ptr(),
        u.stride(0), u.stride(1), heads, _c_layout(plan.layout), plan.tile,
        plan.grid, m.data_ptr(), s.data_ptr(), agg.data_ptr(),
        x.device.index, _stream(x))
    check_launch(lib, err, "qk_attn_fwd")
    _QK_LAUNCHES["fwd", "any" if plan.layout is None else "staged"] += 1
    return m, s, agg


def qk_attn_bwd(x: torch.Tensor, nbr: torch.Tensor, u: torch.Tensor,
                m: torch.Tensor, ds: torch.Tensor, dagg: torch.Tensor,
                need_dx: bool):
    """The backward's ``(dxg, du)`` as ``qk_attention_backward_reference``
    returns them: the plain version on the CPU, one kernel launch on the
    card (``du`` in ``u``'s layout; ``dxg``'s rows of padding slots left
    unwritten)."""
    if x.device.type == "cpu":
        return qk_attention_backward_reference(x, nbr, u, m, ds, dagg,
                                               need_dx)
    K, D = nbr.shape
    heads, H = u.shape[1:]
    _on_cuda(x)
    dxg = (torch.empty((K * D, H), dtype=torch.float32, device=x.device)
           if need_dx else None)
    if D == 0:
        if dxg is not None:
            dxg.zero_()
        return dxg, torch.zeros_like(u)
    if K * D >= 2**31:
        raise ValueError(f"{K} x {D} slots: slot ids past int32")
    plan = _plan(x, nbr, heads, True, qk=True)
    u = _qk_u(u, plan)
    du = torch.empty_strided(u.shape, u.stride(), dtype=torch.float32,
                             device=x.device)
    lib = _library()
    err = lib.qk_attn_bwd(
        x.data_ptr(), x.shape[0], H, nbr.data_ptr(), K, D, u.data_ptr(),
        u.stride(0), u.stride(1), heads, _c_layout(plan.layout), plan.tile,
        plan.grid, m.data_ptr(), ds.data_ptr(), dagg.data_ptr(),
        du.data_ptr(), None if dxg is None else dxg.data_ptr(),
        x.device.index, _stream(x))
    check_launch(lib, err, "qk_attn_bwd")
    _QK_LAUNCHES["bwd", "any" if plan.layout is None else "staged"] += 1
    return dxg, du


class _QkAttention(torch.autograd.Function):
    """``(m, s, agg)`` of UniMP's attention, ``m`` not differentiable.
    Saves ``x``, ``nbr``, ``u`` and ``m``, never the leaves; the backward
    recomputes the scores and, when ``x`` takes a gradient, sums the
    slots' rows into ``dx`` through ``nbr``'s plan (an f64 frame, which
    only the CPU's gradient checks give, by the plain sum)."""

    @staticmethod
    def forward(ctx, x, nbr, u, plan):
        m, s, agg = qk_attn_fwd(x, nbr, u)
        ctx.save_for_backward(x, nbr, u, m)
        ctx.plan = plan
        ctx.mark_non_differentiable(m)
        return m, s, agg

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dm, ds, dagg):
        x, nbr, u, m = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        dxg, du = qk_attn_bwd(x, nbr, u, m, ds.contiguous(),
                              dagg.contiguous(), need_dx)
        dx = None
        if need_dx and dxg.dtype == torch.float32:
            dx = dense_scatter_slots(dxg, nbr, x.shape[0], ctx.plan)
        elif need_dx:
            dx = dense_scatter_slots_reference(dxg, nbr, x.shape[0])
        return dx, None, du, None


def qk_attention(x: torch.Tensor, nbr: torch.Tensor, u: torch.Tensor,
                 wv: torch.Tensor, plan: ScatterPlan | None = None):
    """UniMP's local softmax partials through the dense neighbour matrix:
    f32 ``(m [D, heads], s [D, heads], v [D, heads, dh])`` for an f32
    frame ``x [S, H]`` (its row ``S - 1`` the zero row padding slots
    name), int32 ``nbr [K, D]``, f32 ``u [D, heads, H]`` (each dst
    column's score vectors, in any layout) and ``wv [H, heads, dh]``.
    Differentiable in ``x``, ``u`` and ``wv``; ``m`` is not. ``plan`` is
    ``nbr``'s ``ScatterPlan``, which the gradient to ``x`` needs on the
    card."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"x must be 2-D float32, got {x.dim()}-D {x.dtype}")
    if nbr.dtype != torch.int32 or nbr.dim() != 2 or nbr.shape[0] < 1:
        raise TypeError(f"nbr must be int32 [K >= 1, D], got {nbr.dtype} "
                        f"{list(nbr.shape)}")
    D, H = nbr.shape[1], x.shape[1]
    if (u.dtype != torch.float32 or u.dim() != 3 or u.shape[0] != D
            or u.shape[2] != H):
        raise TypeError(f"u must be float32 [{D}, heads, {H}], got "
                        f"{u.dtype} {list(u.shape)}")
    if (wv.dtype != torch.float32 or wv.dim() != 3
            or tuple(wv.shape[:2]) != (H, u.shape[1])):
        raise TypeError(f"wv must be float32 [{H}, {u.shape[1]}, dh], got "
                        f"{wv.dtype} {list(wv.shape)}")
    for name, t in (("nbr", nbr), ("u", u), ("wv", wv)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and nbr.is_contiguous()):
        raise ValueError("x and nbr must be contiguous")
    if x.shape[0] >= 2**31 or D >= 2**31:
        raise ValueError(f"{x.shape[0]} rows and {D} columns: past int32")
    m, s, agg = _QkAttention.apply(x, nbr, u, plan)
    return m, s, _Projection.apply(agg, wv)


# The layer's tail (``gat_tail``): a block's warps (``kTailWarps`` of
# csrc/gat_attention.cu), and the floor the softmax sums are clamped to.
TAIL_WARPS = 8
S_FLOOR = 1e-16


def gat_tail_reference(v: torch.Tensor, s: torch.Tensor,
                       owned_idx: torch.Tensor, owned_mask: torch.Tensor,
                       b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the layer's tail, the torch chain the kernels
    replace: the owned rows of ``v / max(s, 1e-16)`` (``owned_idx`` -1
    reads row 0), masked, then on a hidden layer ``+ b``, masked again and
    ELU, ``[O, heads * dh]``; on the last layer (``b`` None) the heads'
    mean, ``[O, dh]``."""
    own = owned_idx.clamp(min=0)
    s_own = s.index_select(0, own).clamp(min=S_FLOOR)
    h = v.index_select(0, own) / s_own[..., None]   # [O, heads, dh]
    h = h * owned_mask[:, None, None]
    if b is None:
        return h.mean(dim=1)
    return F.elu((h.reshape(-1, h.shape[1] * h.shape[2]) + b)
                 * owned_mask[:, None])


def gat_tail_backward_reference(dy: torch.Tensor, v: torch.Tensor,
                                s: torch.Tensor, owned_idx: torch.Tensor,
                                owned_mask: torch.Tensor,
                                b: torch.Tensor | None = None):
    """Plain version of the tail's backward, term by term as autograd
    differentiates ``gat_tail_reference``: from ``dy`` (the output's
    shape) returns ``(dv, ds, db)`` in the shapes of ``v``, ``s`` and ``b``
    (``db`` None on the last layer). Rows no owned row names are zero; the
    clamp passes no gradient to an ``s`` under 1e-16."""
    heads, dh = v.shape[1:]
    own = owned_idx.clamp(min=0)
    mask = owned_mask[:, None]
    s_own = s.index_select(0, own)
    s_cl = s_own.clamp(min=S_FLOOR)[..., None]
    x = v.index_select(0, own) / s_cl               # [O, heads, dh]
    db = None
    if b is None:
        g = (dy / heads)[:, None, :].expand(-1, heads, -1)
    else:
        z = ((x * mask[..., None]).reshape(-1, heads * dh) + b) * mask
        g = torch.where(z <= 0, dy * torch.exp(z), dy) * mask
        db = g.sum(dim=0)
        g = g.reshape(-1, heads, dh)
    g = g * mask[..., None]
    dv = torch.zeros_like(v).index_add_(0, own, g / s_cl)
    ds_own = -(g * (x / s_cl)).sum(dim=-1)
    ds = torch.zeros_like(s).index_add_(
        0, own, torch.where(s_own >= S_FLOOR, ds_own, 0.0))
    return dv, ds, db


def _tail_vec(dh: int, strides, tensors) -> int:
    """The tail kernels' read unit in floats: the widest of 4 and 2 that
    divides ``dh``, every stride and every tensor's address, else 1."""
    for vec in (4, 2):
        if (dh % vec == 0 and all(st % vec == 0 for st in strides)
                and all(t.data_ptr() % (4 * vec) == 0 for t in tensors)):
            return vec
    return 1


@functools.cache
def _tail_blocks_an_sm(backward: bool, last: bool, vec: int, heads: int,
                       dh: int, device: int) -> int:
    lib = _library()
    out = ctypes.c_int(0)
    err = lib.gat_tail_occupancy(int(backward), int(last), vec, heads, dh,
                                 device, ctypes.addressof(out))
    check_launch(lib, err, "gat_tail_occupancy")
    return max(1, out.value)


def _tail_grid(rows: int, backward: bool, last: bool, vec: int, heads: int,
               dh: int, device: torch.device) -> int:
    """The persistent grid: as many blocks as the card holds at once, at
    most one for each ``TAIL_WARPS`` rows."""
    per_sm = _tail_blocks_an_sm(backward, last, vec, heads, dh, device.index)
    return max(1, min(-(-rows // TAIL_WARPS), per_sm * _sms(device)))


def _mean_factor(rows: int, dh: int, heads: int) -> float:
    """torch's factor for the mean over the heads, outputs over inputs
    in f32, as its reduction on the card computes it."""
    return float(torch.tensor(float(rows * dh), dtype=torch.float32)
                 / torch.tensor(float(rows * dh * heads),
                                dtype=torch.float32))


def gat_tail_fwd(v: torch.Tensor, s: torch.Tensor, owned_idx: torch.Tensor,
                 owned_mask: torch.Tensor,
                 b: torch.Tensor | None = None) -> torch.Tensor:
    """The tail's output, without autograd: the plain version on the CPU,
    one kernel launch on the card, which takes the owned rows as the dst
    frame's prefix (``owned_idx[o] == o`` wherever ``owned_mask[o]``, as
    every sampler builds them) and reads only ``owned_mask``.
    ``gat_tail_fwd.launches`` counts the launches."""
    if v.device.type == "cpu":
        with torch.no_grad():
            return gat_tail_reference(v, s, owned_idx, owned_mask, b)
    _on_cuda(v)
    D, heads, dh = v.shape
    O = owned_idx.shape[0]
    last = b is None
    y = torch.empty((O, dh if last else heads * dh), dtype=torch.float32,
                    device=v.device)
    if O == 0:
        return y
    vec = _tail_vec(dh, v.stride()[:2], [v, y] + ([] if last else [b]))
    grid = _tail_grid(O, False, last, vec, heads, dh, v.device)
    lib = _library()
    err = lib.gat_tail_fwd(
        v.data_ptr(), v.stride(0), v.stride(1), s.data_ptr(),
        owned_mask.data_ptr(), None if last else b.data_ptr(), D, O, heads,
        dh, int(last), _mean_factor(O, dh, heads), vec, grid, y.data_ptr(),
        v.device.index, _stream(v))
    check_launch(lib, err, "gat_tail_fwd")
    gat_tail_fwd.launches += 1
    return y


gat_tail_fwd.launches = 0


def gat_tail_bwd(dy: torch.Tensor, v: torch.Tensor, s: torch.Tensor,
                 owned_idx: torch.Tensor, owned_mask: torch.Tensor,
                 b: torch.Tensor | None = None):
    """The tail's ``(dv, ds, db)`` as ``gat_tail_backward_reference``
    returns them: the plain version on the CPU, one kernel launch on the
    card, which takes the owned rows as ``gat_tail_fwd`` does. ``dv`` takes
    ``v``'s strides, so the per-head projection's backward reads it in
    place; ``db``'s partials, one a block, are summed here.
    ``gat_tail_bwd.launches`` counts the launches."""
    if v.device.type == "cpu":
        return gat_tail_backward_reference(dy, v, s, owned_idx, owned_mask,
                                           b)
    _on_cuda(v)
    D, heads, dh = v.shape
    O = owned_idx.shape[0]
    last = b is None
    dv = torch.empty_like(v)
    ds = torch.empty((D, heads), dtype=torch.float32, device=v.device)
    rows = max(D, O)
    if D == 0:
        return dv, ds, None if last else torch.zeros_like(b)
    vec = _tail_vec(dh, v.stride()[:2] + dv.stride()[:2],
                    [v, dy, dv] + ([] if last else [b]))
    grid = _tail_grid(rows, True, last, vec, heads, dh, v.device)
    part = (None if last else
            torch.empty((grid, heads * dh), dtype=torch.float32,
                        device=v.device))
    lib = _library()
    err = lib.gat_tail_bwd(
        dy.data_ptr(), v.data_ptr(), v.stride(0), v.stride(1), s.data_ptr(),
        owned_mask.data_ptr(), None if last else b.data_ptr(), D, O, heads,
        dh, int(last), 1.0 / heads, vec, grid, dv.data_ptr(), dv.stride(0),
        dv.stride(1), ds.data_ptr(), None if last else part.data_ptr(),
        v.device.index, _stream(v))
    check_launch(lib, err, "gat_tail_bwd")
    gat_tail_bwd.launches += 1
    return dv, ds, None if last else part.sum(dim=0)


gat_tail_bwd.launches = 0


class _GatTail(torch.autograd.Function):
    """``gat_tail``: saves ``v``, ``s``, ``b`` and the owned rows, and
    recomputes the normalised values in the backward."""

    @staticmethod
    def forward(ctx, v, s, b, owned_idx, owned_mask):
        ctx.save_for_backward(v, s, b, owned_idx, owned_mask)
        return gat_tail_fwd(v, s, owned_idx, owned_mask, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        v, s, b, owned_idx, owned_mask = ctx.saved_tensors
        dv, ds, db = gat_tail_bwd(dy.contiguous(), v, s, owned_idx,
                                  owned_mask, b)
        return dv, ds, db, None, None


def gat_tail(v: torch.Tensor, s: torch.Tensor, owned_idx: torch.Tensor,
             owned_mask: torch.Tensor,
             b: torch.Tensor | None = None) -> torch.Tensor:
    """Split GAT's layer tail: the merged softmax partials ``s [D, heads]``
    and ``v [D, heads, dh]`` (f32; ``v`` in any layout with unit stride
    along ``dh``, such as the per-head projection's head-major result) to
    the layer's output at its ``O`` owned rows (``owned_idx`` int32, -1 at
    a pad, and ``owned_mask`` bool; on the card the owned rows must be the
    dst frame's prefix, as the samplers build them): on a hidden layer ``elu(v / max(s,
    1e-16) + b)`` per head, concatenated, ``[O, heads * dh]``; on the last
    layer (``b`` None) the heads' mean, ``[O, dh]``; zero rows at the pads.
    Differentiable in ``v``, ``s`` and ``b``."""
    if v.dtype != torch.float32 or v.dim() != 3 or s.dtype != torch.float32:
        raise TypeError(f"v and s must be float32 [D, heads, dh] and [D, "
                        f"heads], got {v.dtype} {list(v.shape)} and "
                        f"{s.dtype} {list(s.shape)}")
    D, heads, dh = v.shape
    if tuple(s.shape) != (D, heads):
        raise TypeError(f"s must be [{D}, {heads}], got {list(s.shape)}")
    if owned_idx.dtype != torch.int32 or owned_mask.dtype not in (
            torch.bool, torch.uint8) or owned_idx.shape != owned_mask.shape:
        raise TypeError(f"owned_idx int32 and owned_mask bool of one shape, "
                        f"got {owned_idx.dtype} {list(owned_idx.shape)} and "
                        f"{owned_mask.dtype} {list(owned_mask.shape)}")
    if b is not None and (b.dtype != torch.float32
                          or tuple(b.shape) != (heads * dh,)):
        raise TypeError(f"b must be float32 [{heads * dh}], got {b.dtype} "
                        f"{list(b.shape)}")
    for name, t in (("s", s), ("owned_idx", owned_idx),
                    ("owned_mask", owned_mask), ("b", b)):
        if t is not None and t.device != v.device:
            raise ValueError(f"{name} on {t.device}, v on {v.device}")
    if v.stride(-1) != 1:
        v = v.contiguous()
    return _GatTail.apply(v, s.contiguous(), b, owned_idx.contiguous(),
                          owned_mask.contiguous())
