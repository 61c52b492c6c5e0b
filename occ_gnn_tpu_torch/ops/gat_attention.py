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
``csrc/gat_attention.cu``, never write them:

* ``gat_attention_fwd`` streams each valid leaf row once per pass (a warp
  for each dst column), scores it, takes the exact max, and writes ``m``,
  ``s`` and ``agg [D, heads, H]``; the per-head projection ``v = agg @
  w3`` is ``torch.einsum`` beside it (JAX's own einsum, a large product);
* ``gat_attention_bwd`` walks the same columns again, recomputes ``z`` and
  ``pw`` from the saved ``m``, and writes ``der``, per-warp partials of
  ``dwl`` (summed here in a fixed order) and, when ``x`` takes a gradient,
  each valid slot's row of ``dx`` into an f32 ``[K * D, H]`` workspace,
  which ``dense_scatter_slots`` sums into ``dx`` in slot order (padding
  slots' rows are neither written nor read).

The kernels take any row width and head count: up to ``H = 512`` and 8
heads a warp keeps a row's columns and the heads' sums in registers; wider
rows or more heads go through the same walk a tile of 128 columns and a
group of 4 heads at a time.

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

import ctypes
import functools
import math

import torch
from torch.nn import functional as F

from occ_gnn_tpu_torch.models.gat import NEGATIVE_SLOPE
from occ_gnn_tpu_torch.ops.build import check_launch, load_kernel
from occ_gnn_tpu_torch.ops.dense_gather_sum import dense_scatter_slots

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# The C entries of csrc/gat_attention.cu, argument for argument.
ARGTYPES = {
    # x, x_bf16, x_rows, h, nbr, k, d, wl, er, heads, slope, m, s, agg,
    # device, stream
    "gat_attention_fwd": [_P, _I, _L, _I, _P, _I, _L, _P, _P, _I, _F, _P,
                          _P, _P, _I, _P],
    # x, x_bf16, x_rows, h, nbr, k, d, wl, er, heads, slope, m, ds, dagg,
    # der, dwl_part, blocks, dxg, device, stream
    "gat_attention_bwd": [_P, _I, _L, _I, _P, _I, _L, _P, _P, _I, _F, _P,
                          _P, _P, _P, _P, _I, _P, _I, _P],
}
# The backward's grid: its blocks walk the columns 8 at a time (a warp
# each), at most this many blocks an SM; each warp writes one dwl partial.
BWD_COLUMNS_A_BLOCK = 8
BWD_BLOCKS_AN_SM = 2
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
    lib = _library()
    err = lib.gat_attention_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], H,
        nbr.data_ptr(), K, D, wl.data_ptr(), er.data_ptr(), heads,
        NEGATIVE_SLOPE, m.data_ptr(), s.data_ptr(), agg.data_ptr(),
        x.device.index, _stream(x))
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
    warp, summed here; ``dxg``'s rows of padding slots left unwritten).
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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(-(-D // BWD_COLUMNS_A_BLOCK), BWD_BLOCKS_AN_SM * sms)
    part = torch.empty((blocks * BWD_COLUMNS_A_BLOCK, H, heads),
                       dtype=torch.float32, device=x.device)
    lib = _library()
    err = lib.gat_attention_bwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], H,
        nbr.data_ptr(), K, D, wl.data_ptr(), er.data_ptr(), heads,
        NEGATIVE_SLOPE, m.data_ptr(), ds.data_ptr(), dagg.data_ptr(),
        der.data_ptr(), part.data_ptr(), blocks,
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
    ``wl``, ``er`` and ``m``, never the leaves; the backward recomputes
    the scores and, when ``x`` takes a gradient, sums the slots' rows
    into ``dx`` with ``dense_scatter_slots``."""

    @staticmethod
    def forward(ctx, x, nbr, wl, er):
        m, s, agg = gat_attention_fwd(x, nbr, wl, er)
        ctx.save_for_backward(x, nbr, wl, er, m)
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
            dx = dense_scatter_slots(dxg, nbr, x.shape[0]).to(x.dtype)
        return dx, None, dwl, der


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
                  w3: torch.Tensor, er: torch.Tensor):
    """GAT's local softmax partials through the dense neighbour matrix:
    f32 ``(m [D, heads], s [D, heads], v [D, heads, Dh])`` for an f32 or
    bf16 frame ``x [S, H]`` (its row ``S - 1`` the zero row padding slots
    name), int32 ``nbr [K, D]``, f32 ``wl [H, heads]``, ``w3 [H, heads,
    Dh]`` and ``er [D, heads]``. Differentiable in ``x``, ``wl``, ``w3``
    and ``er``; ``m`` is not.

    Every ``nbr`` entry must be a row of ``x``; on the card one out of
    range stops the kernel with a device-side assert (JAX clamps it)."""
    wl, er = wl.contiguous(), er.contiguous()
    _check(x, nbr, wl, w3, er)
    m, s, agg = _GatAttention.apply(x, nbr, wl, er)
    return m, s, _Projection.apply(agg, w3)
