"""UniMP's layer tail: the merged softmax partials of the query-key
attention (``ops.gat_attention.qk_attention``) to the layer's output at
its owned rows.

For owned row o, with the width ``W`` of a hidden layer ``heads * dh``
and of the last ``dh``:

* ``m = v / max(s, 1e-16) + b_v`` per head, the heads concatenated on a
  hidden layer and averaged on the last (``Sum alpha = 1``, so the value
  bias enters after the division);
* ``r``, the skip ``W_s x_o + b_s`` (an input here);
* the gate ``beta = sigmoid(m . (w1 + w3) + r . (w2 - w3))`` for
  ``w_beta = [w1; w2; w3]`` (``[3 W, 1]``): PyG's ``TransformerConv``
  ``lin_beta([m, r, m - r])`` without building the concatenation;
* ``out = beta r + (1 - beta) m``;
* on a hidden layer ``relu(layer_norm(out) * (1 + ln_g) + ln_b)``, eps
  ``LN_EPS``;

and zero rows at the pads. ``unimp_tail`` runs it under an autograd
Function whose forward saves only the inputs and LayerNorm's row
statistics. The owned rows are the dst frame's prefix (owned row o is
dst row o wherever it is valid, as the samplers make them), so no row is
gathered or scattered. On a CPU tensor each direction is its plain
version: the forward as torch ops (``unimp_tail_plain``), the backward the
explicit formula (``unimp_tail_backward_reference``: LayerNorm's by
torch's fused backward, the gate's intermediates recomputed from the
inputs). On a CUDA tensor each is one hand-written kernel of
``csrc/unimp_tail.cu`` (``unimp_tail_fwd``, ``unimp_tail_bwd``), or it
raises: there is no fallback between the two. ``unimp_tail_counts()``
counts the kernels' launches by direction and form (a row of at most 512
floats in registers, a wider one staged in shared memory).
``unimp_tail_reference`` is the chain autograd differentiates, over any
owned rows, which tests hold the op to.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
from torch.nn import functional as F

from occ_gnn_tpu_torch.ops.build import check_launch, load_kernel
from occ_gnn_tpu_torch.ops.gat_attention import (
    S_FLOOR,
    _sms,
    _stream,
    _tail_vec,
)

# PyG's LayerNorm default, and torch's.
LN_EPS = 1e-5
# The kernels' most heads (csrc's kMaxHeads: a lane a head's sum).
MAX_HEADS = 32

_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
# The C entries of csrc/unimp_tail.cu, argument for argument.
ARGTYPES = {
    # v, v_row, v_head, s, r, b_v, w_beta, ln_g, ln_b, owned_mask, d, o,
    # heads, dh, last, eps, vec, warps, grid, y, mean, rstd, device, stream
    "unimp_tail_fwd": [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I,
                       _I, _I, _D, _I, _I, _I, _P, _P, _P, _I, _P],
    # dy, v, v_row, v_head, s, r, b_v, w_beta, ln_g, ln_b, owned_mask, mean,
    # rstd, d, o, heads, dh, last, eps, vec, warps, grid, dv, dv_row,
    # dv_head, ds, dr, part, grads, device, stream
    "unimp_tail_bwd": [_P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _L, _L, _I, _I, _I, _D, _I, _I, _I, _P, _L, _L, _P,
                       _P, _P, _P, _I, _P],
    # backward, last, vec, heads, dh, device, warps, per_sm, shared
    "unimp_tail_occupancy": [_I, _I, _I, _I, _I, _I, _P, _P, _P],
}


def unimp_tail_reference(v, s, r, b_v, w_beta, owned_idx, owned_mask,
                         ln_g=None, ln_b=None):
    """Plain version, differentiable by autograd: ``v [D, heads, dh]``,
    ``s [D, heads]``, the skip ``r [O, W]``, ``b_v [heads * dh]``,
    ``w_beta [3 W, 1]``, the owned rows (``owned_idx`` int32, -1 at a
    pad, reads row 0; ``owned_mask``) and, on a hidden layer, ``ln_g`` and
    ``ln_b`` ``[W]`` (None on the last layer). Returns ``[O, W]``."""
    heads, dh = v.shape[1:]
    own = owned_idx.clamp(min=0)
    sc = s.index_select(0, own).clamp(min=S_FLOOR)
    mh = v.index_select(0, own) / sc[..., None] + b_v.view(heads, dh)
    m = mh.mean(dim=1) if ln_g is None else mh.reshape(-1, heads * dh)
    w1, w2, w3 = w_beta.view(3, -1)
    beta = torch.sigmoid(m @ (w1 + w3) + r @ (w2 - w3))[:, None]
    out = beta * r + (1 - beta) * m
    if ln_g is not None:
        out = torch.relu(F.layer_norm(out, out.shape[-1:], 1 + ln_g, ln_b,
                                      LN_EPS))
    return out * owned_mask[:, None]


def _gate(v, s, r, b_v, w_beta, last):
    """The owned rows' (the first ``O`` dst rows') clamped sums ``sc``,
    normalised values ``x [O, heads, dh]``, ``m [O, W]``, the gate's
    vectors, ``beta [O]`` and the gated sum ``out [O, W]``."""
    heads, dh = v.shape[1:]
    O = r.shape[0]
    sc = s[:O].clamp(min=S_FLOOR)
    x = v[:O] / sc[..., None]
    mh = x + b_v.view(heads, dh)
    m = mh.mean(dim=1) if last else mh.reshape(O, heads * dh)
    w1, w2, w3 = w_beta.view(3, -1)
    wa, wb = w1 + w3, w2 - w3
    beta = torch.sigmoid(torch.addmv(r @ wb, m, wa))
    return sc, x, m, wa, wb, beta, torch.lerp(m, r, beta[:, None])


def unimp_tail_plain(v, s, r, b_v, w_beta, owned_mask, ln_g=None,
                     ln_b=None):
    """The forward's plain version as torch ops, with the owned rows the
    first ``O`` dst rows: ``(y [O, W], mean, rstd)``, LayerNorm's row
    statistics ``[O, 1]`` (None on the last layer)."""
    out = _gate(v, s, r, b_v, w_beta, ln_g is None)[-1]
    mean = rstd = None
    if ln_g is not None:
        out, mean, rstd = torch.ops.aten.native_layer_norm(
            out, out.shape[-1:], 1 + ln_g, ln_b, LN_EPS)
        out = out.relu_()
    return out.mul_(owned_mask[:, None]), mean, rstd


def unimp_tail_backward_reference(dy, v, s, r, b_v, w_beta, owned_mask,
                                  ln_g=None, ln_b=None, y=None):
    """The backward's plain version, the explicit formula: from ``dy
    [O, W]`` returns ``(dv, ds, dr, db_v, dw_beta, dln_g, dln_b)`` in the
    shapes of the inputs (the last two None on the last layer).
    LayerNorm's backward is torch's fused one, and dst rows past the owned
    rows take no gradient. The ReLU's mask is where the forward's output
    ``y`` is positive: by default it recomputes ``y`` by
    ``unimp_tail_plain`` (the same ops give the forward's bits); a check
    against another forward passes that forward's ``y``, since an element
    within rounding of 0 may take either sign."""
    D, heads, dh = v.shape
    O, width = r.shape
    last = ln_g is None
    sc, x, m, wa, wb, beta, out = _gate(v, s, r, b_v, w_beta, last)
    dln_g = dln_b = None
    if last:
        dout = dy * owned_mask[:, None]
    else:
        y_plain, mean, rstd = unimp_tail_plain(v, s, r, b_v, w_beta,
                                               owned_mask, ln_g, ln_b)
        # relu's gradient where the output is positive (0 at the pads).
        dz = torch.where((y_plain if y is None else y) > 0, dy, 0.0)
        dout, dln_g, dln_b = torch.ops.aten.native_layer_norm_backward(
            dz, out, [width], mean, rstd, 1 + ln_g, ln_b,
            [True, True, True])
    da = (dout * (r - m)).sum(dim=-1) * (beta * (1 - beta))
    dm = torch.addcmul(dout * (1 - beta)[:, None], da[:, None], wa)
    dr = torch.addcmul(dout * beta[:, None], da[:, None], wb)
    dwa, dwb = m.t() @ da, r.t() @ da
    dw_beta = torch.cat([dwa, dwb, dwa - dwb])[:, None]
    if last:
        dmh = (dm / heads)[:, None, :].expand(-1, heads, dh)
    else:
        dmh = dm.view(O, heads, dh)
    db_v = dmh.sum(dim=0).reshape(-1)
    dvo = dmh / sc[..., None]
    # The clamp passes no gradient to an s under 1e-16.
    dso = torch.where(s[:O] >= S_FLOOR, -(dvo * x).sum(dim=-1), 0.0)
    if O == D:
        dv, ds = dvo, dso
    else:
        dv, ds = torch.zeros_like(v), torch.zeros_like(s)
        dv[:O], ds[:O] = dvo, dso
    return dv, ds, dr, db_v, dw_beta, dln_g, dln_b


# The kernels' launches in this process, by direction and form.
_LAUNCHES = collections.Counter()


def unimp_tail_counts() -> dict:
    """The tail kernels' launches in this process: ``fwd_register``,
    ``fwd_shared``, ``bwd_register`` and ``bwd_shared`` (the row in
    registers, or staged in shared memory)."""
    return {f"{d}_{f}": _LAUNCHES[d, f] for d in ("fwd", "bwd")
            for f in ("register", "shared")}


def reset_unimp_tail_counts() -> None:
    """Set every count of ``unimp_tail_counts()`` to 0."""
    _LAUNCHES.clear()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_kernel("unimp_tail")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _block(backward: bool, last: bool, vec: int, heads: int, dh: int,
           device: int) -> tuple[int, int, bool]:
    """A kernel's block on the card: its warps, the blocks an SM holds at
    once, and whether it takes the shared form."""
    lib = _library()
    warps, per_sm, shared = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = lib.unimp_tail_occupancy(
        int(backward), int(last), vec, heads, dh, device,
        ctypes.addressof(warps), ctypes.addressof(per_sm),
        ctypes.addressof(shared))
    check_launch(lib, err, "unimp_tail_occupancy")
    return warps.value, max(1, per_sm.value), bool(shared.value)


def _grid(rows: int, block, device: torch.device) -> int:
    """The persistent grid: as many blocks as the card holds at once, at
    most one for each block's warps of rows."""
    warps, per_sm, _ = block
    return max(1, min(-(-rows // warps), per_sm * _sms(device)))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def unimp_tail_fwd(v, s, r, b_v, w_beta, owned_mask, ln_g=None, ln_b=None):
    """The tail's forward without autograd: ``(y [O, W], mean, rstd)``,
    LayerNorm's row statistics (None on the last layer). On the CPU the
    plain version (statistics ``[O, 1]``); on the card one launch
    (statistics ``[O]``, 0 at the pads), which takes the owned rows as
    the dst frame's prefix."""
    if v.device.type == "cpu":
        with torch.no_grad():
            return unimp_tail_plain(v, s, r, b_v, w_beta, owned_mask, ln_g,
                                    ln_b)
    return _launch_fwd(v, s, r, b_v, w_beta, owned_mask, ln_g, ln_b)


def _launch_fwd(v, s, r, b_v, w_beta, owned_mask, ln_g, ln_b):
    D, heads, dh = v.shape
    O, width = r.shape
    last = ln_g is None
    dev = v.device
    y = torch.empty((O, width), dtype=torch.float32, device=dev)
    mean = rstd = None
    if not last:
        mean = torch.empty(O, dtype=torch.float32, device=dev)
        rstd = torch.empty_like(mean)
    if O == 0:
        return y, mean, rstd
    vec = _tail_vec(dh, v.stride()[:2], [v, r, y])
    block = _block(False, last, vec, heads, dh, v.get_device())
    lib = _library()
    err = lib.unimp_tail_fwd(
        v.data_ptr(), v.stride(0), v.stride(1), s.data_ptr(), r.data_ptr(),
        b_v.data_ptr(), w_beta.data_ptr(), _ptr(ln_g), _ptr(ln_b),
        owned_mask.data_ptr(), D, O, heads, dh, int(last), LN_EPS, vec,
        block[0], _grid(O, block, dev), y.data_ptr(), _ptr(mean),
        _ptr(rstd), v.get_device(), _stream(v))
    check_launch(lib, err, "unimp_tail_fwd")
    _LAUNCHES["fwd", "shared" if block[2] else "register"] += 1
    return y, mean, rstd


def unimp_tail_bwd(dy, v, s, r, b_v, w_beta, owned_mask, ln_g=None,
                   ln_b=None, mean=None, rstd=None):
    """The tail's gradients ``(dv, ds, dr, db_v, dw_beta, dln_g, dln_b)``
    as ``unimp_tail_backward_reference`` returns them: on the CPU that
    plain version (``mean`` and ``rstd`` unread: it recomputes them); on
    the card one launch from the forward's statistics, ``dv`` in ``v``'s
    strides (so the value projection's backward reads it in place), every
    dst row written, and the weights' gradients summed in a fixed order
    from partials a block."""
    if v.device.type == "cpu":
        return unimp_tail_backward_reference(dy, v, s, r, b_v, w_beta,
                                             owned_mask, ln_g, ln_b)
    return _launch_bwd(dy, v, s, r, b_v, w_beta, owned_mask, ln_g, ln_b,
                       mean, rstd)


def _launch_bwd(dy, v, s, r, b_v, w_beta, owned_mask, ln_g, ln_b, mean,
                rstd):
    D, heads, dh = v.shape
    O, width = r.shape
    last = ln_g is None
    dev = v.device
    dv = torch.empty_strided(v.shape, v.stride(), dtype=torch.float32,
                             device=dev)
    ds = torch.empty((D, heads), dtype=torch.float32, device=dev)
    dr = torch.empty_like(dy)
    nb = heads * dh
    grads = torch.empty(nb + (3 if last else 5) * width,
                        dtype=torch.float32, device=dev)
    vec = _tail_vec(dh, v.stride()[:2] + dv.stride()[:2], [v, r, dy, dv,
                                                            dr])
    block = _block(True, last, vec, heads, dh, v.get_device())
    grid = _grid(D, block, dev)
    part = torch.empty((grid, grads.numel()), dtype=torch.float64,
                       device=dev)
    lib = _library()
    err = lib.unimp_tail_bwd(
        dy.data_ptr(), v.data_ptr(), v.stride(0), v.stride(1), s.data_ptr(),
        r.data_ptr(), b_v.data_ptr(), w_beta.data_ptr(), _ptr(ln_g),
        _ptr(ln_b), owned_mask.data_ptr(), _ptr(mean), _ptr(rstd), D, O,
        heads, dh, int(last), LN_EPS, vec, block[0], grid, dv.data_ptr(),
        dv.stride(0), dv.stride(1), ds.data_ptr(), dr.data_ptr(),
        part.data_ptr(), grads.data_ptr(), v.get_device(), _stream(v))
    check_launch(lib, err, "unimp_tail_bwd")
    _LAUNCHES["bwd", "shared" if block[2] else "register"] += 1
    db_v, dw_beta, ln = grads.split([nb, 3 * width, grads.numel() - nb
                                     - 3 * width])
    dln_g = dln_b = None
    if not last:
        dln_g, dln_b = ln.view(2, width)
    return dv, ds, dr, db_v, dw_beta.view(-1, 1), dln_g, dln_b


class _UnimpTail(torch.autograd.Function):
    """``unimp_tail``: saves its inputs and LayerNorm's statistics, and
    recomputes the rest in the backward."""

    @staticmethod
    def forward(ctx, v, s, r, b_v, w_beta, ln_g, ln_b, owned_mask):
        y, mean, rstd = unimp_tail_fwd(v, s, r, b_v, w_beta, owned_mask,
                                       ln_g, ln_b)
        ctx.save_for_backward(v, s, r, b_v, w_beta, ln_g, ln_b, owned_mask,
                              mean, rstd)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        v, s, r, b_v, w_beta, ln_g, ln_b, owned_mask, mean, rstd = (
            ctx.saved_tensors)
        grads = unimp_tail_bwd(dy.contiguous(), v, s, r, b_v, w_beta,
                               owned_mask, ln_g, ln_b, mean, rstd)
        return (*grads, None)


def unimp_tail(v: torch.Tensor, s: torch.Tensor, r: torch.Tensor,
               b_v: torch.Tensor, w_beta: torch.Tensor,
               owned_mask: torch.Tensor, ln_g: torch.Tensor | None = None,
               ln_b: torch.Tensor | None = None) -> torch.Tensor:
    """UniMP's layer tail (the module's docstring) at the ``O`` owned rows,
    the first ``O <= D`` rows of the dst frame of ``v [D, heads, dh]`` (in
    any layout with unit stride along ``dh``, such as the value
    projection's head-major result) and ``s [D, heads]`` (``owned_mask``
    marks the valid ones): ``[O, heads * dh]`` on a hidden layer
    (``ln_g``, ``ln_b`` given), ``[O, dh]`` on the last; differentiable in
    ``v``, ``s``, ``r`` and the weights. The card takes float32 and at
    most 32 heads; the CPU's plain version any one float type."""
    if v.dim() != 3:
        raise TypeError(f"v must be [D, heads, dh], got {list(v.shape)}")
    D, heads, dh = v.shape
    O = owned_mask.shape[0]
    width = dh if ln_g is None else heads * dh
    if tuple(s.shape) != (D, heads) or tuple(r.shape) != (O, width):
        raise TypeError(f"s must be [{D}, {heads}] and r [{O}, {width}], "
                        f"got {list(s.shape)} and {list(r.shape)}")
    if O > D:
        raise ValueError(f"{O} owned rows, a prefix of {D} dst rows")
    if tuple(b_v.shape) != (heads * dh,) or tuple(w_beta.shape) != (
            3 * width, 1):
        raise TypeError(f"b_v must be [{heads * dh}] and w_beta "
                        f"[{3 * width}, 1], got {list(b_v.shape)} and "
                        f"{list(w_beta.shape)}")
    if (ln_g is None) != (ln_b is None):
        raise TypeError("ln_g and ln_b come together (a hidden layer)")
    if ln_g is not None and (tuple(ln_g.shape) != (width,)
                             or tuple(ln_b.shape) != (width,)):
        raise TypeError(f"ln_g and ln_b must be [{width}], got "
                        f"{list(ln_g.shape)} and {list(ln_b.shape)}")
    if owned_mask.dim() != 1 or owned_mask.dtype not in (torch.bool,
                                                         torch.uint8):
        raise TypeError(f"owned_mask must be a bool [O], got "
                        f"{owned_mask.dtype} {list(owned_mask.shape)}")
    floats = {"v": v, "s": s, "r": r, "b_v": b_v, "w_beta": w_beta,
              "ln_g": ln_g, "ln_b": ln_b}
    for name, t in floats.items():
        if t is not None and t.dtype != v.dtype:
            raise TypeError(f"{name} is {t.dtype}, v {v.dtype}")
    for name, t in [*floats.items(), ("owned_mask", owned_mask)]:
        if t is not None and t.device != v.device:
            raise ValueError(f"{name} on {t.device}, v on {v.device}")
    if v.device.type != "cpu":
        if v.dtype != torch.float32:
            raise TypeError(f"the tail's kernels take float32, got "
                            f"{v.dtype}")
        if heads > MAX_HEADS:
            raise ValueError(f"the tail's kernels take at most {MAX_HEADS} "
                             f"heads, got {heads}")
    if v.stride(-1) != 1:
        v = v.contiguous()
    if ln_g is not None:
        ln_g, ln_b = ln_g.contiguous(), ln_b.contiguous()
    return _UnimpTail.apply(v, s.contiguous(), r.contiguous(),
                            b_v.contiguous(), w_beta.contiguous(), ln_g,
                            ln_b, owned_mask.contiguous())
