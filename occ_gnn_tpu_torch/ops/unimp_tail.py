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

and zero rows at the pads. ``unimp_tail`` runs it as torch ops under an
autograd Function: the owned rows are the dst frame's prefix (owned row
o is dst row o wherever it is valid, as the samplers make them,
so no row is gathered or scattered), and the backward is the explicit
formula, LayerNorm's by torch's fused backward from the forward's saved
statistics, the gate's intermediates recomputed from the saved inputs.
``unimp_tail_reference`` is the chain autograd differentiates, over any
owned rows, which tests hold the op to.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from occ_gnn_tpu_torch.ops.gat_attention import S_FLOOR

# PyG's LayerNorm default, and torch's.
LN_EPS = 1e-5


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


class _UnimpTail(torch.autograd.Function):
    """``unimp_tail``: saves its inputs, its output and LayerNorm's
    statistics ``[O, 1]``, and recomputes the gate in the backward."""

    @staticmethod
    def forward(ctx, v, s, r, b_v, w_beta, ln_g, ln_b, owned_mask):
        last = ln_g is None
        out = _gate(v, s, r, b_v, w_beta, last)[-1]
        mean = rstd = None
        if not last:
            out, mean, rstd = torch.ops.aten.native_layer_norm(
                out, out.shape[-1:], 1 + ln_g, ln_b, LN_EPS)
            out = out.relu_()
        y = out.mul_(owned_mask[:, None])
        ctx.save_for_backward(v, s, r, b_v, w_beta, ln_g, ln_b, owned_mask,
                              y, mean, rstd)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        v, s, r, b_v, w_beta, ln_g, ln_b, owned_mask, y, mean, rstd = (
            ctx.saved_tensors)
        D, heads, dh = v.shape
        O, width = r.shape
        last = ln_g is None
        sc, x, m, wa, wb, beta, out = _gate(v, s, r, b_v, w_beta, last)
        dln_g = dln_b = None
        if last:
            dout = dy * owned_mask[:, None]
        else:
            # relu's gradient where the output is positive (0 at the pads).
            dz = torch.where(y > 0, dy, 0.0)
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
        return dv, ds, dr, db_v, dw_beta, dln_g, dln_b, None


def unimp_tail(v: torch.Tensor, s: torch.Tensor, r: torch.Tensor,
               b_v: torch.Tensor, w_beta: torch.Tensor,
               owned_mask: torch.Tensor, ln_g: torch.Tensor | None = None,
               ln_b: torch.Tensor | None = None) -> torch.Tensor:
    """UniMP's layer tail (the module's docstring) at the ``O`` owned rows,
    the first ``O <= D`` rows of the dst frame of ``v [D, heads, dh]`` and
    ``s [D, heads]`` (``owned_mask`` marks the valid ones): ``[O, heads *
    dh]`` on a hidden layer (``ln_g``, ``ln_b`` given), ``[O, dh]`` on the
    last; differentiable in ``v``, ``s``, ``r`` and the weights."""
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
    return _UnimpTail.apply(v, s, r, b_v, w_beta, ln_g, ln_b, owned_mask)
