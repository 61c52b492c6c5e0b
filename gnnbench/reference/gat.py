"""GAT as plain PyTorch: per head ``e_uv = LeakyReLU(a_l . W x_u + a_r .
W x_v)`` over a node's slots S(v) (itself and its sampled neighbours,
repeats counted), ``alpha`` the softmax over them, ``h_v = sum alpha W
x_u``; heads concatenated with a bias and ELU on hidden layers, averaged
with no bias on the last. Each block of rows runs under
``torch.utils.checkpoint``, so the backward recomputes it rather than
keeping every slot's projected row.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

# Rows a block.
BLOCK = 16384


def _block(x, self_ref, slot_ref, w, attn_l, attn_r, b, slope, last):
    heads, d = attn_l.shape
    valid = slot_ref >= 0
    n, s = slot_ref.shape
    z = (x[slot_ref.clamp(min=0)] @ w).view(n, s, heads, d)
    zs = (x[self_ref] @ w).view(n, heads, d)
    el = (z * attn_l).sum(-1)
    er = (zs * attn_r).sum(-1)
    e = F.leaky_relu(el + er[:, None], slope)
    e = e.masked_fill(~valid[..., None], float("-inf"))
    alpha = torch.softmax(e, dim=1)
    h = (alpha[..., None] * z).sum(1)
    if last:
        return h.mean(1)
    return h.reshape(n, heads * d) + b


def forward(weights: dict, refs, features: torch.Tensor,
            cfg: dict) -> torch.Tensor:
    """Logits of ``refs.targets``; ``features`` and ``weights`` in the
    reference's dtype."""
    layers = len(refs.layers)
    slope = float(cfg["negative_slope"])
    h = features
    for i, (self_ref, slot_ref) in enumerate(refs.layers):
        p = [weights[f"layer_{i}/{k}"] for k in ("w", "attn_l", "attn_r",
                                                  "b")]
        last = i == layers - 1
        parts = [checkpoint(_block, h, self_ref[lo:lo + BLOCK],
                            slot_ref[lo:lo + BLOCK], *p, slope, last,
                            use_reentrant=False)
                 for lo in range(0, self_ref.numel(), BLOCK)]
        h = torch.cat(parts)
        if not last:
            h = F.elu(h)
    return h
