"""UniMP's graph transformer (arXiv:2009.03509) as plain PyTorch: PyG's
``TransformerConv`` with ``beta=True`` and ``root_weight=True``, LayerNorm
and ReLU after each hidden layer. Per head c of width dh over a node's
slots S(i) (itself and its sampled neighbours, repeats counted):
``alpha_ij = softmax_j((W_q x_i + b_q)_c . (W_k x_j)_c / sqrt(dh))``,
``m_i = sum_j alpha_ij (W_v x_j + b_v)_c``, heads concatenated (averaged
on the last layer); ``r_i = W_s x_i + b_s``, ``beta_i = sigmoid([m_i,
r_i, m_i - r_i] @ w_beta)``, ``out_i = beta_i r_i + (1 - beta_i) m_i``;
then on a hidden layer ``relu(layer_norm(out_i) * (1 + ln_g) + ln_b)``.
The key bias cancels in the softmax and is not a weight. Each block of
rows runs under ``torch.utils.checkpoint``, so the backward recomputes
it rather than keeping every slot's projected rows. TF32 is as
``train.steps`` sets it: off, but in the control that asks for it.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

# Rows a block.
BLOCK = 16384


def _block(x, self_ref, slot_ref, w_q, b_q, w_k, w_v, b_v, w_s, b_s,
           w_beta, ln_g, ln_b, heads, eps, last):
    n, s = slot_ref.shape
    dh = w_q.shape[1] // heads
    valid = slot_ref >= 0
    xs = x[self_ref]
    xj = x[slot_ref.clamp(min=0)]
    q = (xs @ w_q + b_q).view(n, heads, dh)
    k = (xj @ w_k).view(n, s, heads, dh)
    v = (xj @ w_v + b_v).view(n, s, heads, dh)
    e = (q[:, None] * k).sum(-1) / dh ** 0.5
    alpha = torch.softmax(e.masked_fill(~valid[..., None], float("-inf")),
                          dim=1)
    m = (alpha[..., None] * v).sum(1)
    m = m.mean(1) if last else m.reshape(n, heads * dh)
    r = xs @ w_s + b_s
    beta = torch.sigmoid(torch.cat([m, r, m - r], dim=-1) @ w_beta)
    out = beta * r + (1 - beta) * m
    if last:
        return out
    return torch.relu(F.layer_norm(out, out.shape[-1:], 1 + ln_g, ln_b,
                                   eps))


def forward(weights: dict, refs, features: torch.Tensor,
            cfg: dict) -> torch.Tensor:
    """Logits of ``refs.targets``; ``features`` and ``weights`` in the
    reference's dtype."""
    layers = len(refs.layers)
    heads, eps = int(cfg["heads"]), float(cfg["layer_norm_eps"])
    h = features
    for i, (self_ref, slot_ref) in enumerate(refs.layers):
        last = i == layers - 1
        p = [weights.get(f"layer_{i}/{k}") for k in (
            "w_q", "b_q", "w_k", "w_v", "b_v", "w_s", "b_s", "w_beta",
            "ln_g", "ln_b")]
        h = torch.cat([checkpoint(_block, h, self_ref[lo:lo + BLOCK],
                                  slot_ref[lo:lo + BLOCK], *p, heads, eps,
                                  last, use_reentrant=False)
                       for lo in range(0, self_ref.numel(), BLOCK)])
    return h
