"""UniMP's graph transformer (Shi et al., IJCAI 2021, arXiv:2009.03509) in
plain ``torch``, float32 or float64, over sampled slot lists: PyG's
``TransformerConv`` with ``beta=True`` and ``root_weight=True``, then
LayerNorm and ReLU on each hidden layer, as PyG's
``examples/unimp_arxiv.py`` stacks them.

A layer, for node i with slots S(i) (itself and its sampled neighbours,
repeats counted) and head c of width dh:

    q_i = W_q x_i + b_q,  k_j = W_k x_j,  v_j = W_v x_j + b_v
    alpha_ij = softmax over j in S(i) of q_i,c . k_j,c / sqrt(dh)
    m_i = sum_j alpha_ij v_j,c, heads concatenated (the last layer:
          averaged)
    r_i = W_s x_i + b_s
    beta_i = sigmoid([m_i, r_i, m_i - r_i] @ w_beta)
    out_i = beta_i r_i + (1 - beta_i) m_i
    hidden layers: relu(layer_norm(out_i) * (1 + ln_g) + ln_b)

The key bias cancels in the softmax and is left out. Weights are
``layer_{i}/<leaf>`` tensors, the port's names. TF32 is off while it
runs. It imports nothing but torch.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

LN_EPS = 1e-5


def layer(weights: dict, i: int, h: torch.Tensor, self_ref: torch.Tensor,
          slot_ref: torch.Tensor, heads: int, last: bool) -> torch.Tensor:
    """Layer ``i`` of the nodes ``self_ref [n]`` (rows of ``h``) over their
    slots ``slot_ref [n, S]`` (rows of ``h``, -1 empty): ``[n, W]``."""
    p = {k.split("/", 1)[1]: v for k, v in weights.items()
         if k.startswith(f"layer_{i}/")}
    n, S = slot_ref.shape
    dh = p["w_q"].shape[1] // heads
    valid = slot_ref >= 0
    xs = h[self_ref]
    xj = h[slot_ref.clamp(min=0)]
    q = (xs @ p["w_q"] + p["b_q"]).view(n, heads, dh)
    k = (xj @ p["w_k"]).view(n, S, heads, dh)
    v = (xj @ p["w_v"] + p["b_v"]).view(n, S, heads, dh)
    e = (q[:, None] * k).sum(-1) / dh ** 0.5
    alpha = torch.softmax(e.masked_fill(~valid[..., None], float("-inf")),
                          dim=1)
    m = (alpha[..., None] * v).sum(1)
    m = m.mean(1) if last else m.reshape(n, heads * dh)
    r = xs @ p["w_s"] + p["b_s"]
    beta = torch.sigmoid(torch.cat([m, r, m - r], dim=-1) @ p["w_beta"])
    out = beta * r + (1 - beta) * m
    if last:
        return out
    return torch.relu(F.layer_norm(out, out.shape[-1:], 1 + p["ln_g"],
                                   p["ln_b"], LN_EPS))


def forward(weights: dict, layers, features: torch.Tensor,
            heads: int) -> torch.Tensor:
    """The logits of the last layer's nodes: ``layers`` lists ``(self_ref,
    slot_ref)`` innermost first, rows of ``features`` at the first layer
    and of the layer below's output above it; weights and features in
    one dtype."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        h = features
        for i, (self_ref, slot_ref) in enumerate(layers):
            h = layer(weights, i, h, self_ref, slot_ref, heads,
                      i == len(layers) - 1)
        return h
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
