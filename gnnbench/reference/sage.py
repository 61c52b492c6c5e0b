"""GraphSAGE with the mean aggregator, as plain PyTorch:
``h_v = W [x_v, mean_{u in S(v)} x_u] + b`` over a node's slots S(v)
(itself and its sampled neighbours, repeats counted), ReLU between layers.
"""

from __future__ import annotations

import torch

# Rows of the first layer gathered at a time.
BLOCK = 32768


def _slot_mean(x: torch.Tensor, self_ref: torch.Tensor,
               slot_ref: torch.Tensor) -> torch.Tensor:
    valid = slot_ref >= 0
    rows = x[slot_ref.clamp(min=0)] * valid[..., None]
    mean = rows.sum(1) / valid.sum(1, keepdim=True).clamp(min=1)
    return torch.cat([x[self_ref], mean], dim=-1)


def forward(weights: dict, refs, features: torch.Tensor,
            cfg: dict) -> torch.Tensor:
    """Logits of ``refs.targets``; ``features`` and ``weights`` in the
    reference's dtype."""
    layers = len(refs.layers)
    h = None
    for i, (self_ref, slot_ref) in enumerate(refs.layers):
        w, b = weights[f"layer_{i}/w"], weights[f"layer_{i}/b"]
        if i == 0:
            with torch.no_grad():
                a = torch.cat([_slot_mean(features, self_ref[lo:lo + BLOCK],
                                          slot_ref[lo:lo + BLOCK])
                               for lo in range(0, self_ref.numel(), BLOCK)])
        else:
            a = _slot_mean(h, self_ref, slot_ref)
        h = a @ w + b
        if i != layers - 1:
            h = torch.relu(h)
    return h
