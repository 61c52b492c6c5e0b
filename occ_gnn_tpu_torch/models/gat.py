"""GAT over padded blocks (single-chip path): SDDMM attention scores and a
segment softmax.

The JAX package's ``models/gat.py``: per head, ``e_uv = LeakyReLU(a_l .
Wx_u + a_r . Wx_v)``, ``alpha`` the softmax over the in-edges of v, and
``h_v = sum alpha * Wx_u``. Heads are concatenated on hidden layers and
averaged on the last one; ELU and dropout between layers.

Weights are plain tensors registered as ``layer_{i}/w`` ``[in, heads *
out]``, ``layer_{i}/attn_l`` and ``layer_{i}/attn_r`` ``[heads, out]`` and
``layer_{i}/b``, the keys of the JAX parameter pytree, so a JAX checkpoint
loads through ``utils.checkpoint``. A layer runs the sorted segment-sum
once: ``coo_attention`` sums the softmax denominators and the weighted
messages as one ``[E, heads * (1 + out)]`` message, and the layer divides.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from occ_gnn_tpu_torch.models.common import dropout, xavier_uniform
from occ_gnn_tpu_torch.ops.blocks import Block, SampledBatch
from occ_gnn_tpu_torch.ops.segment import segment_max
from occ_gnn_tpu_torch.ops.segment_sum_sorted import segment_sum_sorted
from occ_gnn_tpu_torch.utils.timers import span

GAT_LEAVES = ("w", "attn_l", "attn_r", "b")
NEGATIVE_SLOPE = 0.2  # the attention scores' leaky ReLU


def register_gat_params(module: nn.Module, in_dim: int, hidden: int,
                        num_classes: int, num_layers: int, num_heads: int,
                        generator: torch.Generator | None) -> None:
    """Xavier weights and attention vectors, zero biases, drawn on the CPU
    from ``generator`` in the JAX init's order (w, attn_l, attn_r). Heads
    are concatenated between layers."""
    k = num_heads
    ins = [in_dim] + [hidden * k] * (num_layers - 1)
    outs = [hidden] * (num_layers - 1) + [num_classes]
    for i in range(num_layers):
        init = {
            "w": xavier_uniform(generator, (ins[i], k * outs[i])),
            "attn_l": xavier_uniform(generator, (k, outs[i])),
            "attn_r": xavier_uniform(generator, (k, outs[i])),
            "b": torch.zeros(k * outs[i]),
        }
        for name, value in init.items():
            module.register_parameter(f"layer_{i}/{name}", nn.Parameter(value))


def coo_attention(feat: torch.Tensor, attn_l: torch.Tensor,
                  edge_src: torch.Tensor, edge_dst: torch.Tensor,
                  er_frame: torch.Tensor):
    """GAT's streaming-softmax partials over a dst-sorted COO (the JAX
    package's ``parallel/model.py:369-392``): score each edge
    ``leaky_relu(el[src] + er[dst])`` with ``el = feat . attn_l``, take the
    segment max (detached; padding edges are dropped and masked to -inf
    before the exp), and sum ``p`` and ``p * feat[src]`` per dst.

    ``feat`` is the projected source frame ``[S, heads, Dh]`` in f32 and
    ``er_frame`` the dst rows' terms ``[dst_cap, heads]``. The two sums are
    one message per edge and head, ``[p, p * feat]``, so one sorted
    segment-sum launch gives both. Returns f32 ``(m_loc, s_loc [dst_cap,
    heads], v_loc [dst_cap, heads, Dh])``; the softmax output is ``v / s``.
    A dst row with no valid edge has ``m = -inf`` and zero sums."""
    with span("gat_attention_coo"):
        k, d_out = attn_l.shape
        dst_cap = er_frame.shape[0]
        # SDDMM decomposes: e_uv = el_u + er_v. Gathers are index_select,
        # whose backward is an index_add_ (advanced indexing's is a sort).
        el = torch.einsum("skd,kd->sk", feat, attn_l)
        valid = (edge_dst < dst_cap)[:, None]
        safe_dst = edge_dst.clamp(max=dst_cap - 1)
        scores = F.leaky_relu(el.index_select(0, edge_src)
                              + er_frame.index_select(0, safe_dst),
                              NEGATIVE_SLOPE)
        m_loc = segment_max(scores.detach(), edge_dst, dst_cap)
        safe_m = torch.where(torch.isfinite(m_loc), m_loc, 0.0)
        pvals = torch.exp((scores - safe_m.index_select(0, safe_dst))
                          .masked_fill(~valid, float("-inf")))
        feat1 = torch.cat([feat.new_ones(feat.shape[0], k, 1), feat], dim=-1)
        msgs = (pvals[:, :, None] * feat1.index_select(0, edge_src)).reshape(
            edge_src.shape[0], -1)
        sums = segment_sum_sorted(msgs, edge_dst, dst_cap)
        sums = sums.reshape(dst_cap, k, d_out + 1)
        return m_loc, sums[..., 0], sums[..., 1:]


class GATModel(nn.Module):
    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_layers: int, num_heads: int = 4, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        """Weights are drawn on the CPU from ``generator``; move the model
        with ``.to(device)``."""
        super().__init__()
        self.in_dim = in_dim
        self.hidden = hidden
        self.num_classes = num_classes
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.dropout = dropout
        register_gat_params(self, in_dim, hidden, num_classes, num_layers,
                            num_heads, generator)

    def layer_params(self, i: int) -> dict:
        return {name: getattr(self, f"layer_{i}/{name}")
                for name in GAT_LEAVES}

    def layer(self, i: int, block: Block, x: torch.Tensor,
              is_last: bool) -> torch.Tensor:
        p = self.layer_params(i)
        k, d_out = p["attn_l"].shape
        n = block.dst_cap
        feat = (x.float() @ p["w"]).reshape(-1, k, d_out)  # [S_cap, K, D]
        er = torch.einsum("skd,kd->sk", feat[:n], p["attn_r"])
        _, s, v = coo_attention(feat, p["attn_l"], block.edge_src,
                                block.edge_dst, er)
        out = v / s.clamp(min=1e-16)[..., None]  # [n, K, D]
        if is_last:
            return out.mean(dim=1)
        return out.reshape(n, k * d_out) + p["b"]

    def forward(self, batch: SampledBatch, x0: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[T_cap, num_classes]`` for the batch's target frame.
        Dropout applies in training mode, drawn from ``generator``."""
        x = x0
        last = len(batch.blocks) - 1
        for i, block in enumerate(batch.blocks):
            x = self.layer(i, block, x, is_last=(i == last))
            if i != last:
                x = dropout(F.elu(x), self.dropout, generator, self.training)
        return x
