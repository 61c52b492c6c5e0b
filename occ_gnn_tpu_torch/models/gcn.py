"""GCN over padded blocks (single-chip path): aggregation with the self loop,
then a linear map.

The JAX package's ``models/gcn.py`` at its default (and the CLI's)
``norm="mean"``: the reference prototype's plain mean aggregation, one
``[E, H]`` message through the sorted segment-sum a layer. The JAX
package's ``norm="sym"`` is not ported: no flag selects it. Weights are
``layer_{i}/w`` and ``layer_{i}/b``, as in SAGE.
"""

from __future__ import annotations

import torch
from torch import nn

from occ_gnn_tpu_torch.models.common import dropout, linear, linear_init
from occ_gnn_tpu_torch.ops.blocks import Block, SampledBatch
from occ_gnn_tpu_torch.ops.segment import spmm_mean


class GCNModel(nn.Module):
    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_layers: int, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        """Weights are drawn on the CPU from ``generator``; move the model
        with ``.to(device)``."""
        super().__init__()
        self.in_dim = in_dim
        self.hidden = hidden
        self.num_classes = num_classes
        self.num_layers = num_layers
        self.dropout = dropout
        dims = [in_dim] + [hidden] * (num_layers - 1) + [num_classes]
        for i in range(num_layers):
            init = linear_init(generator, dims[i], dims[i + 1])
            for name, value in init.items():
                self.register_parameter(f"layer_{i}/{name}",
                                        nn.Parameter(value))

    def layer_params(self, i: int) -> dict:
        return {name: getattr(self, f"layer_{i}/{name}") for name in "wb"}

    def layer(self, i: int, block: Block, x: torch.Tensor) -> torch.Tensor:
        neigh = spmm_mean(x, block.edge_src, block.edge_dst, block.dst_cap)
        return linear(self.layer_params(i), neigh)

    def forward(self, batch: SampledBatch, x0: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[T_cap, num_classes]``; ReLU and dropout between
        layers (training mode, drawn from ``generator``)."""
        x = x0
        last = len(batch.blocks) - 1
        for i, block in enumerate(batch.blocks):
            x = self.layer(i, block, x)
            if i != last:
                x = dropout(torch.relu(x), self.dropout, generator,
                            self.training)
        return x
