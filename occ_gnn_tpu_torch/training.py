"""The JAX package's ``training.py``: the host feature gather and the
single-chip evaluation step. Its train step is ``parallel.dp``'s
``make_dp_train_step`` at P = 1, one update shared with the DDP
baseline."""

from __future__ import annotations

import numpy as np
import torch

from occ_gnn_tpu_torch.models.common import (
    masked_accuracy,
    masked_cross_entropy,
)
from occ_gnn_tpu_torch.ops.blocks import SampledBatch


def gather_features(features: np.ndarray, input_nodes,
                    device: torch.device | str) -> torch.Tensor:
    """The input frame's feature rows, gathered on the host and sent to
    ``device`` in one copy (from pinned memory when the target is CUDA).

    Padding entries of ``input_nodes`` are -1. They read row 0 (torch would
    wrap -1 to the last row where JAX clamps) and are then set to 0."""
    if isinstance(input_nodes, torch.Tensor):
        idx = input_nodes.cpu().numpy()
    else:
        idx = np.asarray(input_nodes)
    device = torch.device(device)
    out = torch.empty((idx.shape[0], features.shape[1]), dtype=torch.float32,
                      pin_memory=device.type == "cuda")
    rows = out.numpy()
    np.take(features, np.maximum(idx, 0), axis=0, out=rows)
    rows[idx < 0] = 0.0
    return out.to(device, non_blocking=True)


def make_eval_step(model: torch.nn.Module):
    """``step(batch, x0) -> (loss, correct, total)`` without dropout or
    gradients."""

    @torch.no_grad()
    def step(batch: SampledBatch, x0: torch.Tensor):
        model.eval()
        logits = model(batch, x0)
        loss = masked_cross_entropy(logits, batch.labels)
        correct, total = masked_accuracy(logits, batch.labels)
        return loss, correct, total

    return step
