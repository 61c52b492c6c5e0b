"""Data-parallel (DDP) training, one process per rank.

The JAX package's ``parallel/dp.py``, the baseline of the reference's
no-cache DDP trainer: the train nodes are sharded over the ranks, each
rank samples and trains on its own minibatches with the single-chip model
(``models.get_model``: sage, gcn or gat), and the gradients are summed
over the ranks, as the ``shard_map`` transpose sums them for replicated
weights.

JAX stacks the P devices' batches into one array (``stack_batches``); a
rank here holds one batch, so that function has no counterpart. At P = 1
(``ranks=None``) the step runs no collective: it is then also the
single-chip train step (JAX ``training.make_train_step``) of
``--mode single`` and ``pa-cache``.
"""

from __future__ import annotations

import torch

from occ_gnn_tpu_torch.ops.blocks import SampledBatch
from occ_gnn_tpu_torch.parallel.dist import DistContext
from occ_gnn_tpu_torch.parallel.model import _check_dropout_rng, global_update


def make_dp_train_step(model: torch.nn.Module, optimizer,
                       ranks: DistContext | None = None):
    """``step(batch, x0, generator=None) -> (loss, correct, count)``: this
    rank's forward on its own ``SampledBatch`` and input frame ``x0``, the
    masked CE with its ``[nll, count, correct]`` all-reduced, the backward
    of ``nll / global_count``, the SUM all-reduce of the gradients and one
    optimizer step of ``model`` in place. The loss, correct and count are
    global, the same on every rank. ``torch.optim.Adam`` has
    ``optax.adam``'s defaults (betas 0.9/0.999, eps 1e-8 outside the
    square root).

    ``generator`` (a generator on the device, one stream per rank, as JAX
    folds the axis index into the dropout key) enables dropout; a model
    with dropout > 0 needs one."""

    def step(batch: SampledBatch, x0: torch.Tensor,
             generator: torch.Generator | None = None):
        _check_dropout_rng(model, generator)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch, x0, generator)
        return global_update(model, optimizer, logits, batch.labels, ranks)

    return step
