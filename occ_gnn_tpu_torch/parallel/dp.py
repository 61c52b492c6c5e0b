"""Data-parallel (DDP) training over P shards, L = P / W of them in each
of W processes.

The JAX package's ``parallel/dp.py``, the baseline of the reference's
no-cache DDP trainer: the train nodes are sharded P ways, each shard is
sampled into its own minibatches and run through the single-chip model
(``models.get_model``: sage, gcn or gat), and the gradients are summed
over the shards, as the ``shard_map`` transpose sums them for replicated
weights. A process runs the model once per shard it holds
(``parallel.dist``: shards ``[lo, hi)``), sums the shards' loss terms and
gradients locally, and all-reduces them over the processes; a run of one
process issues no collective, whatever its P.

JAX stacks the P devices' batches into one array (``stack_batches``) for
one ``shard_map`` call; the port keeps the L batches as a list, one model
call each, so that function has no counterpart. At P = 1 (one batch,
``ranks=None``) the step is also the single-chip train step (JAX
``training.make_train_step``) of ``--mode single`` and ``pa-cache``.
"""

from __future__ import annotations

import torch

from occ_gnn_tpu_torch.ops.blocks import SampledBatch
from occ_gnn_tpu_torch.parallel.dist import DistContext
from occ_gnn_tpu_torch.parallel.model import _check_dropout_rng, global_update
from occ_gnn_tpu_torch.utils.timers import span


def make_dp_train_step(model: torch.nn.Module, optimizer,
                       ranks: DistContext | None = None):
    """``step(batches, x0s, generators=None) -> (loss, correct, count)``:
    the forward of each of this process's shard batches (a sequence of
    ``SampledBatch``, or one) on its input frame (``x0s``, one per batch),
    the masked CE with its ``[nll, count, correct]`` summed over the
    shards and all-reduced over the processes of ``ranks``, the backward
    of ``nll / global_count``, the SUM all-reduce of the gradients and
    one optimizer step of ``model`` in place. The loss, correct and count
    are global, the same in every process. ``torch.optim.Adam`` has
    ``optax.adam``'s defaults (betas 0.9/0.999, eps 1e-8 outside the
    square root).

    ``generators`` (one generator on the device per shard, or one for a
    single batch; shard p's seeded alike whichever process holds it, as
    JAX folds the axis index into the dropout key) enables dropout; a
    model with dropout > 0 needs them. A step is the span ``occ.step``,
    with ``occ.step.forward`` and ``global_update``'s spans inside it."""

    def step(batches, x0s, generators=None):
        if isinstance(batches, SampledBatch):
            batches, x0s, generators = [batches], [x0s], [generators]
        elif generators is None:
            generators = [None] * len(batches)
        if not len(batches) == len(x0s) == len(generators):
            raise ValueError(f"{len(batches)} shard batches, {len(x0s)} "
                             f"input frames and {len(generators)} "
                             "generators: one of each a shard")
        for gen in generators:
            _check_dropout_rng(model, gen)
        with span("occ.step"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            with span("occ.step.forward"):
                logits = [model(b, x0, gen)
                          for b, x0, gen in zip(batches, x0s, generators)]
            return global_update(model, optimizer, logits,
                                 [b.labels for b in batches], ranks)

    return step
