"""Split-parallel models and the training step of one partition.

The JAX package's ``parallel/model.py``: ``SplitSAGE`` and ``SplitGCN`` as
``nn.Module``s whose weights are plain ``[in, out]`` tensors registered as
``layer_{i}/w`` and ``layer_{i}/b`` (the keys of the JAX parameter
pytree, so ``utils.checkpoint`` loads JAX weights unchanged), the device
CSR for on-device innermost sampling, and the train step and forward.
Weights stay f32; ``dtype`` is the storage precision of activations
between layers, with f32 accumulation, as in the JAX models.

At P = 1 the step is the JAX step on a one-device mesh: no process group
and no collective. At P > 1 each rank runs the per-device body of the JAX
step (``model.py:647-744``) on its own partition's row of the batch
(``ranks``, a ``parallel.dist.DistContext``): the boundary shuffle of
every layer that carries ``push_idx``, the loss terms ``[nll, count,
correct]`` all-reduced before the backward, and one SUM all-reduce of the
gradients before the optimizer step.

Only the feature frame's consumers differentiate: the frame never
requires grad, so layer 0 builds no ``dx`` (JAX differentiates the
params only).
"""

from __future__ import annotations

import torch
import torch.distributed as torch_dist
from torch import nn

from occ_gnn_tpu_torch.models.common import dropout, linear, linear_init
from occ_gnn_tpu_torch.parallel.dist import DistContext, all_reduce_gradients
from occ_gnn_tpu_torch.parallel.split import (
    SplitBatch,
    SplitLayer,
    aggregate,
    neigh_mean,
    shuffle_merge,
    slice_owned,
    synthesize_device_innermost,
)

_SEVERAL_PARTITIONS = ("a batch with several partitions in one process is "
                       "not ported: each rank takes its own partition's row "
                       "(ROADMAP.md queue 1, item 7b, several partitions per "
                       "process)")


def make_device_csr(graph, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The graph's in-neighbour CSR on ``device`` as int32 ``(indptr,
    indices)`` for device-innermost sampling (~255 MB at products scale)."""
    if graph.num_edges >= 2**31 or graph.num_nodes >= 2**31:
        raise ValueError(
            "device-innermost sampling keeps the CSR on device as int32: "
            f"graph has {graph.num_edges} edges / {graph.num_nodes} nodes "
            "(>= 2^31) — use the host innermost path"
        )
    return (
        torch.from_numpy(graph.indptr.astype("int32")).to(device),
        torch.from_numpy(graph.indices.astype("int32")).to(device),
    )


def _materialize_layers(layers, csr, generator):
    """Synthesize the device-sampled layers of one partition."""
    out = []
    for lyr in layers:
        if lyr.device_sampled:
            if csr is None:
                raise ValueError(
                    "batch has a device-sampled layer but the step was "
                    "built without csr= (make_device_csr(graph, device))"
                )
            if generator is None:
                raise ValueError(
                    "device-sampled layers need sample_generator= on every "
                    "step call"
                )
            lyr = synthesize_device_innermost(lyr, csr[0], csr[1], generator)
        out.append(lyr)
    return out


class SplitSAGE(nn.Module):
    """Split-parallel GraphSAGE: h_v = W.concat(x_v, mean_{N(v)+v} x_u) + b."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_layers: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        """Weights are drawn on the CPU from ``generator``; move the model
        with ``.to(device)``."""
        super().__init__()
        self.in_dim = in_dim
        self.hidden = hidden
        self.num_classes = num_classes
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = dtype
        dims = [in_dim] + [hidden] * (num_layers - 1) + [num_classes]
        for i in range(num_layers):
            init = linear_init(generator, self._fan_in(dims[i]), dims[i + 1])
            for name, value in init.items():
                self.register_parameter(f"layer_{i}/{name}",
                                        nn.Parameter(value))

    @staticmethod
    def _fan_in(dim: int) -> int:
        return 2 * dim  # concat(self, neighbour mean)

    def layer_params(self, i: int) -> dict:
        return {name: getattr(self, f"layer_{i}/{name}") for name in "wb"}

    @staticmethod
    def _merge(neigh: torch.Tensor, lyr: SplitLayer) -> torch.Tensor:
        """Add the boundary partials of the other partitions: a shuffle on
        every layer that carries ``push_idx`` when there is more than one
        partition (the device-synthesized layer 0 carries none)."""
        if lyr.push_idx is None or lyr.push_idx.shape[0] == 1:
            return neigh
        return shuffle_merge(neigh, lyr.push_idx, lyr.recv_idx)

    def layer(self, i: int, lyr: SplitLayer, x: torch.Tensor) -> torch.Tensor:
        merged = self._merge(aggregate(x, lyr), lyr)
        self_x, mean, mask = slice_owned(merged, lyr, x)
        h = linear(self.layer_params(i), torch.cat([self_x, mean], dim=-1))
        return h * mask

    def forward_local(self, layers: list[SplitLayer], x: torch.Tensor,
                      generator: torch.Generator | None = None):
        """One partition's forward; ``generator`` enables dropout between
        layers (training), ``None`` is the deterministic path. With more
        than one partition the layers shuffle over the process group."""
        last = len(layers) - 1
        for i, lyr in enumerate(layers):
            x = self.layer(i, lyr, x)
            if i != last:
                x = torch.relu(x)
                if generator is not None and self.dropout > 0.0:
                    x = dropout(x, self.dropout, generator, True)
                x = x.to(self.dtype)
        return x


class SplitGCN(SplitSAGE):
    """Split-parallel GCN: mean aggregation (self loop in edges) + linear."""

    @staticmethod
    def _fan_in(dim: int) -> int:
        return dim

    def layer(self, i: int, lyr: SplitLayer, x: torch.Tensor) -> torch.Tensor:
        merged = self._merge(aggregate(x, lyr), lyr)
        h = linear(self.layer_params(i), neigh_mean(merged, lyr))
        return h * lyr.owned_mask[:, None]


def _local_ce(logits: torch.Tensor, labels: torch.Tensor):
    """CE sum, valid count and correct count of one partition."""
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    correct = ((logits.argmax(dim=-1) == labels) & valid).sum()
    return nll.sum(), valid.sum(), correct


def _check_dropout_rng(model, generator) -> None:
    """A model built with dropout > 0 must be trained with a generator:
    silently skipping regularization is worse than failing fast."""
    if getattr(model, "dropout", 0.0) > 0.0 and generator is None:
        raise ValueError(
            f"model has dropout={model.dropout} but the train step was "
            "called without a generator — pass step(..., generator=g)"
        )


def _local_layers(batch: SplitBatch,
                  ranks: DistContext | None) -> list[SplitLayer]:
    """This rank's layers: the batch holds one partition's row, and its
    P-slot axes are as wide as the process group."""
    if batch.num_partitions != 1:
        raise NotImplementedError(_SEVERAL_PARTITIONS)
    layers = [lyr.partition(0) for lyr in batch.layers]
    P = ranks.world_size if ranks is not None else 1
    for lyr in layers:
        if lyr.push_idx is not None and lyr.push_idx.shape[0] != P:
            raise ValueError(f"the batch was sliced for "
                             f"{lyr.push_idx.shape[0]} partitions, the "
                             f"process group has {P}")
    return layers


def _global_ce(nll, count, correct):
    """``[nll, count, correct]`` summed over the ranks, detached (JAX's
    psum of the three, ``model.py:683-687``), on the device."""
    totals = torch.stack([nll.detach().double(), count.double(),
                          correct.double()])
    torch_dist.all_reduce(totals)
    return totals


def make_split_train_step(model: SplitSAGE, optimizer, csr=None,
                          ranks: DistContext | None = None):
    """``step(batch, x0, generator=None, sample_generator=None) -> (loss,
    correct, count)``: forward, masked CE, backward and one optimizer
    update of ``model`` in place. ``x0`` is the input frame ``[1, F, H]``
    (the cache frame or the gathered rows) and ``batch`` holds one
    partition's row. ``ranks`` (``parallel.dist``) is the process group
    of a P > 1 run, rank r holding partition r; the loss, correct and
    count returned are then global, the same on every rank.

    ``csr`` (``make_device_csr``) enables device-sampled innermost layers;
    those steps need ``sample_generator``, a generator on the device.
    Nothing here waits for the device: the results are device tensors."""

    def step(batch: SplitBatch, x0: torch.Tensor,
             generator: torch.Generator | None = None,
             sample_generator: torch.Generator | None = None):
        _check_dropout_rng(model, generator)
        layers = _materialize_layers(_local_layers(batch, ranks), csr,
                                     sample_generator)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model.forward_local(layers, x0[0], generator)
        nll, count, correct = _local_ce(logits, batch.labels[0])
        if ranks is None:
            loss = nll / count.clamp(min=1)
            loss.backward()
            optimizer.step()
            return loss.detach(), correct, count
        totals = _global_ce(nll, count, correct)
        count_g = totals[1].clamp(min=1)
        (nll / count_g.float()).backward()
        all_reduce_gradients(model.parameters())
        optimizer.step()
        return ((totals[0] / count_g).float(), totals[2].long(),
                totals[1].long())

    return step


def make_split_forward(model: SplitSAGE, csr=None,
                       ranks: DistContext | None = None):
    """``fwd(batch, x0, sample_generator=None) -> logits [1, T_cap, C]``:
    inference on this rank's partition, without dropout or gradients
    (with the boundary shuffles when ``ranks`` holds P > 1 ranks)."""

    @torch.no_grad()
    def fwd(batch: SplitBatch, x0: torch.Tensor,
            sample_generator: torch.Generator | None = None):
        layers = _materialize_layers(_local_layers(batch, ranks), csr,
                                     sample_generator)
        model.eval()
        return model.forward_local(layers, x0[0])[None]

    return fwd
