"""Device-side dense neighbour sampling: the quiver baseline.

The JAX package's ``sampling/device_sampler.py``, itself the counterpart
of the reference's Quiver baseline (GPU sampling, a feature table
replicated on every device, DDP). The host hands each step only target
ids; the draws, the feature gather, the forward, the backward and Adam
run on the device.

  * The in-neighbour CSR lives on the device as int32
    (``parallel.model.make_device_csr``). Each frontier node draws exactly
    ``fanout`` neighbours uniformly *with replacement*, ``r % deg`` for a
    ``torch.randint`` draw, even where its degree is below the fan-out (the
    host samplers take every neighbour there). A zero-degree node draws
    itself.
  * No deduplication: the frontier after layer l is ``cat(frontier,
    drawn.flatten())``, a dense multiset of ``S_l = S_{l-1} * (1 +
    fanout_l)`` rows whose prefix is the previous frontier, so every shape
    is static and each layer's self rows come first.
  * Aggregation is a dense mean over the fan-out axis, ``(x_self + sum_K
    x_nbr) / (K + 1)``: the mean-with-self-loop of the padded COO path
    without a scatter, so the path launches no segment-sum.
  * Data parallelism over P shards: every process draws one permutation
    alike and cuts each batch into ``[P, B / P]`` rows; a process holding
    shards ``[lo, hi)`` (``parallel.dist``) takes those rows, draws and
    drops out each from the shard's own streams, runs the forward once a
    shard, and sums the shards' loss terms and gradients locally and over
    the processes (``parallel.model.global_update``). It holds one CSR
    and one feature table, whatever its number of shards, as the JAX
    mesh replicates them.

The draws use torch's Philox generator where JAX uses threefry, so they
cannot match JAX's; ``sample`` and ``forward`` are kept apart so that both
packages can be fed the same frontiers.
"""

from __future__ import annotations

import numpy as np
import torch

from occ_gnn_tpu_torch.models.common import dropout, linear
from occ_gnn_tpu_torch.ops.device_sample import (
    dense_layer_mean,
    draw_neighbors,
    gather_mean,
)
from occ_gnn_tpu_torch.parallel.dist import (
    DistContext,
    rank_seed,
    single_process,
)
from occ_gnn_tpu_torch.parallel.model import global_update, make_device_csr
from occ_gnn_tpu_torch.utils.timers import span

_DRAW_HIGH = 2**31 - 1  # JAX draws in [0, int32 max)


def _draws(n: int, fanout: int, generator: torch.Generator,
           device) -> torch.Tensor:
    """A layer's draws, int32 ``[n, fanout]`` in ``[0, 2^31 - 1)``."""
    return torch.randint(0, _DRAW_HIGH, (n, fanout), generator=generator,
                         device=device, dtype=torch.int32)


def sample_neighbors_dense(csr, frontier: torch.Tensor, fanout: int,
                           generator: torch.Generator) -> torch.Tensor:
    """``fanout`` uniform in-neighbours of each frontier node, with
    replacement: int32 ``[len(frontier), fanout]``. A zero-degree node
    yields itself. The draws of ``dense_frontiers``' next layer (its
    ``draw_neighbors`` launch on the card)."""
    n = frontier.shape[0]
    r = _draws(n, fanout, generator, frontier.device)
    return draw_neighbors(frontier, *csr, r)[n:].view(n, fanout)


def dense_frontiers(csr, targets: torch.Tensor, fanouts: list[int],
                    generator: torch.Generator) -> list[torch.Tensor]:
    """Every layer's frontier, outermost first (``frontiers[0]`` is
    ``targets``): ``frontiers[l] = cat(frontiers[l - 1], drawn.flatten())``,
    so the self rows of each layer are the prefix; one ``torch.randint``
    and one ``ops/device_sample.draw_neighbors`` a layer."""
    frontier = targets
    out = [frontier]
    for fanout in fanouts:
        r = _draws(frontier.shape[0], fanout, generator, frontier.device)
        frontier = draw_neighbors(frontier, *csr, r)
        out.append(frontier)
    return out


def _growth(fanouts: list[int]) -> list[int]:
    """The frontier's size per target at each depth, outermost first."""
    sizes = [1]
    for fanout in fanouts:
        sizes.append(sizes[-1] * (1 + fanout))
    return sizes


def dense_sage_forward(model, x_deepest: torch.Tensor, fanouts: list[int],
                       *, dtype: torch.dtype = torch.float32,
                       generator: torch.Generator | None = None
                       ) -> torch.Tensor:
    """SAGE over dense frontiers with the weights of ``model`` (a
    ``models.SAGEModel``): ``x_deepest`` holds the deepest frontier's
    feature rows in its multiset order. The first layer's inputs are
    ``ops/device_sample.dense_layer_mean`` of them; the rest is
    ``dense_sage_layers``."""
    sizes = _growth(fanouts)
    total = x_deepest.shape[0]
    if total % sizes[-1]:
        raise ValueError(
            f"x_deepest rows ({total}) not a multiple of the dense frontier "
            f"growth factor {sizes[-1]} for fanouts {fanouts}")
    n = total // sizes[-1] * sizes[-2]
    x_self, mean = dense_layer_mean(x_deepest, n, fanouts[-1])
    return dense_sage_layers(model, x_self, mean, fanouts, dtype=dtype,
                             generator=generator)


def dense_sage_layers(model, x_self: torch.Tensor, mean: torch.Tensor,
                      fanouts: list[int], *,
                      dtype: torch.dtype = torch.float32,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """SAGE over dense frontiers from the first layer's inputs: the f32
    self rows ``x_self`` and neighbour means ``mean`` of the deepest
    sampled layer (``gather_mean`` or ``dense_layer_mean``). The layer
    math is the padded path's, ``h = W . cat(self, mean) + b``,
    accumulated in f32; between layers ReLU, dropout (when ``model`` is
    training, drawn from ``generator``) and a cast to the storage
    ``dtype``, as in JAX."""
    num_layers = len(fanouts)
    sizes = _growth(fanouts)
    if x_self.shape[0] % sizes[-2]:
        raise ValueError(
            f"x_self rows ({x_self.shape[0]}) not a multiple of the dense "
            f"frontier growth factor {sizes[-2]} for fanouts {fanouts}")
    batch = x_self.shape[0] // sizes[-2]
    x = None
    for i in range(num_layers):
        if i:
            m = num_layers - 1 - i      # sampled layer consumed (outer idx)
            fanout = fanouts[m]
            x_self, mean = dense_layer_mean(x, batch * sizes[m], fanout)
        x = linear(model.layer_params(i), torch.cat([x_self, mean], dim=-1))
        if i != num_layers - 1:
            x = dropout(torch.relu(x), model.dropout, generator,
                        model.training)
            x = x.to(dtype)
    return x


class DeviceSampleTrainer:
    """Epoch loop of the quiver baseline for this process, which holds
    shards ``[lo, hi)`` of ``ranks`` (or, without it, the only shard):
    the host hands each step the next shuffled target and label ids; the
    rest runs on ``device``.

    The features are held on the device in ``dtype`` and take no
    gradient; shard p draws from a generator seeded ``rank_seed(seed,
    p)`` and drops out from one seeded ``rank_seed(seed ^ 0x5EED, p)``,
    whichever process holds it."""

    def __init__(self, graph, fanouts: list[int], batch_size: int, model,
                 optimizer, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str,
                 ranks: DistContext | None = None):
        self.graph = graph
        self.fanouts = list(fanouts)
        self.model = model
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.ranks = (ranks if ranks is not None
                      else single_process(1, self.device))
        self.num_shards = self.ranks.num_partitions
        if batch_size % self.num_shards:
            raise ValueError(f"batch_size {batch_size} must be divisible by "
                             f"the {self.num_shards} shards")
        self.per_shard = batch_size // self.num_shards
        self.dtype = dtype
        self.csr = make_device_csr(graph, self.device)
        # Cast on the host, so the one upload carries the storage dtype.
        self.features = torch.from_numpy(np.ascontiguousarray(
            graph.features, dtype=np.float32)).to(dtype).to(self.device)
        self.rng = np.random.default_rng(seed)
        shards = range(self.ranks.lo, self.ranks.hi)
        self.generators = [torch.Generator(self.device).manual_seed(
            rank_seed(seed, p)) for p in shards]
        self.dropout_generators = [torch.Generator(self.device).manual_seed(
            rank_seed(seed ^ 0x5EED, p)) for p in shards]
        self.steps = 0

    def epoch_batches(self, nodes: np.ndarray):
        """One epoch's ``(targets, labels)``, int32 ``[P, B / P]`` each,
        the same in every process; the last batch's missing rows (in the
        last shards' rows, whatever the placement) have target 0 and
        label -1."""
        nodes = nodes[self.rng.permutation(nodes.shape[0])]
        bs = self.per_shard * self.num_shards
        for i in range(0, nodes.shape[0], bs):
            chunk = nodes[i : i + bs]
            targets = np.zeros(bs, dtype=np.int32)
            labels = np.full(bs, -1, dtype=np.int32)
            targets[: chunk.shape[0]] = chunk
            labels[: chunk.shape[0]] = self.graph.labels[chunk]
            yield (targets.reshape(self.num_shards, self.per_shard),
                   labels.reshape(self.num_shards, self.per_shard))

    def sample(self, targets: torch.Tensor, local: int = 0
               ) -> list[torch.Tensor]:
        """The dense frontiers of one shard's targets (the draws alone),
        drawn from the stream of local shard ``local`` (shard ``lo +
        local``); -1 pads read node 0 (their loss is masked by label -1).
        ``forward(sample(targets))`` is JAX's ``dense_logits``."""
        with span("quiver_draw"):
            return dense_frontiers(self.csr, targets.clamp(min=0),
                                   self.fanouts, self.generators[local])

    def forward(self, frontiers: list[torch.Tensor], local: int = 0
                ) -> torch.Tensor:
        """The logits of the targets ``frontiers[0]``: the deepest
        frontier's self rows and first-layer means (``gather_mean``, which
        writes no frame of its rows), then the dense layers, dropping out
        from local shard ``local``'s stream."""
        with span("quiver_gather"):
            x_self, mean = gather_mean(self.features, frontiers[-1],
                                       frontiers[-2].shape[0],
                                       self.fanouts[-1])
        with span("dense_sage_forward"):
            return dense_sage_layers(
                self.model, x_self, mean, self.fanouts, dtype=self.dtype,
                generator=self.dropout_generators[local])

    def step(self, targets: np.ndarray, labels: np.ndarray):
        """One update on this process's rows ``[lo, hi)`` of ``[P, B / P]``
        ids -> ``(loss, correct, count)``, global over the shards, on the
        device. A step is the span ``occ.step``; inside it
        ``occ.step.upload`` (the ids' copies to the device),
        ``occ.step.forward`` (each shard's draws and forward) and
        ``global_update``'s spans."""
        lo, hi = self.ranks.lo, self.ranks.hi
        with span("occ.step"):
            with span("occ.step.upload"):
                t = torch.from_numpy(targets[lo:hi]).to(self.device)
                lab = torch.from_numpy(labels[lo:hi]).to(self.device)
            self.model.train()
            self.optimizer.zero_grad(set_to_none=True)
            with span("occ.step.forward"):
                logits = [self.forward(self.sample(t[j], j), j)
                          for j in range(hi - lo)]
            self.steps += 1
            return global_update(self.model, self.optimizer, logits,
                                 list(lab.unbind(0)), self.ranks)

    def train_epoch(self, nodes: np.ndarray):
        """One epoch over ``nodes`` -> ``(last loss, correct, total)``; the
        host reads the device once, at the end."""
        correct = total = 0
        loss = torch.zeros(())
        for targets, labels in self.epoch_batches(nodes):
            loss, c, t = self.step(targets, labels)
            correct = correct + c
            total = total + t
        return float(loss), int(correct), int(total)
