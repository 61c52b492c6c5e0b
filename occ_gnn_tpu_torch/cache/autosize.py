"""Device-memory cache auto-sizing (``--cache-per auto``).

The JAX package's ``cache/autosize.py``: the sizing policy is unchanged,
only the budget is read from the CUDA device.

Policy, given a free-memory budget B and headroom h:

  usable_rows = floor(B * (1-h) / (feature_dim * dtype_bytes))
  * usable_rows >= max partition size  ->  no-refresh cache: every owned
    node is statically cached, and any remaining budget caches foreign
    high-degree extras, up to full replication (pct = 1.0).
  * otherwise -> largest refreshing cache that fits:
    pct = (usable_rows - refresh_cap - 1) / N  (the +1 is the reserved
    dense-aggregation zero row).

The headroom covers what shares the device with the frames: weights and
optimizer state, the per-batch arena and activations, the device CSR.

With several processes each reads its own device's free memory, which
differs between processes that share a card; the trainer has the
processes agree on the minimum of their percentages.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from occ_gnn_tpu_torch.data.graph import Graph

# Budget when the device reports none (the CPU): 16 GiB, the JAX
# package's default, so --cpu plans equal the JAX package's CPU plans.
# Override with OCC_HBM_BYTES.
_DEFAULT_BUDGET = 16 * 1024**3


def hbm_budget_bytes(device: torch.device | str | None = None) -> int:
    """Free bytes of the target device's memory.

    Order: the ``OCC_HBM_BYTES`` override; ``torch.cuda.mem_get_info`` on
    a CUDA device; else the 16 GiB default."""
    env = os.environ.get("OCC_HBM_BYTES")
    if env:
        return int(float(env))
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return _DEFAULT_BUDGET


def auto_cache_percentage(
    graph: Graph,
    partition_map: np.ndarray,
    num_partitions: int,
    dtype_bytes: int,
    refresh_cap: int,
    budget_bytes: int | None = None,
    headroom: float = 0.35,
) -> float:
    """Largest cache fraction whose per-chip frame fits the HBM budget.

    Returns a value directly usable as ``CachePlan.cache_percentage``:
    >= 1/P means no per-batch refresh (every owned node statically
    cached); 1.0 means full feature replication per chip. Returns 0.0
    when not even a minimal refreshing cache fits (caller should train
    uncached).
    """
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes()
    n = graph.num_nodes
    row_bytes = graph.feature_dim * dtype_bytes
    usable_rows = int(budget_bytes * (1.0 - headroom)) // max(row_bytes, 1)
    pmap = np.asarray(partition_map)
    max_own = int(np.bincount(pmap, minlength=num_partitions).max())
    if usable_rows >= max_own:
        # No-refresh regime. The frame holds max(own_p, pct*n) rows (+1
        # zero row); grow pct to spend the budget on foreign extras. The
        # max() with 1/P guards float rounding at the exact boundary —
        # CachePlan switches regimes on pct >= 1/P.
        pct = min(max(usable_rows - 1, max_own) / n, 1.0)
        return float(max(pct, 1.0 / num_partitions))
    pct = (usable_rows - refresh_cap - 1) / n
    return float(max(pct, 0.0))


def resolve_cache_percentage(
    spec: str | float,
    graph: Graph,
    partition_map: np.ndarray,
    num_partitions: int,
    dtype_bytes: int,
    refresh_cap: int,
    budget_bytes: int | None = None,
    device: torch.device | str | None = None,
) -> float:
    """CLI-facing resolver: numeric strings pass through; ``auto`` sizes
    to the budget of ``device`` (``hbm_budget_bytes``)."""
    if isinstance(spec, str) and spec.strip().lower() == "auto":
        if budget_bytes is None:
            budget_bytes = hbm_budget_bytes(device)
        pct = auto_cache_percentage(
            graph, partition_map, num_partitions, dtype_bytes,
            refresh_cap, budget_bytes=budget_bytes,
        )
        return pct
    return float(spec)
