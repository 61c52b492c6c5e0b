"""The yardstick's operation and byte counts, and the card's peaks.

The kernels' bytes and operations are those of the port's
``chip_smoke.py`` (``dense_cases``, ``gat_attention_cases``,
``quiver_sample_cases``), copied here and counted on valid rows only: a
step's counts (``LayerCounts``) are taken from the batch the step ran.
Each input byte is counted once and each output byte once; a call's
least time is the larger of its bytes over the memory rate and its
operations over the f32 rate. Each model's FLOPs a step
(``models/<model>.py``'s ``step_flops``) are the forward and backward
products and sums of valid rows, nothing recomputed: the rewrite of the
JAX package's ``bench.py`` ``model_flops_bytes``, which counted padded
capacities.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense: f32 outside the tensor cores (TF32 is
# off), and HBM3. Published at the 700 W limit.
F32_RATE = 67e12
MEMORY_RATE = 3.35e12
F32_BYTES = 4

# Device op names of each kernel family in a trace (substrings of the
# CUDA kernels' names in ``occ_gnn_tpu_torch/csrc``).
KERNELS = {
    "gat_attention": ("attention_fwd", "attention_bwd"),
    "dense_gather_sum": ("gather_sum", "scatter_rows"),
    "device_sample": ("draw_kernel", "gather_mean_kernel"),
}


@dataclasses.dataclass
class LayerCounts:
    """One layer of one step, valid rows only: ``K`` slot rows of the
    neighbour matrix, ``D`` dst rows, ``V`` filled slots, ``R`` distinct
    input rows read, ``S`` input rows (the frame a gradient is written
    to), ``h_in`` and ``h_out`` the widths."""

    K: int
    D: int
    V: int
    R: int
    S: int
    h_in: int
    h_out: int


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / MEMORY_RATE, ops / F32_RATE)


def dense_gather_sum_bound(c: LayerCounts, first: bool) -> float:
    """``dense_gather_sum`` forward and, above the first layer (whose
    frame takes no gradient), ``dense_scatter_add``."""
    h = c.h_in
    t = bound_s(4 * c.K * c.D + F32_BYTES * c.R * h + 4 * c.D * h, c.V * h)
    if not first:
        t += bound_s(4 * c.K * c.D + 4 * c.D * h + 4 * c.S * h, c.V * h)
    return t


def gat_attention_bound(c: LayerCounts, heads: int, first: bool) -> float:
    """``gat_attention_fwd`` and ``gat_attention_bwd`` (with the rows'
    gradient above the first layer)."""
    h, hb = c.h_in, heads * c.h_in
    fwd = bound_s(4 * c.K * c.D + F32_BYTES * c.R * h + 4 * hb
                  + 12 * c.D * heads + 4 * c.D * hb, 4 * c.V * hb)
    grad_x = not first
    bwd = bound_s(4 * c.K * c.D + F32_BYTES * c.R * h + 4 * hb
                  + 16 * c.D * heads + 4 * c.D * hb
                  + (4 * c.V * h if grad_x else 0),
                  (6 + (4 if grad_x else 0)) * c.V * hb)
    return fwd + bwd


def draw_bound(n: int, K: int, live: int) -> float:
    """``draw_neighbors`` over a frontier of ``n`` entries, ``live`` of
    them with a neighbour."""
    coalesced = 4 * n + 4 * n * K + 4 * n * (1 + K)
    return bound_s(coalesced + 8 * n + 4 * live * K, n * K)


def gather_mean_bound(n: int, K: int, h: int, rows: int) -> float:
    """``gather_mean`` of ``n`` outputs of ``K + 1`` rows each, ``rows``
    of them distinct."""
    coalesced = 4 * n * (1 + K) + 2 * 4 * n * h
    return bound_s(coalesced + rows * h * F32_BYTES, n * (K + 2) * h)
