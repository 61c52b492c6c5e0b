"""Lowering switches of the split path: which form of an op the port runs.

The port's copy of the readers and setters of the JAX package's
``ops/config.py`` (``occ_gnn_tpu/ops/config.py:33-231``), with the same
environment variables, choices, defaults and error texts. Each reader
takes its environment variable the first time it is asked and keeps the
value for the rest of the process; a setter replaces it. JAX reads them
when it traces a step; the port reads them each time an op runs, so a
setter takes effect at the next call.

- ``OCC_DENSE_AGG``: ``unrolled`` (default) or ``tiled``, the dense
  fanout-K aggregation (``parallel/split.local_aggregate_dense``): one
  launch of the ``dense_gather_sum`` kernel a layer, or one a dst tile.
- ``OCC_GAT_ATTENTION``: ``batched`` (default), ``online`` or ``tiled``,
  split GAT's dense attention (``parallel/model.py``); ``tiled`` reads
  its tile height from ``OCC_GAT_TILE`` (default 4096) at each call.
- ``OCC_GAT_AGG``: ``einsum`` (default) or ``fma``, the weighted partial
  sum of the batched attention.
- ``OCC_GAT_REMAT``: ``none`` (default) or ``dots``, recomputation of the
  attention's elementwise chain in the backward.
- ``OCC_DEVICE_SAMPLE``: ``randint`` (default), ``bitsf32``,
  ``bitsf32_dk`` or ``window``, the on-device innermost sampler
  (``parallel/split.synthesize_device_innermost``); ``window`` also
  selects the doubled CSR of ``parallel/model.make_device_csr``.

Left out: ``OCC_USE_PALLAS``. On a CUDA tensor the port always launches
its kernel, and no switch routes around it.
"""

from __future__ import annotations

import os

_DENSE_AGG_CHOICES = ("unrolled", "tiled")
_GAT_ATTENTION_CHOICES = ("batched", "online", "tiled")
_GAT_AGG_CHOICES = ("fma", "einsum")
_GAT_REMAT_CHOICES = ("none", "dots")
_DEVICE_SAMPLE_CHOICES = ("randint", "bitsf32", "bitsf32_dk", "window")

# name -> (environment variable, choices, default)
_SWITCHES = {
    "dense_agg": ("OCC_DENSE_AGG", _DENSE_AGG_CHOICES, "unrolled"),
    "gat_attention": ("OCC_GAT_ATTENTION", _GAT_ATTENTION_CHOICES,
                      "batched"),
    "gat_agg": ("OCC_GAT_AGG", _GAT_AGG_CHOICES, "einsum"),
    "gat_remat": ("OCC_GAT_REMAT", _GAT_REMAT_CHOICES, "none"),
    "device_sample": ("OCC_DEVICE_SAMPLE", _DEVICE_SAMPLE_CHOICES,
                      "randint"),
}
_values: dict[str, str] = {}


def _read(name: str) -> str:
    if name not in _values:
        env, choices, default = _SWITCHES[name]
        v = os.environ.get(env, default)
        if v not in choices:
            raise ValueError(f"{env}={v!r} is not one of {choices}")
        _values[name] = v
    return _values[name]


def _set(name: str, value: str) -> None:
    choices = _SWITCHES[name][1]
    if value not in choices:
        raise ValueError(f"{name} impl must be one of {choices}")
    _values[name] = value


def dense_agg_impl() -> str:
    """``unrolled``: the K gathers summed into one f32 accumulator (one
    kernel launch on the card); ``tiled``: the same sums over dst tiles of
    ``parallel.split.DENSE_TILE`` rows, one launch a tile."""
    return _read("dense_agg")


def set_dense_agg_impl(value: str) -> None:
    _set("dense_agg", value)


def gat_attention_impl() -> str:
    """``batched``: one ``[K, D]`` leaf gather, exact two-pass softmax over
    K, weighting in leaf space, one projection per head; ``online``: a
    streaming softmax over K, one checkpointed step a k; ``tiled``: the
    batched form over dst tiles of ``OCC_GAT_TILE`` rows, projecting each
    k's leaves before weighting them."""
    return _read("gat_attention")


def set_gat_attention_impl(value: str) -> None:
    _set("gat_attention", value)


def gat_tile() -> int:
    """Dst rows a tile of the ``tiled`` GAT attention (``OCC_GAT_TILE``,
    read at each call as in JAX)."""
    return int(os.environ.get("OCC_GAT_TILE", "4096"))


def gat_agg_impl() -> str:
    """The batched attention's ``agg[d, c] = sum_k pw[k, d, c] *
    xg[k, d]``: ``einsum`` (one batched product) or ``fma`` (an unrolled
    K-loop of broadcast multiply-adds)."""
    return _read("gat_agg")


def set_gat_agg_impl(value: str) -> None:
    _set("gat_agg", value)


def gat_remat_impl() -> str:
    """``none``: autograd keeps every tensor the backward reads; ``dots``:
    it keeps the matrix products and recomputes the elementwise score
    chain (leaky_relu, mask, exp) in the backward."""
    return _read("gat_remat")


def set_gat_remat_impl(value: str) -> None:
    _set("gat_remat", value)


def device_sample_impl() -> str:
    """``randint``: K uniform integer draws a dst with replacement;
    ``bitsf32``: the same from 24 random bits scaled by the degree in f32;
    ``bitsf32_dk``: the same draws, the CSR read dst-major; ``window``: one
    start a dst and K consecutive neighbours of a doubled adjacency,
    without repeats."""
    return _read("device_sample")


def set_device_sample_impl(value: str) -> None:
    _set("device_sample", value)
