"""The on-device samplers: their hand-written Hopper kernels, their plain
versions, and the wrappers that choose between the two.

Three entries on one source, ``csrc/device_sample.cu``:

* ``synthesize_innermost(dst_global, indptr, indices, draws, K, src_cap,
  out_cap)``: split A's layer 0 from a resident int32 CSR, every field of
  ``parallel/split.synthesize_device_innermost`` under the default
  ``OCC_DEVICE_SAMPLE=randint`` lowering (``InnermostFields``). It
  replaces what XLA makes of JAX ``occ_gnn_tpu/parallel/split.py:200-310``
  (no ``pallas_call``); in the port it was some 30 torch ops a call.
* ``draw_neighbors(frontier, indptr, indices, r)``: quiver's next
  frontier, ``cat(frontier, drawn.flatten())``, in one launch (JAX
  ``occ_gnn_tpu/sampling/device_sampler.py:71-85``).
* ``gather_mean(features, frontier, n, K)``: quiver's deepest gather and
  first-layer mean, ``(x_self, mean)`` in f32 (JAX ``device_sampler.py:164``
  and ``:139-141``), without the ``[n * (1 + K), H]`` frame of the plain
  version. The features take no gradient, so there is no backward.

The random numbers are an input, drawn by the callers with
``torch.randint`` exactly as before the kernels existed: the same
generator, shape, range and dtype give the same draws, and the kernel and
its plain version the same sample. (Drawing inside the kernel, Philox from
the generator's seed and offset, would save the draw's launch and its
bytes but change every seed's bits.)

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches the kernel or raises. There is no fallback between the two.
Each counts its launches in ``<entry>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from occ_gnn_tpu_torch.ops.build import check_launch, load_kernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C entries of csrc/device_sample.cu, argument for argument, and what
# they return.
ARGTYPES = {
    # dst, d, indptr, num_nodes, indices, num_indices, draws, k, out_cap,
    # zero_row, nbr, owned_idx, owned_deg, self_idx, owned_mask, num_owned,
    # device, stream
    "synthesize_innermost": [_P, _L, _P, _L, _P, _L, _P, _I, _I, _I, _P, _P,
                             _P, _P, _P, _P, _I, _P],
    # frontier, n, indptr, num_nodes, indices, num_indices, r, k, out,
    # device, stream
    "draw_neighbors": [_P, _L, _P, _L, _P, _L, _P, _I, _P, _I, _P],
    # x, x_bf16, x_rows, h, f, n, k, x_self, mean, device, stream
    "gather_mean": [_P, _I, _L, _I, _P, _L, _I, _P, _P, _I, _P],
}


class InnermostFields(NamedTuple):
    """A synthesized layer 0, as ``SplitLayer`` holds it: ``nbr`` int32
    ``[K + 1, D]`` (the self row first, the zero row ``src_cap - 1`` in
    every unused slot), and over the first ``out_cap`` columns
    ``owned_idx`` int32 (the column, -1 at a pad), ``owned_deg`` f32
    (``min(deg, K) + 1``, 1 at a pad), ``self_idx`` int32 (the global id,
    0 at a pad) and ``owned_mask`` bool; ``num_owned`` int32 ``[]``, the
    columns that are no pad."""

    nbr: torch.Tensor
    owned_idx: torch.Tensor
    owned_deg: torch.Tensor
    self_idx: torch.Tensor
    owned_mask: torch.Tensor
    num_owned: torch.Tensor


def innermost_fields(g: torch.Tensor, valid: torch.Tensor,
                     take: torch.Tensor, nbr_main: torch.Tensor,
                     src_cap: int, out_cap: int) -> InnermostFields:
    """Every lowering's common tail (JAX ``_finish_innermost``): prepend
    the self slot to the ``[K, D]`` ``nbr_main`` and assemble the owned
    fields in rank order, from the clamped ids ``g``, the pad mask
    ``valid`` and ``take = min(deg, K)``."""
    zero_row = src_cap - 1
    self_rows = torch.where(valid, g, zero_row).to(torch.int32)
    nbr = torch.cat([self_rows[None, :], nbr_main.to(torch.int32)], dim=0)
    v = valid[:out_cap]
    ar = torch.arange(out_cap, dtype=torch.int32, device=g.device)
    return InnermostFields(
        nbr=nbr,
        owned_idx=torch.where(v, ar, -1),
        owned_deg=torch.where(v, (take[:out_cap] + 1).float(), 1.0),
        self_idx=torch.where(v, g[:out_cap], 0).to(torch.int32),
        owned_mask=v,
        num_owned=valid.sum().to(torch.int32),
    )


def synthesize_innermost_reference(dst_global: torch.Tensor,
                                   indptr: torch.Tensor,
                                   indices: torch.Tensor,
                                   draws: torch.Tensor, K: int, src_cap: int,
                                   out_cap: int) -> InnermostFields:
    """Plain version: the randint lowering's torch ops on given draws;
    ``sel = draws % deg`` where ``deg > K``, else ``k``."""
    dg = dst_global
    valid = dg >= 0
    g = dg.clamp(min=0)
    off = indptr.index_select(0, g)
    deg = torch.where(valid, indptr.index_select(0, g + 1) - off, 0)
    take = deg.clamp(max=K)
    kr = torch.arange(K, device=dg.device)[:, None]
    sel = torch.where(deg[None, :] > K, draws % deg.clamp(min=1)[None, :],
                      kr)
    # Slots k >= take are masked below; clamp keeps their reads in range
    # (JAX clamps the same gather silently).
    last = indices.shape[0] - 1
    src = indices[(off[None, :] + sel).clamp_(max=last)]
    nbr_main = torch.where(kr < take[None, :], src, src_cap - 1)
    return innermost_fields(g, valid, take, nbr_main, src_cap, out_cap)


def draw_neighbors_reference(frontier: torch.Tensor, indptr: torch.Tensor,
                             indices: torch.Tensor,
                             r: torch.Tensor) -> torch.Tensor:
    """Plain version: ``cat(frontier, nbr.reshape(-1))`` with ``nbr[s, k] =
    indices[indptr[f] + r[s, k] % max(deg, 1)]``, or ``f`` where ``deg ==
    0``, for ``f = frontier[s]``."""
    n, fanout = r.shape
    if indices.numel() == 0:
        nbr = frontier[:, None].expand(n, fanout)
    else:
        f = frontier.long()
        start = indptr[f].long()
        deg = indptr[f + 1].long() - start
        pos = start[:, None] + r % deg.clamp(min=1)[:, None]
        # A zero-degree node's position indptr[v] may be one past the last
        # edge (JAX clamps the gather, torch raises); it takes itself below.
        nbr = indices[pos.clamp(max=indices.numel() - 1)]
        nbr = torch.where(deg[:, None] > 0, nbr, frontier[:, None])
    return torch.cat([frontier, nbr.reshape(-1)])


def dense_layer_mean(x: torch.Tensor, n: int, fanout: int):
    """The first dense layer's inputs from the rows of a frontier in its
    multiset order: ``x_self = x[:n]`` in f32 and ``mean = (x_self + sum
    over k of x[n + s * fanout + k]) / (fanout + 1)``."""
    x_self = x[:n].float()
    nbr_sum = x[n:].reshape(n, fanout, -1).sum(dim=1, dtype=torch.float32)
    return x_self, (x_self + nbr_sum) / (fanout + 1.0)


def gather_mean_reference(features: torch.Tensor, frontier: torch.Tensor,
                          n: int, fanout: int):
    """Plain version: the deepest frontier's rows gathered into a frame,
    then ``dense_layer_mean`` of it."""
    return dense_layer_mean(features.index_select(0, frontier), n, fanout)


def distinct_rows(frontier: torch.Tensor, n: int,
                  fanout: int) -> torch.Tensor:
    """How many distinct table rows each of ``gather_mean``'s ``n``
    outputs names among its self id and its ``fanout`` draws: int64
    ``[n]``, the rows its kernel reads once each (at ``fanout + 1 <=
    32``)."""
    ids = torch.cat([frontier[:n, None], frontier[n:].view(n, fanout)], 1)
    ids = ids.sort(dim=1).values
    return 1 + (ids[:, 1:] != ids[:, :-1]).sum(dim=1)


def run_sectors(frontier: torch.Tensor, indptr: torch.Tensor,
                distinct: bool = False) -> int:
    """The bytes of the CSR that ``draw_neighbors`` reads for ``frontier``
    in whole 32-byte sectors: one sector for each entry's ``indptr`` pair,
    and each entry's run ``indices[indptr[f], indptr[f + 1])`` in the
    sectors it spans (none at degree 0), ``indices`` starting on a sector
    as an allocation does. With ``distinct`` each distinct node counts
    once. At a degree near the fan-out the draws touch about every sector
    of a run, so this is the yardstick the kernel can reach, where the
    byte bound counts 4 bytes a draw."""
    f = frontier.long()
    if distinct:
        f = torch.unique(f)
    start, end = indptr[f].long(), indptr[f + 1].long()
    spans = torch.where(end > start, (4 * end + 31) // 32 - 4 * start // 32,
                        0)
    return 32 * (f.numel() + int(spans.sum()))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_kernel("device_sample")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s card as a raw pointer: what
    ``torch.cuda.current_stream(...).cuda_stream`` gives, without building
    a Stream object (~10 us of the host a call)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _on_cuda(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA tensors, got "
                         f"{t.device}")


def _check_csr(indptr: torch.Tensor, indices: torch.Tensor,
               like: torch.Tensor) -> None:
    for name, t in (("indptr", indptr), ("indices", indices)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be 1-D int32, got {t.dim()}-D "
                            f"{t.dtype}")
        if t.device != like.device:
            raise ValueError(f"{name} on {t.device}, ids on {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if indptr.shape[0] < 2:
        raise ValueError("indptr must hold at least one node")


def _check_ids(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 1:
        raise TypeError(f"{name} must be 1-D int32, got {t.dim()}-D "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_synthesize(dst_global, indptr, indices, draws, K, src_cap,
                       out_cap) -> InnermostFields:
    _on_cuda("synthesize_innermost", dst_global)
    D = dst_global.shape[0]
    dev = dst_global.device
    # One allocation a field: on the card's host, one buffer cut into
    # views cost more than the five allocations it saved.
    empty = functools.partial(torch.empty, device=dev)
    out = InnermostFields(
        nbr=empty((K + 1, D), dtype=torch.int32),
        owned_idx=empty(out_cap, dtype=torch.int32),
        owned_deg=empty(out_cap, dtype=torch.float32),
        self_idx=empty(out_cap, dtype=torch.int32),
        owned_mask=empty(out_cap, dtype=torch.bool),
        num_owned=empty((), dtype=torch.int32))
    if D == 0:
        out.num_owned.zero_()
        return out
    lib = _library()
    err = lib.synthesize_innermost(
        dst_global.data_ptr(), D, indptr.data_ptr(), indptr.shape[0] - 1,
        indices.data_ptr(), indices.shape[0], draws.data_ptr(), K, out_cap,
        src_cap - 1, out.nbr.data_ptr(), out.owned_idx.data_ptr(),
        out.owned_deg.data_ptr(), out.self_idx.data_ptr(),
        out.owned_mask.data_ptr(), out.num_owned.data_ptr(), dev.index,
        _stream(dst_global))
    check_launch(lib, err, "synthesize_innermost")
    synthesize_innermost.launches += 1
    return out


def synthesize_innermost(dst_global: torch.Tensor, indptr: torch.Tensor,
                         indices: torch.Tensor, draws: torch.Tensor, K: int,
                         src_cap: int, out_cap: int) -> InnermostFields:
    """Layer 0 of fan-out ``K`` for the dst frame ``dst_global`` (int32
    ``[D]``, global ids, pad -1) from the plain int32 CSR ``(indptr,
    indices)`` of ``parallel/model.make_device_csr``: the self slot, then
    every neighbour in adjacency order where ``deg <= K``, else the
    neighbours at ``draws[k] % deg`` for the int64 ``draws [K, D]`` (in
    ``[0, 2^62)``, as ``torch.randint(0, 2**62)`` gives them). A frame row
    of the replicated cache is the global id, and ``src_cap - 1`` its zero
    row. The frame's valid columns must be a prefix, as the sampling
    service writes them (each dst id at its dense rank, pads after):
    ``num_owned`` is then the first pad's index. Another frame raises
    ``ValueError`` on the CPU and stops the kernel with a device-side
    assert on the card. ``synthesize_innermost.launches`` counts the
    kernel's launches."""
    _check_ids("dst_global", dst_global)
    _check_csr(indptr, indices, dst_global)
    D = dst_global.shape[0]
    if K < 1:
        raise ValueError(f"fan-out {K} must be at least 1")
    if draws.dtype != torch.int64 or tuple(draws.shape) != (K, D):
        raise TypeError(f"draws must be int64 [{K}, {D}], got "
                        f"{draws.dtype} {list(draws.shape)}")
    if draws.device != dst_global.device or not draws.is_contiguous():
        raise ValueError("draws must be contiguous, on the ids' device")
    if not 0 <= out_cap <= D:
        raise ValueError(f"out_cap {out_cap} out of [0, {D}]")
    if D >= 2**31:
        raise ValueError(f"{D} dst columns: past int32")
    if dst_global.device.type == "cpu":
        valid = dst_global >= 0
        if not bool(valid[:int(valid.sum())].all()):
            raise ValueError("dst_global holds a valid column after a pad: "
                             "the synthesis takes frames whose valid "
                             "columns are a prefix")
        return synthesize_innermost_reference(dst_global, indptr, indices,
                                              draws, K, src_cap, out_cap)
    return _launch_synthesize(dst_global, indptr, indices, draws, K,
                              src_cap, out_cap)


synthesize_innermost.launches = 0


def _launch_draw(frontier, indptr, indices, r) -> torch.Tensor:
    _on_cuda("draw_neighbors", frontier)
    n, K = r.shape
    out = torch.empty(n * (1 + K), dtype=torch.int32, device=frontier.device)
    if n == 0:
        return out
    lib = _library()
    err = lib.draw_neighbors(
        frontier.data_ptr(), n, indptr.data_ptr(), indptr.shape[0] - 1,
        indices.data_ptr(), indices.shape[0], r.data_ptr(), K,
        out.data_ptr(), frontier.device.index, _stream(frontier))
    check_launch(lib, err, "draw_neighbors")
    draw_neighbors.launches += 1
    return out


def draw_neighbors(frontier: torch.Tensor, indptr: torch.Tensor,
                   indices: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The next dense frontier of ``frontier`` (int32 ``[n]``): int32 ``[n
    * (1 + K)]``, ``frontier`` itself then, for each node in order, its K
    draws ``indices[indptr[f] + r[s, k] % deg]`` (the node itself at
    degree 0), for int32 ``r [n, K]`` in ``[0, 2^31)`` (``torch.randint(0,
    2**31 - 1)``). At ``K = 0`` it is a copy of ``frontier``, with no
    launch (JAX's ``dense_frontiers`` keeps the frontier).
    ``draw_neighbors.launches`` counts the kernel's launches."""
    _check_ids("frontier", frontier)
    _check_csr(indptr, indices, frontier)
    n = frontier.shape[0]
    if r.dtype != torch.int32 or r.dim() != 2 or r.shape[0] != n:
        raise TypeError(f"r must be int32 [{n}, K], got {r.dtype} "
                        f"{list(r.shape)}")
    if r.device != frontier.device or not r.is_contiguous():
        raise ValueError("r must be contiguous, on the frontier's device")
    if r.shape[1] == 0:
        return frontier.clone()
    if frontier.device.type == "cpu":
        return draw_neighbors_reference(frontier, indptr, indices, r)
    return _launch_draw(frontier, indptr, indices, r)


draw_neighbors.launches = 0


def _launch_gather_mean(features, frontier, n, fanout):
    _on_cuda("gather_mean", features)
    h = features.shape[1]
    x_self = torch.empty((n, h), dtype=torch.float32, device=features.device)
    mean = torch.empty_like(x_self)
    if h == 0:
        return x_self, mean
    lib = _library()
    err = lib.gather_mean(
        features.data_ptr(), int(features.dtype == torch.bfloat16),
        features.shape[0], h, frontier.data_ptr(), n, fanout,
        x_self.data_ptr(), mean.data_ptr(), features.device.index,
        _stream(features))
    check_launch(lib, err, "gather_mean")
    gather_mean.launches += 1
    return x_self, mean


def gather_mean(features: torch.Tensor, frontier: torch.Tensor, n: int,
                fanout: int):
    """``(x_self, mean)``, f32 ``[n, H]`` each, of the deepest frontier
    ``frontier`` (int32 ``[n * (1 + fanout)]``: n self rows, then each
    one's ``fanout`` drawn rows) over the f32 or bf16 table ``features [N,
    H]``: ``x_self = features[frontier[:n]]`` and ``mean = (x_self + sum
    over k, in order, of features[frontier[n + s * fanout + k]]) / (fanout
    + 1)``. Every id must be a row of ``features``, as ``index_select``
    requires; on the card one out of range stops the kernel with a
    device-side assert. A fan-out of 0 or ``n = 0`` raises ``ValueError``
    on both routes, before any launch: JAX's first layer cannot reshape
    such a block of neighbours either, nor can the plain version.
    ``gather_mean.launches`` counts the kernel's launches."""
    if features.dtype not in (torch.float32, torch.bfloat16) or (
            features.dim() != 2):
        raise TypeError(f"features must be 2-D float32 or bfloat16, got "
                        f"{features.dim()}-D {features.dtype}")
    if not features.is_contiguous():
        raise ValueError("features must be contiguous")
    _check_ids("frontier", frontier)
    if frontier.device != features.device:
        raise ValueError(f"frontier on {frontier.device}, features on "
                         f"{features.device}")
    if fanout < 0 or n < 0 or frontier.shape[0] != n * (1 + fanout):
        raise ValueError(f"frontier of {frontier.shape[0]} ids is not n = "
                         f"{n} self rows and {fanout} draws each")
    if fanout == 0 or n == 0:
        raise ValueError(f"gather_mean needs a fan-out and a count of rows "
                         f"of at least 1, got fan-out {fanout}, n = {n}: "
                         f"the first layer's mean has no block of "
                         f"neighbours to reshape")
    if features.device.type == "cpu":
        return gather_mean_reference(features, frontier, n, fanout)
    return _launch_gather_mean(features, frontier, n, fanout)


gather_mean.launches = 0
