"""ctypes binding of the C++ sampling and slicing service.

``NativeSplitSampler`` is a drop-in for the numpy ``SplitSampler``: the
same constructor surface and the same ``SplitBatch``, but sampling and
slicing run in C++ worker threads (``csrc/occ_sampler.cpp``, a copy of
the JAX package's service) that pipeline ahead of the training loop. The
library is built with ``g++`` at first use (``ops.build``).

Scatter plans. With ``scatter_plans=True`` (split GAT's training) the
service also writes, beside every dense matrix past layer 0, its
transpose: the ``ScatterPlan`` of ``ops/dense_gather_sum.py`` that the
per-slot scatter of split GAT's backward reads, as four fields after
``nbr`` (``SplitLayer.plan_offsets``, ``plan_slots``, ``plan_long``,
``plan_num_long``). The JAX package's service has no such output; every
other field stays as JAX's.

Packed transfer: the service writes every field of a sample into ONE
int32 host arena, which crosses to the device in one non-blocking copy
from pinned memory; the fields are then typed views of the device arena
(``i32`` as is, ``f32`` by ``.view(torch.float32)``, the ``u8`` mask words
by ``.view(torch.uint8)``), and labels are looked up on the device from a
resident label table.

Pinned buffers. A non-blocking copy may still be reading its pinned
source when Python moves on, so a pooled arena or cache-tail buffer goes
back to its pool only with a CUDA event recorded after its copy, and is
reused only once that event has completed. A batch parked in the reorder
buffer keeps its own tail buffer until it is delivered. On the CPU the
"device" arena is the host arena itself and is never pooled.

Several processes. With ``emit_range=(lo, hi)`` the service builds only
partitions ``[lo, hi)``'s rows of every ``[P, ...]`` field (the sampling,
routing and overflow checks still run over all P partitions, so every
process draws the same batch and reaches the same verdict); the arena,
the unpack and the tail buffers are sized by the emitted rows. The refresh
list stays all-P: cache-tail bookkeeping is global.

Unpacked transfer (``packed=False``, JAX ``sampling/native.py:392-433``
and ``:634-712``): the service writes each field into its own pinned host
buffer, in the same order as the arena's fields, and each crosses to the
device in its own non-blocking copy; every buffer goes back to its own
pool under the same event rule. The refresh list stays on the host. Both
feeds deliver equal batches, and both apply cache tails at delivery.

Spans. The consumer's side of each batch is marked for a profiler
(``utils/timers.span``), each span closed before the batch is yielded:
``occ.feed.submit`` (a batch's slice of the epoch's order, handed to the
workers), ``occ.feed.wait`` (``occ_wait``: until a worker has finished a
sample), ``occ.feed.copy`` (``occ_next``'s copy of it into the pinned
buffers), ``occ.feed.upload`` (the copies to the device and the batch's
views) and ``occ.feed.cache`` (the cache tail's apply).
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from occ_gnn_tpu_torch.data.graph import Graph
from occ_gnn_tpu_torch.ops.build import load_sampler
from occ_gnn_tpu_torch.ops.dense_gather_sum import SPAN, long_capacity
from occ_gnn_tpu_torch.parallel.split import SplitBatch, SplitLayer
from occ_gnn_tpu_torch.sampling.slicer import (
    default_deg_caps,
    plan_split_capacities,
)
from occ_gnn_tpu_torch.utils.timers import span

_lib = None


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = load_sampler()
    lib.occ_create.restype = ctypes.c_void_p
    lib.occ_create.argtypes = [
        ctypes.c_int64,  # num_nodes
        ctypes.c_void_p,  # indptr
        ctypes.c_void_p,  # indices
        ctypes.c_void_p,  # wmap
        ctypes.c_int32,  # P
        ctypes.c_int32,  # L
        ctypes.c_void_p,  # fanouts
        ctypes.c_void_p,  # frame_caps
        ctypes.c_void_p,  # edge_caps
        ctypes.c_void_p,  # dst_caps
        ctypes.c_void_p,  # out_caps
        ctypes.c_void_p,  # shuffle_caps
        ctypes.c_void_p,  # deg_caps
        ctypes.c_void_p,  # owner_local (int32[N], static snapshot)
        ctypes.c_void_p,  # foreign_off (int64[P+1])
        ctypes.c_void_p,  # foreign_nodes (int64, flat sorted)
        ctypes.c_void_p,  # foreign_local (int32, flat)
        ctypes.c_int64,  # tail_start
        ctypes.c_int64,  # refresh_cap
        ctypes.c_int32,  # num_workers
        ctypes.c_int32,  # queue_depth
        ctypes.c_uint64,  # seed
        ctypes.c_int32,  # sample_replace
        ctypes.c_int32,  # emit_lo
        ctypes.c_int32,  # emit_hi
        ctypes.c_int32,  # emit_coo
        ctypes.c_int32,  # emit_input
        ctypes.c_void_p,  # features (f32 table; NULL = no tail gather)
        ctypes.c_int64,  # feat_stride (elements)
        ctypes.c_int32,  # feat_cols (true feature dim)
        ctypes.c_int32,  # feat_bf16
        ctypes.c_int32,  # replicated (identity cache frames)
        ctypes.c_int32,  # device_innermost (emit dst_global only for l0)
        ctypes.c_int32,  # plan_span (ScatterPlan fields past layer 0; 0: none)
    ]
    lib.occ_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int64]
    lib.occ_wait.restype = ctypes.c_int32
    lib.occ_wait.argtypes = [ctypes.c_void_p]
    lib.occ_next.restype = ctypes.c_int32
    lib.occ_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.occ_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.occ_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class _SlicerError:
    """Error outcome of one sample, carried through the reorder buffer so
    delivery order survives a caught overflow: batches after the failed
    seq still arrive in submission order."""

    def __init__(self, code: int):
        self.code = code

    def raise_(self):
        raise ValueError(
            f"native slicer error: {_ERRORS.get(self.code, self.code)} — "
            f"raise the capacity config"
        )


_ERRORS = {
    1: "owned capacity overflow",
    2: "edge capacity overflow",
    3: "dst frame capacity overflow",
    4: "shuffle capacity overflow",
    5: "routed src missing from cache",
    6: "refresh capacity overflow",
    7: "input frame capacity overflow",
    8: "src frame capacity overflow (one row reserved as the dense zero row)",
    9: "degree capacity overflow",
}


# Host dtype of a field of each kind in the unpacked feed.
_FIELD_DTYPES = {"i32": torch.int32, "f32": torch.float32,
                 "u8": torch.uint8}


class _BufferPool:
    """Host buffers of one shape for copies to ``device``: pinned when the
    device is CUDA, and reused only after the copies made from them have
    completed (a CUDA event recorded on the current stream at ``put``).

    A buffer starts zeroed: the service fills a tail buffer only up to
    each partition's fill, and the rows after it reach the frame as they
    are. No batch reads them, but a layer that projects the whole frame
    (split GAT's COO layer 0) takes their gradient term ``0 * row``,
    which is NaN when the row is. Zeros, and later only rows of feature
    values, keep every frame row finite."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.shape, self.dtype = tuple(shape), dtype
        self.cuda = self.pinned = device.type == "cuda"
        self._free: list[torch.Tensor] = []
        self._in_flight: collections.deque = collections.deque()

    def get(self) -> torch.Tensor:
        # Events on one stream complete in order: reclaim from the front.
        while self._in_flight and self._in_flight[0][1].query():
            self._free.append(self._in_flight.popleft()[0])
        if self._free:
            return self._free.pop()
        return torch.zeros(self.shape, dtype=self.dtype,
                           pin_memory=self.pinned)

    def put(self, buf: torch.Tensor) -> None:
        """Give ``buf`` back once every copy already enqueued from it on
        the current stream has completed."""
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
            self._in_flight.append((buf, event))
        else:
            self._free.append(buf)


class NativeSplitSampler:
    """Pipelined C++ sampler+slicer with the SplitSampler interface;
    batches are delivered as tensors on ``device``."""

    def __init__(
        self,
        graph: Graph,
        train_nodes: np.ndarray,
        partition_map: np.ndarray,
        num_partitions: int,
        fanouts: list[int],
        batch_size: int,
        capacities: dict | None = None,
        seed: int = 0,
        drop_last: bool = False,
        cache=None,
        num_workers: int = 2,
        queue_depth: int = 4,
        replace: bool = True,
        emit_coo: bool | None = None,
        emit_input: bool | None = None,
        innermost: str = "host",
        emit_range: tuple[int, int] | None = None,
        packed: bool = True,
        scatter_plans: bool = False,
        *,
        device: torch.device | str,
    ):
        """``emit_range=(lo, hi)`` emits only partitions ``[lo, hi)``
        (this process's rows); None emits all P. ``packed=False`` moves
        each field to the device in its own copy instead of one arena.
        ``scatter_plans`` ships each dense layer past layer 0 with its
        ``ScatterPlan`` (split GAT's training asks for it). Iteration
        keeps a batch a worker in flight after each delivery (at least
        2, at most ``queue_depth``), so that every worker samples while
        the caller trains."""
        self.graph = graph
        self.device = torch.device(device)
        self.train_nodes = np.asarray(train_nodes, dtype=np.int64)
        self.P = num_partitions
        self.emit_lo, self.emit_hi = (
            emit_range if emit_range is not None else (0, num_partitions))
        if not 0 <= self.emit_lo < self.emit_hi <= num_partitions:
            raise ValueError(f"bad emit_range {emit_range} for "
                             f"{num_partitions} partitions")
        self.P_emit = self.emit_hi - self.emit_lo
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.scatter_plans = scatter_plans
        self.caps = capacities or plan_split_capacities(
            batch_size, self.fanouts, graph.num_nodes, num_partitions,
            num_edges=graph.num_edges,
        )
        self.drop_last = drop_last
        self._ahead = max(2, min(num_workers, queue_depth))
        self.rng = np.random.default_rng(seed)
        self.cache = cache
        plan = getattr(cache, "plan", cache)
        self.cache_plan = plan
        self.replicated = bool(plan is not None
                               and getattr(plan, "replicated", False))
        # Device-innermost sampling (SplitLayer.dst_global): the deepest
        # fanout expansion moves onto the device
        # (parallel.split.synthesize_device_innermost). Needs identity
        # frames (replicated cache), with-replacement draws and a bounded
        # innermost fanout.
        if innermost not in ("host", "device"):
            raise ValueError(f"innermost must be host|device, got {innermost}")
        self.device_innermost = innermost == "device"
        if self.device_innermost:
            if not self.replicated:
                raise ValueError(
                    "innermost='device' needs a fully replicated cache "
                    "(cache_percentage == 1.0 — use --cache-per auto; "
                    "frame row == global id is what lets the device "
                    "gather straight from the frame)"
                )
            if not replace:
                raise ValueError(
                    "innermost='device' implements the reference's "
                    "with-replacement draws; use replace=True"
                )
            if self.fanouts[-1] <= 0:
                raise ValueError(
                    "innermost='device' needs a bounded innermost fanout"
                )
            # Under replication every dst row is owned, so the owned cap
            # (which chains to layer 1's input frame) binds: shrink the
            # dst cap, hence dst_global and the synthesis, to it.
            self.caps = dict(self.caps)
            self.caps["dst_caps"] = list(self.caps["dst_caps"])
            self.caps["dst_caps"][0] = self.caps["out_caps"][0]

        lib = load_library()
        # Keep every array passed by pointer alive on self.
        self._indptr = np.ascontiguousarray(graph.indptr, dtype=np.int64)
        self._indices = np.ascontiguousarray(graph.indices, dtype=np.int64)
        self._wmap = np.ascontiguousarray(partition_map, dtype=np.int32)
        self._fanouts = np.asarray(self.fanouts, dtype=np.int32)
        self._frame_caps = np.asarray(self.caps["frame_caps"], dtype=np.int64)
        self._edge_caps = np.asarray(self.caps["edge_caps"], dtype=np.int64)
        self._dst_caps = np.asarray(self.caps["dst_caps"], dtype=np.int64)
        self._out_caps = np.asarray(self.caps["out_caps"], dtype=np.int64)
        self._shuffle_caps = np.asarray(
            self.caps["shuffle_caps"], dtype=np.int64
        )
        # Derived, not tunable: always fanout + 1 (slicer.default_deg_caps).
        self._deg_caps = np.asarray(
            default_deg_caps(self.fanouts), dtype=np.int64
        )
        self.caps["deg_caps"] = [int(x) for x in self._deg_caps]
        # By default the COO is emitted only for layers without the dense
        # nbr matrix, and input_nodes only when no cache supplies the
        # input frame. emit_coo=True forces the full emission.
        self.emit_coo = bool(emit_coo) if emit_coo is not None else False
        self._coo_l = [
            self.emit_coo or int(self._deg_caps[l]) <= 0
            for l in range(len(self.fanouts))
        ]
        self.emit_input = (
            bool(emit_input) if emit_input is not None else plan is None
        )
        # Worker-side tail gather: with a refreshing cache that takes
        # pre-gathered tails and an f32 table, the C++ workers gather and
        # cast the refresh rows' features into a per-sample buffer (else
        # the cache gathers them on the host, apply_tail).
        self.gather_tail = (
            plan is not None
            and getattr(plan, "needs_refresh", False)
            and cache is not None
            and hasattr(cache, "apply_tail_gathered")
            and isinstance(graph.features, np.ndarray)
            and graph.features.dtype == np.float32
        )
        self._feat_bf16 = 0
        feats_p = None
        feat_stride = feat_cols = 0
        self._tail_pool = None
        if self.gather_tail:
            f = graph.features
            if f.strides[1] != 4:
                raise ValueError("features must be row-contiguous f32")
            tail_dtype = getattr(cache, "dtype", torch.float32)
            # The workers write bf16 tails as raw 16-bit words.
            self._feat_bf16 = 1 if tail_dtype == torch.bfloat16 else 0
            feat_cols = int(graph.true_feature_dim or graph.feature_dim)
            feat_stride = f.strides[0] // 4
            feats_p = f.ctypes.data
            self._tail_pool = _BufferPool(
                (self.P_emit, max(plan.refresh_cap, 1), feat_cols),
                tail_dtype, self.device)
        if plan is not None:
            # Static-only compact maps: dynamic tail ids are assigned per
            # sample inside the workers (no shared mutable state).
            self._owner_local = np.ascontiguousarray(
                plan.static_owner_local, dtype=np.int32
            )
            self._foreign_off = np.ascontiguousarray(
                plan.foreign_offsets, dtype=np.int64
            )
            self._foreign_nodes = np.ascontiguousarray(
                plan.foreign_nodes_flat, dtype=np.int64
            )
            self._foreign_local = np.ascontiguousarray(
                plan.foreign_local_flat, dtype=np.int32
            )
            owner_p = self._owner_local.ctypes.data
            foff_p = self._foreign_off.ctypes.data
            fnod_p = (self._foreign_nodes.ctypes.data
                      if self._foreign_nodes.size else None)
            floc_p = (self._foreign_local.ctypes.data
                      if self._foreign_local.size else None)
            tail_start = plan.tail_start
            # 0 when cache >= 1/P (no per-batch refresh).
            refresh_cap = plan.refresh_cap
        else:
            self._owner_local = self._foreign_off = None
            self._foreign_nodes = self._foreign_local = None
            owner_p = foff_p = fnod_p = floc_p = None
            tail_start = refresh_cap = 0
        self.refresh_cap = refresh_cap

        self._handle = lib.occ_create(
            graph.num_nodes,
            self._indptr.ctypes.data,
            self._indices.ctypes.data,
            self._wmap.ctypes.data,
            self.P,
            len(self.fanouts),
            self._fanouts.ctypes.data,
            self._frame_caps.ctypes.data,
            self._edge_caps.ctypes.data,
            self._dst_caps.ctypes.data,
            self._out_caps.ctypes.data,
            self._shuffle_caps.ctypes.data,
            self._deg_caps.ctypes.data,
            owner_p,
            foff_p,
            fnod_p,
            floc_p,
            tail_start,
            refresh_cap,
            num_workers,
            queue_depth,
            seed + 1,
            1 if replace else 0,
            self.emit_lo,
            self.emit_hi,
            1 if self.emit_coo else 0,
            1 if self.emit_input else 0,
            feats_p,
            feat_stride,
            feat_cols,
            self._feat_bf16,
            1 if self.replicated else 0,
            1 if self.device_innermost else 0,
            SPAN if scatter_plans else 0,
        )
        self._lib = lib
        self._closed = False
        self._next_submit_seq = 0
        self._next_deliver_seq = 0
        self._reorder: dict[int, SplitBatch | _SlicerError] = {}
        self._build_layout()
        self.packed = packed
        if packed:
            self._arena_pool = _BufferPool((self._arena_words,), torch.int32,
                                           self.device)
        else:
            # One pool a field but the refresh list, which stays on the
            # host; the mask is one byte an entry.
            self._field_pools = {
                key: _BufferPool(shape, _FIELD_DTYPES[kind], self.device)
                for key, (_, shape, kind) in self._layout.items()
                if key != ("refresh", None)}
        self._labels_dev = torch.from_numpy(
            graph.labels.astype(np.int32)).to(self.device)

    # -- epoch iteration ---------------------------------------------------

    def __len__(self):
        n = self.train_nodes.shape[0]
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        order = self.rng.permutation(self.train_nodes.shape[0])
        nodes = self.train_nodes[order]
        pending = 0
        submitted = 0
        total = len(self)
        bs = self.batch_size
        for b in range(total):
            with span("occ.feed.submit"):
                self._submit(np.ascontiguousarray(nodes[b * bs:(b + 1) * bs]))
            pending += 1
            submitted += 1
            # keep the pipeline primed but bounded: `_ahead` batches in
            # flight after each delivery
            if pending > self._ahead or submitted == total:
                while pending > (0 if submitted == total else self._ahead):
                    yield self._pop()
                    pending -= 1
        while pending > 0:
            yield self._pop()
            pending -= 1

    def sample_batch(self, batch: np.ndarray) -> SplitBatch:
        batch = np.ascontiguousarray(batch, dtype=np.int64)
        self._submit(batch)
        return self._pop()

    def _submit(self, batch: np.ndarray):
        if self._closed:
            raise RuntimeError("the native sampler is closed")
        self._lib.occ_submit(self._handle, batch.ctypes.data,
                             batch.shape[0], self._next_submit_seq)
        self._next_submit_seq += 1

    # -- internals ---------------------------------------------------------

    def _pop(self) -> SplitBatch:
        """Deliver samples in SUBMISSION order: out-of-order completions
        are parked until their turn."""
        want = self._next_deliver_seq
        self._next_deliver_seq += 1
        pop = self._pop_packed if self.packed else self._pop_unpacked
        while want not in self._reorder:
            seq, batch = pop()
            self._reorder[seq] = batch
        batch = self._reorder.pop(want)
        if isinstance(batch, _SlicerError):
            # Raise IN TURN: later seqs stay parked and are delivered in
            # order if the caller recovers.
            batch.raise_()
        refresh = batch.__dict__.pop("_refresh_nodes")
        with span("occ.feed.cache"):
            if self.gather_tail:
                # The workers already gathered and cast the tail rows; the
                # consumer only copies the buffer (bucketed) to the device.
                buf = batch.__dict__.pop("_tail_feats")
                self.cache.apply_tail_gathered(buf,
                                               (refresh >= 0).sum(axis=1))
                self._tail_pool.put(buf)
            elif self.cache is not None and hasattr(self.cache, "apply_tail"):
                self.cache.apply_tail(refresh)
        return batch

    def _wait(self) -> None:
        """Block until the service has a finished sample queued (the span
        ``occ.feed.wait``: the workers' lateness), so that ``occ_next``
        then only copies it."""
        with span("occ.feed.wait"):
            closed = self._lib.occ_wait(self._handle)
        if closed:
            raise RuntimeError("the native sampler was closed while a "
                               "batch was awaited")

    def _build_layout(self):
        P, L = self.P, len(self.fanouts)
        PE = self.P_emit  # emitted partition rows
        caps = self.caps
        layout = []
        off = 0

        def add(name, l, shape, kind):
            nonlocal off
            n = int(np.prod(shape))
            words = n if kind != "u8" else -(-n // 4)
            layout.append((name, l, off, tuple(shape), kind))
            off += words

        deg_caps = caps["deg_caps"]
        for l in range(L):
            if l == 0 and self.device_innermost:
                # One field: the dst frame's global ids — the device
                # synthesizes everything else from the resident CSR.
                add("dst_global", 0, (PE, caps["dst_caps"][0]), "i32")
                continue
            E = caps["edge_caps"][l]
            S = caps["shuffle_caps"][l]
            O = caps["out_caps"][l]
            if self._coo_l[l]:
                add("edge_src", l, (PE, E), "i32")
                add("edge_dst", l, (PE, E), "i32")
            add("push", l, (PE, P, S), "i32")
            add("recv", l, (PE, P, S), "i32")
            add("owned_idx", l, (PE, O), "i32")
            add("owned_deg", l, (PE, O), "f32")
            add("self_idx", l, (PE, O), "i32")
            add("owned_mask", l, (PE, O), "u8")
            add("num_owned", l, (PE,), "i32")
            if deg_caps[l] > 0:
                add("nbr", l, (PE, deg_caps[l], caps["dst_caps"][l]), "i32")
            if self.scatter_plans and l > 0 and deg_caps[l] > 0:
                slots = deg_caps[l] * caps["dst_caps"][l]
                add("plan_offsets", l, (PE, caps["frame_caps"][l]), "i32")
                add("plan_slots", l, (PE, slots), "i32")
                add("plan_long", l, (PE, long_capacity(slots)), "i32")
                add("plan_num_long", l, (PE,), "i32")
        if self.emit_input:
            add("input_nodes", None, (PE, caps["frame_caps"][0]), "i32")
        add("targets", None, (PE, caps["out_caps"][-1]), "i32")
        add("refresh", None, (P, max(self.refresh_cap, 1)), "i32")
        self._layout = {(name, l): (o, shape, kind)
                        for name, l, o, shape, kind in layout}
        self._field_offsets = [o for _, _, o, _, _ in layout]
        self._arena_words = off

    def _host_field(self, arena: np.ndarray, name: str) -> np.ndarray:
        off, shape, _ = self._layout[(name, None)]
        return arena[off : off + int(np.prod(shape))].reshape(shape).copy()

    def _arena_field(self, arena: torch.Tensor, name: str, l):
        """Field ``(name, l)`` as a typed view of the device arena (the
        mask bytes as bool), None when the layout has no such field."""
        if (name, l) not in self._layout:
            return None
        off, shape, kind = self._layout[(name, l)]
        count = int(np.prod(shape))
        if kind == "i32":
            return arena[off : off + count].view(shape)
        if kind == "f32":
            return arena[off : off + count].view(torch.float32).view(shape)
        words = -(-count // 4)
        by = arena[off : off + words].view(torch.uint8)[:count]
        return (by != 0).view(shape)

    def _unpack(self, field) -> SplitBatch:
        """The batch from ``field(name, l)``, each field's typed device
        tensor (None when not emitted); the labels are looked up from the
        resident label table."""
        caps = self.caps
        L = len(self.fanouts)
        src_cap0 = (self.cache_plan.frame_cap
                    if self.cache_plan is not None
                    else caps["frame_caps"][0])
        layers = []
        for l in range(L):
            if l == 0 and self.device_innermost:
                layers.append(SplitLayer(
                    dst_global=field("dst_global", 0),
                    src_cap=src_cap0,
                    dst_cap=caps["dst_caps"][0],
                    out_cap=caps["out_caps"][0],
                    fanout=self.fanouts[-1],
                ))
                continue
            layers.append(SplitLayer(
                edge_src=field("edge_src", l),
                edge_dst=field("edge_dst", l),
                push_idx=field("push", l),
                recv_idx=field("recv", l),
                owned_idx=field("owned_idx", l),
                owned_deg=field("owned_deg", l),
                self_idx=field("self_idx", l),
                owned_mask=field("owned_mask", l),
                num_owned=field("num_owned", l),
                nbr_idx=field("nbr", l),
                plan_offsets=field("plan_offsets", l),
                plan_slots=field("plan_slots", l),
                plan_long=field("plan_long", l),
                plan_num_long=field("plan_num_long", l),
                src_cap=(src_cap0 if l == 0 else caps["frame_caps"][l]),
                dst_cap=caps["dst_caps"][l],
                out_cap=caps["out_caps"][l],
                fanout=self.fanouts[L - 1 - l],
            ))
        targets = field("targets", None)
        labels = torch.where(
            targets >= 0,
            self._labels_dev.index_select(
                0, targets.clamp(min=0).reshape(-1)).view(targets.shape),
            -1,
        )
        return SplitBatch(
            layers=layers,
            input_nodes=field("input_nodes", None),
            labels=labels,
            target_nodes=targets,
        )

    def _pop_packed(self):
        """One sample into a pinned arena (the span ``occ.feed.copy``),
        then one non-blocking copy of it and its typed views (the span
        ``occ.feed.upload``)."""
        self._wait()
        with span("occ.feed.copy"):
            arena = self._arena_pool.get()
            base = arena.data_ptr()
            ptrs = [base + off * 4 for off in self._field_offsets]
            tail_buf = None
            if self.gather_tail:
                tail_buf = self._tail_pool.get()
                ptrs.append(tail_buf.data_ptr())
            arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
            seq = ctypes.c_int64(-1)
            err = self._lib.occ_next(self._handle, arr, ctypes.byref(seq))
            if err != 0:
                self._arena_pool.put(arena)
                if tail_buf is not None:
                    self._tail_pool.put(tail_buf)
                return seq.value, _SlicerError(err)
            host = arena.numpy()
            # Host copies read later: the refresh list (the cache tail) and
            # the input ids (the host feature gather).
            refresh = self._host_field(host, "refresh")
            input_host = (self._host_field(host, "input_nodes")
                          if self.emit_input else None)
        with span("occ.feed.upload"):
            dev = arena.to(self.device, non_blocking=True)
            batch = self._unpack(
                lambda name, l: self._arena_field(dev, name, l))
            if self._arena_pool.cuda:
                self._arena_pool.put(arena)
        batch.input_nodes_host = input_host
        batch._refresh_nodes = refresh
        if tail_buf is not None:
            batch._tail_feats = tail_buf
        return seq.value, batch

    def _pop_unpacked(self):
        """One sample into a pinned buffer a field (the pointers in the
        layout's order, which is JAX's), one non-blocking copy a field;
        the spans as ``_pop_packed``'s."""
        self._wait()
        with span("occ.feed.copy"):
            bufs = {key: pool.get()
                    for key, pool in self._field_pools.items()}
            refresh = np.empty(self._layout[("refresh", None)][1], np.int32)
            ptrs = [refresh.ctypes.data if key == ("refresh", None)
                    else bufs[key].data_ptr() for key in self._layout]
            tail_buf = None
            if self.gather_tail:
                tail_buf = self._tail_pool.get()
                ptrs.append(tail_buf.data_ptr())
            arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
            seq = ctypes.c_int64(-1)
            err = self._lib.occ_next(self._handle, arr, ctypes.byref(seq))
            if err != 0:
                for key, buf in bufs.items():
                    self._field_pools[key].put(buf)
                if tail_buf is not None:
                    self._tail_pool.put(tail_buf)
                return seq.value, _SlicerError(err)
            input_host = (bufs[("input_nodes", None)].numpy().copy()
                          if self.emit_input else None)
        with span("occ.feed.upload"):
            dev = {key: buf.to(self.device, non_blocking=True)
                   for key, buf in bufs.items()}
            for key, buf in bufs.items():
                if self._field_pools[key].cuda:
                    self._field_pools[key].put(buf)

            def field(name, l):
                t = dev.get((name, l))
                if t is None or t.dtype != torch.uint8:
                    return t
                return t != 0

            batch = self._unpack(field)
        batch.input_nodes_host = input_host
        batch._refresh_nodes = refresh
        if tail_buf is not None:
            batch._tail_feats = tail_buf
        return seq.value, batch

    def stats(self) -> dict:
        """Accumulated worker phase timers."""
        buf = np.zeros(4, dtype=np.float64)
        self._lib.occ_stats(self._handle, buf.ctypes.data)
        n = max(buf[3], 1.0)
        return {
            "sample_s_total": float(buf[0]),
            "slice_s_total": float(buf[1]),
            "tail_gather_s_total": float(buf[2]),
            "samples": int(buf[3]),
            "sample_s_per_batch": float(buf[0] / n),
            "slice_s_per_batch": float(buf[1] / n),
            "tail_gather_s_per_batch": float(buf[2] / n),
        }

    def close(self):
        if not self._closed and self._handle:
            self._lib.occ_destroy(self._handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
