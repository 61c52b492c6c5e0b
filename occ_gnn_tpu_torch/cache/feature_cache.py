"""Device feature caches: per partition (split-parallel path) and the
single-chip static cache of ``--mode pa-cache`` (``SingleChipCache``).

The JAX package's ``cache/feature_cache.py``: ``CachePlan`` is its numpy,
unchanged, so both packages cache the same nodes at the same frame rows;
``SplitFeatureCache`` holds the frames as one device tensor: all P
frames, or in a process holding partitions ``[lo, hi)`` only theirs (the
JAX package's ``MultiHostFeatureCache``).

  * Each partition's frame is ``[static_cap + refresh_cap + 1, H]``: a
    *static* region filled once (degree-sorted top-k of the partition when
    cache_pct < 1/P; the whole partition plus the highest-degree foreign
    nodes otherwise; identity frames at cache_pct == 1), a *dynamic tail*
    rebuilt each batch by ``refresh``, and a last row reserved as the
    dense aggregation's zero row.
  * Host-side maps are compact: one ``owner_local[N]`` int32 (frame row on
    the node's owner, -1 if uncached) plus per-partition sorted
    ``foreign_nodes``/``foreign_local`` arrays for the extras.
  * The tail is written in place into the frames (see
    ``SplitFeatureCache._write_tail`` for why that is safe).
"""

from __future__ import annotations

import numpy as np
import torch

from occ_gnn_tpu_torch.data.graph import Graph


class CachePlan:
    """Host-side cache policy + index maps for P partitions."""

    def __init__(
        self,
        graph: Graph,
        partition_map: np.ndarray,
        num_partitions: int,
        cache_percentage: float,
        refresh_cap: int,
    ):
        assert 0.0 < cache_percentage <= 1.0
        self.graph = graph
        self.P = num_partitions
        self.wmap = np.asarray(partition_map, dtype=np.int32)
        self.cache_percentage = cache_percentage
        self.refresh_cap = refresh_cap
        n = graph.num_nodes
        self.static_size = int(cache_percentage * n)
        self.static_nodes: list[np.ndarray] = []
        # Full replication (cache_pct == 1.0, the HBM-auto-sized regime at
        # products scale) uses IDENTITY frames: every partition caches the
        # whole table at frame row == global id. Consequences the slicers
        # exploit: every edge is natural (zero innermost-layer shuffle at
        # any P), row lookups are O(1) identity instead of per-partition
        # foreign-map binary searches, and the device can synthesize the
        # innermost layer itself from a resident CSR (parallel/split.
        # synthesize_device_innermost) because frame row == node id.
        self.replicated = cache_percentage >= 1.0
        if self.replicated:
            self.needs_refresh = False
            self.refresh_cap = 0
            ident = np.arange(n, dtype=np.int64)
            self.static_nodes = [ident] * num_partitions
            self.owner_local = np.arange(n, dtype=np.int32)
            self.foreign_nodes = [np.empty(0, np.int64)] * num_partitions
            self.foreign_local = [np.empty(0, np.int32)] * num_partitions
            self.static_sizes = np.full(num_partitions, n, dtype=np.int64)
            self.tail_start = n
            # +1: reserved dense-aggregation zero row (see below).
            self.frame_cap = n + 1
            self._dynamic = [np.empty(0, np.int64)
                             for _ in range(num_partitions)]
            self.static_owner_local = self.owner_local
            self.foreign_offsets = np.zeros(num_partitions + 1, np.int64)
            self.foreign_nodes_flat = np.empty(0, np.int64)
            self.foreign_local_flat = np.empty(0, np.int32)
            return
        self.needs_refresh = cache_percentage < (1.0 / num_partitions)
        if not self.needs_refresh:
            # cache >= 1/P: every owned node is statically cached, no
            # per-batch refresh — don't waste frame rows or transfer bytes.
            refresh_cap = 0
            self.refresh_cap = 0
        # Compact maps: frame row on the node's OWNER (static region first,
        # dynamic tail rows added by refresh), plus per-partition sorted
        # (global id -> frame row) arrays for foreign high-degree extras.
        self.owner_local = np.full(n, -1, dtype=np.int32)
        self.foreign_nodes: list[np.ndarray] = []
        self.foreign_local: list[np.ndarray] = []
        self.frame_cap = self.static_size + refresh_cap
        out_deg = graph.out_degrees()
        for p in range(num_partitions):
            own = np.nonzero(self.wmap == p)[0]
            if self.needs_refresh:
                order = np.argsort(-out_deg[own], kind="stable")
                cached = own[order[: self.static_size]]
                self.owner_local[cached] = np.arange(
                    cached.shape[0], dtype=np.int32
                )
                fsorted = np.empty(0, dtype=np.int64)
                flocal = np.empty(0, dtype=np.int32)
            else:
                foreign = np.nonzero(self.wmap != p)[0]
                order = np.argsort(-out_deg[foreign], kind="stable")
                extra = max(self.static_size - own.shape[0], 0)
                fsel = foreign[order[:extra]]
                cached = np.concatenate([own, fsel])
                self.owner_local[own] = np.arange(
                    own.shape[0], dtype=np.int32
                )
                frows = own.shape[0] + np.arange(
                    fsel.shape[0], dtype=np.int64
                )
                s = np.argsort(fsel, kind="stable")
                fsorted = fsel[s]
                flocal = frows[s].astype(np.int32)
                # static region is sized for the worst partition
                self.frame_cap = max(
                    self.frame_cap, cached.shape[0] + refresh_cap
                )
            self.static_nodes.append(cached)
            self.foreign_nodes.append(fsorted)
            self.foreign_local.append(flocal)
        self.static_sizes = np.array(
            [c.shape[0] for c in self.static_nodes], dtype=np.int64
        )
        self.tail_start = int(self.static_sizes.max())
        # +1: the LAST frame row is reserved as the dense-aggregation zero
        # row (nbr_idx padding target) — never assigned to any node, zeroed
        # at init, untouched by refresh.
        self.frame_cap = self.tail_start + refresh_cap + 1
        self._dynamic: list[np.ndarray] = [
            np.empty(0, dtype=np.int64) for _ in range(num_partitions)
        ]
        # Static-only snapshot + flat foreign arrays for the C++ service:
        # workers read these immutable maps and assign dynamic-tail ids per
        # sample, so no shared cache state is ever mutated concurrently.
        self.static_owner_local = self.owner_local.copy()
        sizes = [f.shape[0] for f in self.foreign_nodes]
        self.foreign_offsets = np.zeros(num_partitions + 1, dtype=np.int64)
        np.cumsum(sizes, out=self.foreign_offsets[1:])
        self.foreign_nodes_flat = (
            np.concatenate(self.foreign_nodes)
            if self.foreign_offsets[-1] else np.empty(0, np.int64)
        )
        self.foreign_local_flat = (
            np.concatenate(self.foreign_local)
            if self.foreign_offsets[-1] else np.empty(0, np.int32)
        )

    # -- compact-map queries (elementwise over (node, partition) pairs) ----

    def _foreign_rows(self, nodes: np.ndarray, p: int) -> np.ndarray:
        """Frame rows of ``nodes`` among partition p's foreign extras
        (-1 where absent)."""
        fn = self.foreign_nodes[p]
        out = np.full(nodes.shape, -1, dtype=np.int64)
        if fn.size:
            idx = np.minimum(np.searchsorted(fn, nodes), fn.size - 1)
            hit = fn[idx] == nodes
            out[hit] = self.foreign_local[p][idx[hit]]
        return out

    def cached_on(self, nodes: np.ndarray, parts) -> np.ndarray:
        """Elementwise: is node cached on partition (static region or the
        current dynamic tail)? Replaces the dense node_mask[N, P]."""
        nodes = np.asarray(nodes, dtype=np.int64)
        if self.replicated:
            return np.ones(nodes.shape, dtype=bool)
        parts = np.broadcast_to(np.asarray(parts), nodes.shape)
        res = (self.wmap[nodes] == parts) & (self.owner_local[nodes] >= 0)
        for p in range(self.P):
            if self.foreign_nodes[p].size:
                m = parts == p
                if m.any():
                    res[m] |= self._foreign_rows(nodes[m], p) >= 0
        return res

    def local_rows(self, nodes: np.ndarray, parts) -> np.ndarray:
        """Elementwise frame row of node on partition (-1 if uncached).
        Replaces the dense global_to_local[N, P]."""
        nodes = np.asarray(nodes, dtype=np.int64)
        if self.replicated:
            return nodes.copy()
        parts = np.broadcast_to(np.asarray(parts), nodes.shape)
        out = np.where(
            self.wmap[nodes] == parts,
            self.owner_local[nodes].astype(np.int64),
            -1,
        )
        for p in range(self.P):
            if self.foreign_nodes[p].size:
                m = (parts == p) & (out < 0)
                if m.any():
                    fr = self._foreign_rows(nodes[m], p)
                    out[m] = np.where(fr >= 0, fr, out[m])
        return out

    def dynamic_fill_sizes(self) -> list[int]:
        """Per-partition count of dynamic-tail nodes staged by the most
        recent ``refresh`` (0s before the first refresh). Public accessor
        for capacity measurement — callers must not touch ``_dynamic``."""
        return [int(d.shape[0]) for d in self._dynamic]

    def static_features(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        """[hi-lo, frame_cap, H] initial frames (tail zeroed) for
        partitions [lo, hi) — multi-host callers build only their local
        rows; the default is all P."""
        hi = self.P if hi is None else hi
        H = self.graph.feature_dim
        out = np.zeros((hi - lo, self.frame_cap, H), dtype=np.float32)
        for i, p in enumerate(range(lo, hi)):
            rows = self.static_nodes[p]
            out[i, : rows.shape[0]] = self.graph.features[rows]
        return out

    def refresh(self, last_layer_nodes: np.ndarray,
                collect: bool = True) -> np.ndarray | None:
        """Evict the previous batch's dynamic fill and stage features of the
        batch's missing owned nodes. Returns the new tail [P, R_cap, H] to
        write at frames[:, tail_start:, :], or None when no refresh needed
        (cache >= 1/P — reference memory_manager.py:76-78).

        ``collect=False`` updates only the bookkeeping (owner_local /
        _dynamic) without materializing the tail array — used by the fast
        capacity prober, where allocating a worst-case [P, R_cap, H]
        zeros per batch dominated measurement time."""
        if not self.needs_refresh:
            return None
        for p in range(self.P):
            prev = self._dynamic[p]
            if prev.size:
                self.owner_local[prev] = -1
            self._dynamic[p] = np.empty(0, dtype=np.int64)
        nodes = np.asarray(last_layer_nodes, dtype=np.int64)
        H = self.graph.feature_dim
        tail = (np.zeros((self.P, self.refresh_cap, H), dtype=np.float32)
                if collect else None)
        for p in range(self.P):
            own = nodes[self.wmap[nodes] == p]
            missing = own[self.owner_local[own] == -1]
            if missing.shape[0] > self.refresh_cap:
                raise ValueError(
                    f"refresh overflow: partition {p} misses "
                    f"{missing.shape[0]} nodes, refresh_cap "
                    f"{self.refresh_cap}"
                )
            k = missing.shape[0]
            if k:
                if collect:
                    tail[p, :k] = self.graph.features[missing]
                self.owner_local[missing] = self.tail_start + np.arange(
                    k, dtype=np.int32
                )
                self._dynamic[p] = missing
        return tail


class SplitFeatureCache:
    """Device-side frames ``[hi - lo, frame_cap, H]`` of partitions
    ``[lo, hi)`` (by default all P) for the split path, in the storage
    ``dtype`` (bf16 halves the frames and the tail traffic; the models
    upcast per gather). The frames never require grad.

    A process holding partitions ``[lo, hi)`` passes ``partitions=(lo,
    hi)``: it holds only their frames and writes only their tail rows,
    while ``plan.refresh`` keeps the global bookkeeping, the same in every
    process. A replicated plan gives every partition the identity frame:
    the process holds it once, and ``frames`` is that frame expanded over
    its partitions with no copy (a replicated plan writes no tail, and the
    frames take no gradient)."""

    def __init__(self, plan: CachePlan, dtype: torch.dtype = torch.float32,
                 *, device: torch.device | str,
                 partitions: tuple[int, int] | None = None):
        self.plan = plan
        self.dtype = dtype
        self.device = torch.device(device)
        self.lo, self.hi = partitions if partitions is not None else (
            0, plan.P)
        if not 0 <= self.lo < self.hi <= plan.P:
            raise ValueError(f"bad partition range {partitions} for "
                             f"{plan.P} partitions")
        # Cast on the host, so the one-time upload carries the storage
        # dtype.
        held = self.lo + 1 if plan.replicated else self.hi
        self.frames = torch.from_numpy(
            plan.static_features(self.lo, held)).to(dtype).to(self.device)
        if plan.replicated:
            self.frames = self.frames.expand(self.hi - self.lo, -1, -1)
        # Per-batch tail-transfer accounting.
        self.tail_batches = 0
        self.tail_bytes_total = 0
        self.tail_rows_last = 0

    def _bucket(self, fill: int) -> int:
        """Rows to ship for a tail of ``fill`` rows: the fill rounded up a
        16-step ladder of the refresh cap. Rows past the fill keep stale
        values, which no batch references (its tail ids point below the
        fill)."""
        rc = self.plan.refresh_cap
        q = max(-(-rc // 16), 8)
        return min(max(-(-fill // q) * q, q), rc)

    def _write_tail(self, tail: torch.Tensor) -> None:
        """Write ``tail [hi - lo, bucket, Ht]`` (host, storage dtype) at frame
        rows ``tail_start:`` and columns ``:Ht`` (the columns past the
        true feature width stay zero).

        JAX updates the frames functionally, so steps in flight keep
        their own version. Here the write is in place, and it is safe
        because it is ordered on the same stream as the steps: the copy
        and the write are enqueued on the current stream after every step
        already launched, which read the old tail before the write runs,
        and before every later step, which reads the new one. A pinned
        ``tail`` goes back to its pool only after an event recorded after
        this call (``sampling.native``)."""
        ts = self.plan.tail_start
        bucket, cols = tail.shape[1], tail.shape[2]
        t = tail.to(self.device, non_blocking=True)
        self.frames[:, ts : ts + bucket, :cols].copy_(t)
        self.tail_batches += 1
        self.tail_rows_last = bucket
        self.tail_bytes_total += tail.numel() * tail.element_size()

    def _host_tail(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self.dtype)

    def refresh(self, last_layer_nodes: np.ndarray) -> None:
        """Numpy-sampler path: refresh the plan for this batch and ship
        the filled rows (bucketed) at the true feature width."""
        tail = self.plan.refresh(last_layer_nodes)
        if tail is None:
            return
        g = self.plan.graph
        Ht = g.true_feature_dim or g.feature_dim
        bucket = self._bucket(max(self.plan.dynamic_fill_sizes()))
        self._write_tail(
            self._host_tail(tail[self.lo:self.hi, :bucket, :Ht]))

    def apply_tail(self, refresh_nodes: np.ndarray) -> None:
        """Write the dynamic tail of a sample from the C++ service:
        ``refresh_nodes[p, c]`` (global id, -1 pad; all P partitions)
        gets frame row ``tail_start + c``; the features of this cache's
        partitions are gathered here on the host."""
        plan = self.plan
        if not plan.needs_refresh:
            return
        g = plan.graph
        Ht = g.true_feature_dim or g.feature_dim
        counts = [int((refresh_nodes[p] >= 0).sum()) for p in range(plan.P)]
        bucket = self._bucket(max(counts))
        tail = np.zeros((self.hi - self.lo, bucket, Ht), dtype=np.float32)
        for i, p in enumerate(range(self.lo, self.hi)):
            k = counts[p]
            if k:
                tail[i, :k] = g.features[refresh_nodes[p][:k], :Ht]
        self._write_tail(self._host_tail(tail))

    def apply_tail_gathered(self, tail_buf: torch.Tensor,
                            counts: np.ndarray) -> None:
        """Apply a tail the C++ workers already gathered and cast:
        ``tail_buf[i, c]`` (host, storage dtype, pinned on CUDA) holds the
        features of refresh row c of partition ``lo + i`` for c <
        counts[lo + i]; ``counts`` covers all P partitions."""
        if not self.plan.needs_refresh:
            return
        k = int(max(counts)) if len(counts) else 0
        t = tail_buf[:, : self._bucket(k)]
        if not t.is_contiguous():
            t = t.contiguous()
        self._write_tail(t)


class SingleChipCache:
    """PaGraph-style static cache of the single-chip path (``--mode
    pa-cache``), the JAX package's ``SingleChipCache``: the global top-k
    nodes by out-degree live on ``device`` as one f32 frame; each batch's
    input frame takes the cached rows by a device gather and the missing
    rows from the host, and the cache counts hits and misses.

    JAX ships a dense zero-filled ``[F_cap, H]`` miss buffer every batch,
    as many bytes as having no cache. Here only the miss rows and the
    frame positions travel (``bytes_sent`` counts them), and the frame is
    assembled on the device by copies alone, so it is bit-identical to
    ``training.gather_features`` of the same ids. The frame cap is the
    length of the ids, so the constructor takes none."""

    def __init__(self, graph: Graph, cache_percentage: float, *,
                 device: torch.device | str):
        self.graph = graph
        self.device = torch.device(device)
        n = graph.num_nodes
        self.num_cached = int(cache_percentage * n)
        order = np.argsort(-graph.out_degrees(), kind="stable")
        self.cached_nodes = order[: self.num_cached]
        self.global_to_local = np.full(n, -1, dtype=np.int64)
        self.global_to_local[self.cached_nodes] = np.arange(self.num_cached)
        self.frame = torch.from_numpy(
            np.ascontiguousarray(graph.features[self.cached_nodes],
                                 dtype=np.float32)).to(self.device)
        self.hits = 0
        self.misses = 0
        self.bytes_sent = 0

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def load_input_frame(self, input_nodes) -> torch.Tensor:
        """The f32 input frame ``[F_cap, H]`` of the batch's input ids
        (-1 pads, whose rows are 0 and count as neither hit nor miss):
        cached rows gathered on the device, missing rows copied from the
        host in one pinned copy with their positions."""
        return self.assemble(*self.stage(input_nodes))

    def stage(self, input_nodes):
        """The host half of ``load_input_frame``: count the batch's hits
        and misses and send the device ``(index, miss_rows, num_hits,
        frame_rows)``, where ``index`` holds the hit positions, their
        cache rows and the miss positions."""
        if isinstance(input_nodes, torch.Tensor):
            idx = input_nodes.cpu().numpy()
        else:
            idx = np.asarray(input_nodes)
        valid = idx >= 0
        local = self.global_to_local[np.where(valid, idx, 0)]
        hit = (local >= 0) & valid
        miss = ~hit & valid
        hit_pos = np.nonzero(hit)[0]
        miss_pos = np.nonzero(miss)[0]
        self.hits += int(hit_pos.shape[0])
        self.misses += int(miss_pos.shape[0])
        pin = self.device.type == "cuda"
        # One int64 buffer: hit positions, their frame rows, miss positions.
        nh, nm = hit_pos.shape[0], miss_pos.shape[0]
        index = torch.empty(2 * nh + nm, dtype=torch.int64, pin_memory=pin)
        index_np = index.numpy()
        index_np[:nh] = hit_pos
        index_np[nh : 2 * nh] = local[hit_pos]
        index_np[2 * nh :] = miss_pos
        rows = torch.empty((nm, self.graph.feature_dim), dtype=torch.float32,
                           pin_memory=pin)
        np.take(self.graph.features, idx[miss_pos], axis=0, out=rows.numpy())
        self.bytes_sent += (index.numel() * index.element_size()
                            + rows.numel() * rows.element_size())
        return (index.to(self.device, non_blocking=True),
                rows.to(self.device, non_blocking=True), nh, idx.shape[0])

    def assemble(self, index: torch.Tensor, miss_rows: torch.Tensor,
                 num_hits: int, frame_rows: int) -> torch.Tensor:
        """The device half of ``load_input_frame``: a zero frame, the
        hits copied in from the cache, the misses from ``miss_rows``."""
        nh = num_hits
        out = torch.zeros((frame_rows, self.graph.feature_dim),
                          dtype=torch.float32, device=self.device)
        out.index_copy_(0, index[:nh],
                        self.frame.index_select(0, index[nh : 2 * nh]))
        out.index_copy_(0, index[2 * nh :], miss_rows)
        return out
