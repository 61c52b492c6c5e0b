"""Online minibatch slicing into per-partition split-parallel structures.

The numpy code of the JAX package's ``sampling/slicer.py``, unchanged, so
one seed gives the same batches in both packages field for field; only
the final packing into torch tensors on a device is new. With several
processes, ``emit_range`` keeps only this process's rows of every
``[P, ...]`` field, sliced on the host before the device copy (the JAX
package's ``MultiHostSplitSampler._assemble``).

Every sampled layer's edges are routed to the partition that OWNS THE
SOURCE node (where its features live), each partition aggregates partial
sums locally, and boundary partial sums are shuffled to the destination's
owner (the OCC-GNN reference's ``edge_partitioning`` / ``slice_layer``).

Layout choices:
  * output is fixed-capacity padded arrays (static shapes), not ragged
    CSR;
  * dedup/renumbering uses numpy first-occurrence machinery here and the
    O(1) mask trick in the C++ service (csrc/), instead of DuplicateRemover
    objects per graph;
  * shuffle bookkeeping is emitted as paired (push_idx, recv_idx) index
    tensors whose pairwise order matches, so the device side needs exactly
    one all_to_all per layer — no per-pair tensors.

Frame conventions (must hold for the device code in parallel/split.py):
  * partition p's src frame at depth d = nodes of the global frontier F_d
    owned by p, in F_d order;  F_{d} is a prefix of F_{d+1} (dst-first
    sampling), so an owned dst's own feature always exists in the deeper
    frame (self_idx);
  * partition p's dst scratch frame = [owned dst nodes in F_d order] ++
    [foreign dst nodes touched by p's edges, first-occurrence order] —
    owned rows form the prefix, and their order IS the next-shallower
    layer's src frame order, chaining layers without reindexing.

This numpy implementation is the correctness reference; the C++ service
(``csrc/occ_sampler.cpp``) reproduces it bit-for-bit (tested) at
production speed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from occ_gnn_tpu_torch.data.graph import Graph
from occ_gnn_tpu_torch.ops.blocks import pad_to
from occ_gnn_tpu_torch.ops.dense_gather_sum import slots_plan
from occ_gnn_tpu_torch.parallel.split import SplitBatch, SplitLayer
from occ_gnn_tpu_torch.sampling.neighbor import (
    dedup_first_occurrence,
    plan_capacities,
    sample_layer_edges,
)


def rank_within_owner(owner: np.ndarray, num_partitions: int):
    """rank[i] = position of i among indices with the same owner (stable)."""
    rank = np.zeros(owner.shape[0], dtype=np.int64)
    counts = np.zeros(num_partitions, dtype=np.int64)
    order = np.argsort(owner, kind="stable")
    sorted_owner = owner[order]
    starts = np.searchsorted(sorted_owner, np.arange(num_partitions))
    within = np.arange(owner.shape[0]) - starts[sorted_owner]
    rank[order] = within
    counts = np.bincount(owner, minlength=num_partitions)
    return rank, counts


def plan_split_capacities(
    batch_size: int,
    fanouts: list[int],
    num_nodes: int,
    num_partitions: int,
    skew: float | None = None,
    num_edges: int | None = None,
) -> dict:
    """Uniform per-partition padding budgets.

    ``skew`` is the load-imbalance headroom over a perfect 1/P split;
    skew=None uses the always-safe single-chip capacities (every partition
    padded as if it got the whole batch) — correct but memory-hungry, meant
    for tests. Production uses measured capacities (measure_split_capacities).
    """
    single = plan_capacities(batch_size, fanouts, num_nodes,
                             num_edges=num_edges)
    P = num_partitions
    factor = 1.0 if skew is None else skew / P

    def shrink(x):
        return max(int(np.ceil(x * factor)), 8)

    frame_caps = [shrink(c) for c in single["frame_caps"]]
    edge_caps = [shrink(c) for c in single["edge_caps"]]
    out_caps = frame_caps[1:]
    dst_caps = [min(2 * frame_caps[l + 1], frame_caps[l + 1] + edge_caps[l])
                for l in range(len(fanouts))]
    shuffle_caps = [frame_caps[l + 1] for l in range(len(fanouts))]
    return {
        "frame_caps": frame_caps,
        "edge_caps": edge_caps,
        "dst_caps": dst_caps,
        "out_caps": out_caps,
        "shuffle_caps": shuffle_caps,
        "deg_caps": default_deg_caps(fanouts),
    }


def default_deg_caps(fanouts: list[int]) -> list[int]:
    """Per-layer (innermost-first) dense neighbor-matrix depth: fanout
    sampling bounds per-dst degree by fanout + 1 (self loop included), a
    HARD bound — no margin or measurement needed. -1 disables the dense
    layout for full-neighborhood layers (fanout < 0: unbounded degree)."""
    L = len(fanouts)
    return [(fanouts[L - 1 - l] + 1 if fanouts[L - 1 - l] >= 0 else -1)
            for l in range(L)]


@dataclasses.dataclass
class _RawLayer:
    """Global-id view of one sampled layer (outermost-first)."""

    e_dst: np.ndarray        # local into frontier F_d
    e_src_global: np.ndarray
    frontier: np.ndarray     # F_d
    frame: np.ndarray        # F_{d+1} (dst-first)
    uniq: np.ndarray         # sorted(frame)
    rank: np.ndarray         # uniq order -> frame row


class SplitSampler:
    """Samples a minibatch and slices it into a SplitBatch.

    Iterator protocol mirrors the reference Sampler (sampler.py:29-61).
    """

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
        replace: bool = True,
        emit_range: tuple[int, int] | None = None,
        scatter_plans: bool = False,
        *,
        device: torch.device | str,
    ):
        """``cache`` is an optional SplitFeatureCache (or bare CachePlan):
        when given, the innermost layer is sliced cache-aware — edges whose
        src feature is cached on the destination's owner ("natural" edges,
        reference sampler.py:93-123) execute there with no shuffle, others
        route to the src owner — and edge_src indexes the cache frame.
        Batches are delivered as tensors on ``device``, holding partitions
        ``emit_range = (lo, hi)`` (by default all P). ``scatter_plans``
        ships each dense layer past layer 0 with its ``ScatterPlan``, from
        its plain version (split GAT's training asks for it)."""
        self.graph = graph
        self.device = torch.device(device)
        self.train_nodes = np.asarray(train_nodes, dtype=np.int64)
        self.wmap = np.asarray(partition_map, dtype=np.int64)
        self.P = num_partitions
        self.emit_lo, self.emit_hi = (
            emit_range if emit_range is not None else (0, num_partitions))
        if not 0 <= self.emit_lo < self.emit_hi <= num_partitions:
            raise ValueError(f"bad emit_range {emit_range} for "
                             f"{num_partitions} partitions")
        assert self.wmap.max() < num_partitions, (
            f"partition map has id {self.wmap.max()} >= {num_partitions}"
        )
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.caps = capacities or plan_split_capacities(
            batch_size, self.fanouts, graph.num_nodes, num_partitions,
            num_edges=graph.num_edges,
        )
        self.drop_last = drop_last
        self.replace = replace
        self.cache = cache
        self.cache_plan = getattr(cache, "plan", cache)
        self.scatter_plans = scatter_plans

    def __iter__(self):
        order = self.rng.permutation(self.train_nodes.shape[0])
        nodes = self.train_nodes[order]
        for i in range(0, nodes.shape[0], self.batch_size):
            batch = nodes[i : i + self.batch_size]
            if self.drop_last and batch.shape[0] < self.batch_size:
                break
            yield self.sample_batch(batch)

    def __len__(self):
        n = self.train_nodes.shape[0]
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    # -- sampling (global ids) ---------------------------------------------

    def _sample_raw(self, batch: np.ndarray) -> list[_RawLayer]:
        frontier = np.unique(np.asarray(batch, dtype=np.int64))
        raw = []
        for fanout in self.fanouts:
            e_dst, e_src_global = sample_layer_edges(
                self.graph, frontier, fanout, self.rng,
                replace=self.replace,
            )
            frame, uniq, rank = dedup_first_occurrence(frontier, e_src_global)
            raw.append(
                _RawLayer(e_dst, e_src_global, frontier, frame, uniq, rank)
            )
            frontier = frame
        return raw

    # -- slicing ------------------------------------------------------------

    def sample_batch(self, batch: np.ndarray) -> SplitBatch:
        return self.slice_raw(self._sample_raw(batch))

    def slice_raw(self, raw: list[_RawLayer]) -> SplitBatch:
        P = self.P
        L = len(raw)
        caps = self.caps

        # Refresh the cache for this batch BEFORE slicing (the slicer reads
        # the post-refresh maps — reference order at sampler.py:47-49).
        if self.cache is not None:
            self.cache.refresh(raw[-1].frame)

        layers = []
        for l in range(L):  # innermost-first output order
            rl = raw[L - 1 - l]
            layers.append(self._slice_layer(rl, l, use_cache=(l == 0 and self.cache is not None)))

        # Layer-0 input frame global ids per partition.
        deepest = raw[-1].frame
        owner = self.wmap[deepest]
        f0_cap = caps["frame_caps"][0]
        input_nodes = np.stack(
            [
                pad_to(deepest[owner == p].astype(np.int32), f0_cap, -1)
                for p in range(P)
            ]
        )
        # Labels of target nodes per partition, in owned (frontier) order
        # (reference partition_labels, sampler.py:209-225).
        targets = raw[0].frontier
        towner = self.wmap[targets]
        t_cap = caps["out_caps"][-1]
        labels = np.stack(
            [
                pad_to(
                    self.graph.labels[targets[towner == p]].astype(np.int32),
                    t_cap,
                    -1,
                )
                for p in range(P)
            ]
        )
        target_nodes = np.stack(
            [
                pad_to(targets[towner == p].astype(np.int32), t_cap, -1)
                for p in range(P)
            ]
        )
        return SplitBatch(
            layers=layers,
            input_nodes=self._to_device(input_nodes),
            labels=self._to_device(labels),
            target_nodes=self._to_device(target_nodes),
            input_nodes_host=input_nodes[self.emit_lo:self.emit_hi],
        )

    def _to_device(self, a: np.ndarray | None) -> torch.Tensor | None:
        """The emitted partitions' rows of a ``[P, ...]`` field on the
        device."""
        if a is None:
            return None
        rows = np.ascontiguousarray(a[self.emit_lo:self.emit_hi])
        return torch.from_numpy(rows).to(self.device)

    def _slice_layer(
        self, rl: _RawLayer, l: int, use_cache: bool = False
    ) -> SplitLayer:
        P = self.P
        caps = self.caps
        E_cap = caps["edge_caps"][l]
        D_cap = caps["dst_caps"][l]
        O_cap = caps["out_caps"][l]
        S_cap = caps["shuffle_caps"][l]

        F_d = rl.frontier
        frame = rl.frame
        wmap = self.wmap

        dst_owner = wmap[F_d]                      # owner of each dst node
        frame_owner = wmap[frame]
        frame_rank, _ = rank_within_owner(frame_owner, P)
        dst_rank, dst_counts = rank_within_owner(dst_owner, P)

        src_global = rl.e_src_global
        e_dst_owner = dst_owner[rl.e_dst]
        if use_cache:
            # Cache-aware innermost layer: "natural" edges (src cached on
            # the dst's owner) run on the dst owner shuffle-free; the rest
            # route to the src's owner, where refresh guarantees presence.
            plan = self.cache_plan
            natural = plan.cached_on(src_global, e_dst_owner)
            e_route = np.where(natural, e_dst_owner, wmap[src_global])
            e_src_local = plan.local_rows(src_global, e_route)
            assert (e_src_local >= 0).all(), "routed src missing from cache"
            F_cap = plan.frame_cap
            own_feature_row = lambda nodes_global, p: plan.local_rows(
                nodes_global, p
            )
        else:
            src_frame_pos = rl.rank[np.searchsorted(rl.uniq, src_global)]
            e_route = frame_owner[src_frame_pos]   # partition owning the src
            e_src_local = frame_rank[src_frame_pos]  # row in owner's frame
            F_cap = caps["frame_caps"][l]
            own_feature_row = None

        # Total sampled in-degree per dst (for the exact mean).
        deg = np.bincount(rl.e_dst, minlength=F_d.shape[0]).astype(np.float32)

        # deg_caps are DERIVED (fanout + 1 is a hard bound under fanout
        # sampling), never read from the capacity dict — they are not
        # tunable and must not shrink/grow with capacity re-planning.
        K_cap = default_deg_caps(self.fanouts)[l]

        if not use_cache:
            # One src-frame row per partition is RESERVED as the dense
            # layout's zero row (nbr_idx padding target): frames must never
            # fill completely. (Cache frames reserve their last row in
            # CachePlan.)
            frame_counts = np.bincount(frame_owner, minlength=P)
            if frame_counts.max() > F_cap - 1:
                raise ValueError(
                    f"src frame overflow: layer {l}: partition "
                    f"{int(frame_counts.argmax())} needs "
                    f"{int(frame_counts.max())} rows, usable cap "
                    f"{F_cap - 1} (one row reserved)"
                )

        edge_src = np.zeros((P, E_cap), np.int32)
        edge_dst = np.full((P, E_cap), D_cap, np.int32)
        nbr_idx = (np.full((P, K_cap, D_cap), F_cap - 1, np.int32)
                   if K_cap > 0 else None)
        push_idx = np.full((P, P, S_cap), -1, np.int32)
        recv_idx = np.full((P, P, S_cap), D_cap, np.int32)
        owned_idx = np.full((P, O_cap), -1, np.int32)
        owned_deg = np.ones((P, O_cap), np.float32)
        self_idx = np.zeros((P, O_cap), np.int32)
        owned_mask = np.zeros((P, O_cap), bool)
        num_owned = np.zeros((P,), np.int32)

        for p in range(P):
            sel = np.nonzero(e_route == p)[0]
            n_own = int(dst_counts[p])
            if n_own > O_cap:
                raise ValueError(
                    f"owned capacity overflow: partition {p} owns {n_own} "
                    f"dst nodes, cap {O_cap}"
                )
            # dst frame: owned prefix, then foreign dsts (first occurrence).
            ed = rl.e_dst[sel]
            ed_owner = e_dst_owner[sel]
            foreign_sel = ed_owner != p
            foreign_dst = ed[foreign_sel]
            funiq, ffirst = np.unique(foreign_dst, return_index=True)
            forder = np.argsort(ffirst, kind="stable")
            foreign_frame = funiq[forder]           # F_d rows, frame order
            frank = np.empty(funiq.shape[0], dtype=np.int64)
            frank[forder] = np.arange(funiq.shape[0])
            if n_own + foreign_frame.shape[0] > D_cap:
                raise ValueError(
                    f"dst frame overflow: partition {p}: {n_own} owned + "
                    f"{foreign_frame.shape[0]} foreign > cap {D_cap}"
                )
            # local dst row for each routed edge
            ed_local = dst_rank[ed].copy()
            if funiq.size:
                fpos = np.searchsorted(funiq, ed[foreign_sel])
                ed_local[foreign_sel] = n_own + frank[fpos]
            if sel.shape[0] > E_cap:
                raise ValueError(
                    f"edge capacity overflow: partition {p}: {sel.shape[0]} "
                    f"edges > cap {E_cap}"
                )
            order = np.argsort(ed_local, kind="stable")
            ed_sorted = ed_local[order]
            es_sorted = e_src_local[sel][order]
            edge_src[p, : sel.shape[0]] = es_sorted
            edge_dst[p, : sel.shape[0]] = ed_sorted
            if nbr_idx is not None and ed_sorted.size:
                first = np.searchsorted(ed_sorted, ed_sorted, side="left")
                rank = np.arange(ed_sorted.shape[0]) - first
                if rank.max() >= K_cap:
                    raise ValueError(
                        f"degree capacity overflow: layer {l} partition {p}: "
                        f"local dst degree {int(rank.max()) + 1} > K_cap "
                        f"{K_cap}"
                    )
                nbr_idx[p, rank, ed_sorted] = es_sorted

            # shuffle: p sends its foreign partial rows to their owners.
            fowner = dst_owner[foreign_frame]
            for q in range(P):
                if q == p:
                    continue
                to_q = foreign_frame[fowner == q]   # F_d node rows for q
                if to_q.shape[0] > S_cap:
                    raise ValueError(
                        f"shuffle overflow {p}->{q}: {to_q.shape[0]} > "
                        f"cap {S_cap}"
                    )
                k = to_q.shape[0]
                push_idx[p, q, :k] = (
                    n_own + frank[np.searchsorted(funiq, to_q)]
                )
                # matching receive rows on q: q's owned prefix rank.
                recv_idx[q, p, :k] = dst_rank[to_q]

            own_nodes = np.nonzero(dst_owner == p)[0]  # F_d rows, order
            owned_idx[p, :n_own] = dst_rank[own_nodes]  # == arange(n_own)
            owned_deg[p, :n_own] = deg[own_nodes]
            if use_cache:
                rows = own_feature_row(F_d[own_nodes], p)
                assert (rows >= 0).all(), "owned node missing from cache"
                self_idx[p, :n_own] = rows
            else:
                # own feature row in p's src frame: F_d is a prefix of frame.
                self_idx[p, :n_own] = frame_rank[own_nodes]
            owned_mask[p, :n_own] = True
            num_owned[p] = n_own

        dev = self._to_device
        plan = [None] * 4
        if self.scatter_plans and l > 0 and nbr_idx is not None:
            parts = [slots_plan(torch.from_numpy(nbr_idx[p]), F_cap)
                     for p in range(self.emit_lo, self.emit_hi)]
            plan = [torch.stack(f).to(self.device) for f in zip(*parts)]
        return SplitLayer(
            edge_src=dev(edge_src),
            edge_dst=dev(edge_dst),
            push_idx=dev(push_idx),
            recv_idx=dev(recv_idx),
            owned_idx=dev(owned_idx),
            owned_deg=dev(owned_deg),
            self_idx=dev(self_idx),
            owned_mask=dev(owned_mask),
            num_owned=dev(num_owned),
            nbr_idx=dev(nbr_idx),
            plan_offsets=plan[0],
            plan_slots=plan[1],
            plan_long=plan[2],
            plan_num_long=plan[3],
            src_cap=F_cap,
            dst_cap=D_cap,
            out_cap=O_cap,
        )


def raw_to_single_batch(raw: list[_RawLayer], graph: Graph, caps: dict,
                        device: torch.device | str):
    """Build a single-chip SampledBatch on ``device`` from the same raw
    sampled layers — the split and single paths then share identical
    sampled edges, which is how split==single allclose parity is
    established."""
    from occ_gnn_tpu_torch.ops.blocks import SampledBatch, block_from_numpy

    L = len(raw)
    blocks = []
    for l in range(L):
        rl = raw[L - 1 - l]
        src_frame_pos = rl.rank[np.searchsorted(rl.uniq, rl.e_src_global)]
        blocks.append(
            block_from_numpy(
                src_frame_pos,
                rl.e_dst,
                num_src=rl.frame.shape[0],
                num_dst=rl.frontier.shape[0],
                edge_cap=caps["edge_caps"][l],
                dst_cap=caps["frame_caps"][l + 1],
                src_cap=caps["frame_caps"][l],
                device=device,
            )
        )
    input_nodes = pad_to(
        raw[-1].frame.astype(np.int32), caps["frame_caps"][0], -1
    )
    targets = raw[0].frontier
    labels = pad_to(
        graph.labels[targets].astype(np.int32), caps["frame_caps"][-1], -1
    )
    return SampledBatch(
        blocks=blocks,
        input_nodes=torch.from_numpy(input_nodes).to(device),
        labels=torch.from_numpy(labels).to(device),
    )


def _measure_raw_maxima(sampler: "SplitSampler", raw: list["_RawLayer"]):
    """Per-field maxima of one raw sample WITHOUT materializing the padded
    SplitBatch — replicates _slice_layer's routing, counting only. Used
    by the fast capacity prober: building worst-case padded arrays per
    probe batch cost minutes at products scale for numbers that are pure
    counts."""
    P = sampler.P
    wmap = sampler.wmap
    L = len(raw)
    out = {"edges": [0] * L, "dst": [0] * L, "owned": [0] * L,
           "shuffle": [0] * L}
    for l in range(L):
        rl = raw[L - 1 - l]
        use_cache = l == 0 and sampler.cache is not None
        dst_owner = wmap[rl.frontier]
        dst_counts = np.bincount(dst_owner, minlength=P)
        out["owned"][l] = int(dst_counts.max())
        e_dst_owner = dst_owner[rl.e_dst]
        if use_cache:
            plan = sampler.cache_plan
            natural = plan.cached_on(rl.e_src_global, e_dst_owner)
            e_route = np.where(natural, e_dst_owner,
                               wmap[rl.e_src_global])
        else:
            src_frame_pos = rl.rank[
                np.searchsorted(rl.uniq, rl.e_src_global)
            ]
            e_route = wmap[rl.frame][src_frame_pos]
        out["edges"][l] = int(
            np.bincount(e_route, minlength=P).max()
        )
        # dst frame per p = owned + unique foreign dsts routed to p;
        # shuffle (p -> q) = those uniques grouped by the dst's owner.
        foreign = e_route != e_dst_owner
        if foreign.any():
            F = rl.frontier.shape[0]
            pairs = np.unique(
                e_route[foreign].astype(np.int64) * F
                + rl.e_dst[foreign]
            )
            pp = (pairs // F).astype(np.int64)
            dd = pairs % F
            fcnt = np.bincount(pp, minlength=P)
            out["dst"][l] = int((dst_counts + fcnt).max())
            qq = dst_owner[dd]
            out["shuffle"][l] = int(
                np.bincount(pp * P + qq, minlength=P * P).max()
            )
        else:
            out["dst"][l] = int(dst_counts.max())
            out["shuffle"][l] = 0
    out["frame0"] = int(
        np.bincount(wmap[raw[-1].frame], minlength=P).max()
    )
    return out


def measure_split_capacities(
    graph: Graph,
    train_nodes: np.ndarray,
    partition_map: np.ndarray,
    num_partitions: int,
    fanouts: list[int],
    batch_size: int,
    num_batches: int = 4,
    margin: float = 1.35,
    seed: int = 0,
    cache_plan=None,
    fast: bool = True,
) -> dict:
    """Empirical padding budgets: slice a few batches under the always-safe
    capacities, record the observed per-field maxima, and return them with
    headroom (rounded up to multiples of 128 for edges, 8 elsewhere).

    This is how production configs avoid the worst-case fanout-product
    padding (choosing padding budgets is the 'hard part' called out in
    SURVEY.md §7); overflow at runtime still raises cleanly, and re-running
    with a larger margin is cheap.

    RNG-stream caveat: this probe uses the numpy ``SplitSampler``, whose
    stream differs from the C++ service's per-worker XorShift streams, so
    the production maxima are drawn from different batches than the probe
    maxima.  The ``margin`` exists to absorb exactly that sampling noise:
    per-field maxima concentrate tightly over same-distribution batches
    (they are maxima of sums of ~batch_size*fanout independent draws), so
    the default 1.35x headroom covers the cross-stream gap with a wide
    buffer — ``tests/test_native_sampler.py::
    test_probe_caps_cover_native_stream`` measures the gap directly and
    asserts the native service's observed maxima stay under these budgets.
    If a pathological graph ever defeats the margin, the overflow error is
    typed and the trainer auto-replans at 1.5x (train.py).
    """
    safe = plan_split_capacities(batch_size, fanouts, graph.num_nodes,
                                 num_partitions)
    sampler = SplitSampler(graph, train_nodes, partition_map, num_partitions,
                           fanouts, batch_size, capacities=safe, seed=seed,
                           cache=cache_plan, device="cpu")
    L = len(fanouts)
    max_edges = [0] * L
    max_dst = [0] * L
    max_owned = [0] * L
    max_shuffle = [0] * L
    max_frame0 = 0
    max_refresh = 0
    if fast:
        # Counting-only probe: same RNG stream as the padded path (the
        # permutation and _sample_raw draws are identical; slicing never
        # consumes RNG), same maxima (asserted equal in
        # tests/test_sampler.py), minutes faster at products scale.
        plan = (getattr(cache_plan, "plan", cache_plan)
                if cache_plan is not None else None)
        order = sampler.rng.permutation(sampler.train_nodes.shape[0])
        nodes = sampler.train_nodes[order]
        for b in range(min(num_batches, len(sampler))):
            batch_nodes = nodes[b * batch_size : (b + 1) * batch_size]
            if batch_nodes.shape[0] == 0:
                break
            raw = sampler._sample_raw(batch_nodes)
            if plan is not None:
                plan.refresh(raw[-1].frame, collect=False)
            mx = _measure_raw_maxima(sampler, raw)
            for l in range(L):
                max_edges[l] = max(max_edges[l], mx["edges"][l])
                max_dst[l] = max(max_dst[l], mx["dst"][l])
                max_owned[l] = max(max_owned[l], mx["owned"][l])
                max_shuffle[l] = max(max_shuffle[l], mx["shuffle"][l])
            max_frame0 = max(max_frame0, mx["frame0"])
            if plan is not None:
                sizes = plan.dynamic_fill_sizes()
                max_refresh = max(max_refresh,
                                  max(sizes) if sizes else 0)
        it = iter(())  # consumed
    else:
        it = iter(sampler)
    for _ in range(0 if fast else num_batches):
        try:
            batch = next(it)
        except StopIteration:
            break
        for l, lyr in enumerate(batch.layers):
            ed = np.asarray(lyr.edge_dst)
            valid = ed < lyr.dst_cap
            max_edges[l] = max(max_edges[l], int(valid.sum(axis=1).max()))
            dmax = np.where(valid, ed, -1).max(axis=1) + 1
            max_dst[l] = max(max_dst[l], int(dmax.max()))
            max_owned[l] = max(
                max_owned[l], int(np.asarray(lyr.num_owned).max())
            )
            push = np.asarray(lyr.push_idx)
            max_shuffle[l] = max(
                max_shuffle[l], int((push >= 0).sum(axis=2).max())
            )
        max_frame0 = max(
            max_frame0,
            int((np.asarray(batch.input_nodes) >= 0).sum(axis=1).max()),
        )
        if cache_plan is not None:
            plan = getattr(cache_plan, "plan", cache_plan)
            sizes = plan.dynamic_fill_sizes()
            max_refresh = max(max_refresh, max(sizes) if sizes else 0)

    def up(x, m, q):
        return int(-(-max(int(np.ceil(x * m)), q) // q) * q)

    out_caps = [up(x, margin, 8) for x in max_owned]
    frame_caps = [up(max_frame0, margin, 8)] + out_caps
    caps = {
        "frame_caps": frame_caps,
        "edge_caps": [up(x, margin, 128) for x in max_edges],
        "dst_caps": [up(x, margin, 8) for x in max_dst],
        "out_caps": out_caps,
        "shuffle_caps": [up(x, margin, 8) for x in max_shuffle],
        "deg_caps": default_deg_caps(fanouts),
    }
    if cache_plan is not None:
        caps["refresh_cap"] = up(max_refresh, margin, 8)
    return caps


def scale_capacities(caps: dict, factor: float = 1.5) -> dict:
    """Grow every padding budget by ``factor`` (rounded up to 8). Used by
    trainers to auto-recover from capacity-overflow errors: measured
    capacities cover typical batches; a tail batch that overflows triggers
    a re-plan + recompile instead of a crash."""
    out = {}
    for k, v in caps.items():
        if k == "deg_caps":
            out[k] = list(v)  # hard bound (fanout + 1), never scaled
        elif isinstance(v, list):
            out[k] = [int(-(-int(np.ceil(x * factor)) // 8) * 8) for x in v]
        else:
            out[k] = int(-(-int(np.ceil(v * factor)) // 8) * 8)
    return out
