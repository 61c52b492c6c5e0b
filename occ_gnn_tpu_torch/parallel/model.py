"""Split-parallel models and the training step of one partition.

The JAX package's ``parallel/model.py``: ``SplitSAGE``, ``SplitGCN`` and
``SplitGAT`` as ``nn.Module``s whose weights are plain tensors registered
under the keys of the JAX parameter pytree (``layer_{i}/w``,
``layer_{i}/b``, and GAT's ``layer_{i}/attn_l`` / ``attn_r``), so
``utils.checkpoint`` loads JAX weights unchanged, the device CSR for
on-device innermost sampling, and the train step and forward. Beside
them ``SplitUniMP``, UniMP's graph transformer (which the JAX package
does not have), on split GAT's attention pipeline.
Weights stay f32; SAGE's and GCN's ``dtype`` is the storage precision of
activations between layers, with f32 accumulation, as in the JAX models.

A process holds L of the P partitions (``ranks``, a
``parallel.dist.DistContext``; without it, one process holds every
partition of the batch) and runs the per-device body of the JAX step
(``model.py:647-744``) for each of them, layer by layer: every
partition's local aggregation of layer i, one boundary shuffle of the
layer when it carries ``push_idx`` (``parallel.split``), then the owners'
update. The loss terms ``[nll, count, correct]`` are summed over the
local partitions, and over the processes by one all-reduce before the
backward; autograd sums the local partitions' gradients and one SUM
all-reduce sums the processes' before the optimizer step. A run of one
process issues no collective: at P = 1 the step is the JAX step on a
one-device mesh.

Split GAT's dense attention has the JAX package's lowerings
(``ops/config.py``): ``OCC_GAT_ATTENTION`` = ``batched``
(``dense_attention``: by default ``ops.gat_attention``, hand-written
kernels on the card; ``OCC_GAT_AGG=fma`` is the other form of its
weighted sum, in torch ops), ``online`` or ``tiled`` (torch ops), each
returning the same partials, and ``OCC_GAT_REMAT=dots``, which recomputes
the local attention's elementwise chain in the backward (on the card,
the attention's forward kernel once more a layer).
``OCC_DEVICE_SAMPLE=window`` makes ``make_device_csr`` build the doubled
CSR.

Only the feature frame's consumers differentiate: the frame never
requires grad, so layer 0 builds no ``dx`` (JAX differentiates the
params only).
"""

from __future__ import annotations

import os
import warnings
from functools import partial

import numpy as np
import torch
import torch.distributed as torch_dist
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from occ_gnn_tpu_torch.models.common import (
    dropout,
    linear,
    linear_init,
    xavier_uniform,
    zero_missing_grads,
)
from occ_gnn_tpu_torch.models.gat import (
    GAT_LEAVES,
    NEGATIVE_SLOPE,
    coo_attention,
    register_gat_params,
)
from occ_gnn_tpu_torch.ops.config import (
    device_sample_impl,
    gat_agg_impl,
    gat_attention_impl,
    gat_remat_impl,
    gat_tile,
)
from occ_gnn_tpu_torch.ops.dense_gather_sum import ScatterPlan
from occ_gnn_tpu_torch.ops.gat_attention import (
    _Projection,
    attention_pre,
    attention_scores,
    gat_attention,
    gat_tail,
    qk_attention,
)
from occ_gnn_tpu_torch.ops.unimp_tail import unimp_tail
from occ_gnn_tpu_torch.parallel.dist import DistContext, all_reduce_gradients
from occ_gnn_tpu_torch.parallel.split import (
    WINDOW_PAD,
    SplitBatch,
    SplitLayer,
    aggregate,
    neigh_mean,
    reverse_shuffle,
    shuffle_merge,
    shuffle_softmax_merge,
    slice_owned,
    synthesize_device_innermost,
)
from occ_gnn_tpu_torch.utils.timers import span

def make_device_csr(graph, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The graph's in-neighbour CSR on ``device`` as int32 ``(indptr,
    indices)`` for device-innermost sampling (~255 MB at products scale).

    Under ``OCC_DEVICE_SAMPLE=window`` the indices are the doubled layout
    of JAX ``parallel/model.py:42-89``: each node's adjacency written twice
    back to back, node i's span at ``[2 * indptr[i], 2 * indptr[i] + 2 *
    deg_i)``, then ``WINDOW_PAD`` zero words (twice the bytes). The indices
    tensor carries its layout (``csr_layout``, ``plain`` or ``doubled``),
    and ``synthesize_device_innermost`` refuses the one its lowering does
    not read."""
    if graph.num_edges >= 2**31 or graph.num_nodes >= 2**31:
        raise ValueError(
            "device-innermost sampling keeps the CSR on device as int32: "
            f"graph has {graph.num_edges} edges / {graph.num_nodes} nodes "
            "(>= 2^31) — use the host innermost path"
        )
    indptr = np.asarray(graph.indptr)
    indices = np.asarray(graph.indices, dtype=np.int32)
    layout = "plain"
    if device_sample_impl() == "window":
        E = indices.shape[0]
        if 2 * E + WINDOW_PAD >= 2**31:
            raise ValueError(
                "window device sampling doubles the indices array: "
                f"2*{E} edges overflows int32 offsets — use "
                "OCC_DEVICE_SAMPLE=randint for this graph"
            )
        deg = np.diff(indptr).astype(np.int64)
        node = np.repeat(np.arange(deg.shape[0], dtype=np.int64), deg)
        # Doubled position of edge e: indptr[node_e] + e (== 2 * off +
        # its place in the row); the second copy deg_e further.
        first = indptr[:-1].astype(np.int64)[node] + np.arange(
            E, dtype=np.int64)
        doubled = np.zeros(2 * E + WINDOW_PAD, dtype=np.int32)
        doubled[first] = indices
        doubled[first + deg[node]] = indices
        indices, layout = doubled, "doubled"
    indices_t = torch.from_numpy(indices).to(device)
    indices_t.csr_layout = layout
    return torch.from_numpy(indptr.astype("int32")).to(device), indices_t


def _materialize_layers(parts, csr, generators):
    """Synthesize the device-sampled layers of each local partition,
    partition j's from ``generators[j]``: the draws of partition p do not
    depend on which process holds it."""
    out = []
    for j, layers in enumerate(parts):
        mine = []
        for lyr in layers:
            if lyr.device_sampled:
                if csr is None:
                    raise ValueError(
                        "batch has a device-sampled layer but the step was "
                        "built without csr= (make_device_csr(graph, device))"
                    )
                if generators is None:
                    raise ValueError(
                        "device-sampled layers need sample_generator= on "
                        "every step call"
                    )
                lyr = synthesize_device_innermost(lyr, csr[0], csr[1],
                                                  generators[j])
            mine.append(lyr)
        out.append(mine)
    return out


def _stack(ts: list[torch.Tensor]) -> torch.Tensor:
    """The local partitions' tensors on one leading axis (a view for
    one)."""
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def _shuffled(lyrs: list[SplitLayer]) -> bool:
    """Whether a layer exchanges boundary rows: it carries ``push_idx``
    and the run has more than one partition (the device-synthesized
    layer 0 carries none)."""
    return lyrs[0].push_idx is not None and lyrs[0].push_idx.shape[0] > 1


def _indices(lyrs: list[SplitLayer]):
    """The local partitions' ``push_idx`` and ``recv_idx``, ``[L, P,
    S_cap]`` each."""
    return (_stack([l.push_idx for l in lyrs]),
            _stack([l.recv_idx for l in lyrs]))


class _SplitModel(nn.Module):
    """The layer loop of the split models. ``layers(i, lyrs, xs,
    is_last)`` runs layer ``i`` of every local partition; this forward
    only chains them, so a model whose layers end in their own
    activation (split GAT's and UniMP's tails) needs nothing more."""

    def forward_partitions(self, parts: list[list[SplitLayer]], xs,
                           generator: torch.Generator | None = None):
        """The forward of the local partitions, layer by layer: ``parts[j]``
        and ``xs[j]`` are partition j's layers and input frame. Returns
        each partition's logits. ``generator`` is unused here (no
        dropout)."""
        xs = list(xs)
        last = len(parts[0]) - 1
        for i in range(last + 1):
            xs = self.layers(i, [layers[i] for layers in parts], xs,
                             is_last=(i == last))
        return xs

    def forward_local(self, layers: list[SplitLayer], x: torch.Tensor,
                      generator: torch.Generator | None = None):
        """One partition's forward (``forward_partitions`` of one)."""
        return self.forward_partitions([layers], [x], generator)[0]


class SplitSAGE(_SplitModel):
    """Split-parallel GraphSAGE: h_v = W.concat(x_v, mean_{N(v)+v} x_u) + b."""

    # Whether a training batch must carry each dense layer's ScatterPlan
    # past layer 0 (the samplers' ``scatter_plans``): SAGE's backward
    # reads none, so its arena stays as JAX's.
    needs_scatter_plans = False

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
    def _merge(neighs: list[torch.Tensor],
               lyrs: list[SplitLayer]) -> list[torch.Tensor]:
        """Add the boundary partials of the other partitions to each local
        partition's sums: one shuffle over the local partitions."""
        if not _shuffled(lyrs):
            return neighs
        return list(shuffle_merge(_stack(neighs), *_indices(lyrs)).unbind(0))

    def layers(self, i: int, lyrs: list[SplitLayer],
               xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Layer ``i`` of every local partition: ``lyrs[j]`` and ``xs[j]``
        are partition j's layer and input frame."""
        merged = self._merge([aggregate(x, l) for x, l in zip(xs, lyrs)],
                             lyrs)
        out = []
        for m, lyr, x in zip(merged, lyrs, xs):
            self_x, mean, mask = slice_owned(m, lyr, x)
            h = linear(self.layer_params(i), torch.cat([self_x, mean],
                                                       dim=-1))
            out.append(h * mask)
        return out

    def layer(self, i: int, lyr: SplitLayer, x: torch.Tensor) -> torch.Tensor:
        """Layer ``i`` of one partition."""
        return self.layers(i, [lyr], [x])[0]

    def forward_partitions(self, parts: list[list[SplitLayer]], xs,
                           generator: torch.Generator | None = None):
        """As ``_SplitModel.forward_partitions``, with a ReLU between
        layers. ``generator`` enables dropout there (training), drawn
        partition by partition; ``None`` is the deterministic path."""
        xs = list(xs)
        last = len(parts[0]) - 1
        for i in range(last + 1):
            xs = self.layers(i, [layers[i] for layers in parts], xs)
            if i != last:
                xs = [torch.relu(x) for x in xs]
                if generator is not None and self.dropout > 0.0:
                    xs = [dropout(x, self.dropout, generator, True)
                          for x in xs]
                xs = [x.to(self.dtype) for x in xs]
        return xs


class SplitGCN(SplitSAGE):
    """Split-parallel GCN: mean aggregation (self loop in edges) + linear."""

    @staticmethod
    def _fan_in(dim: int) -> int:
        return dim

    def layers(self, i: int, lyrs: list[SplitLayer],
               xs: list[torch.Tensor]) -> list[torch.Tensor]:
        merged = self._merge([aggregate(x, l) for x, l in zip(xs, lyrs)],
                             lyrs)
        return [linear(self.layer_params(i), neigh_mean(m, lyr))
                * lyr.owned_mask[:, None] for m, lyr in zip(merged, lyrs)]


def dense_attention(x: torch.Tensor, nbr: torch.Tensor, wl: torch.Tensor,
                    w3: torch.Tensor, er_frame: torch.Tensor,
                    plan: ScatterPlan | None = None):
    """GAT's local streaming-softmax partials through the dense ``[K, D]``
    neighbour matrix, in the batched two-pass form of the JAX package
    (``parallel/model.py:294-363``, its default): score each leaf row of
    ``x`` ``leaky_relu(x_leaf @ wl + er)``, take the exact max over K,
    weight, sum the weighted leaves per head in leaf space, and project per
    head with ``w3 [H_in, heads, Dh]`` last. By default that is
    ``ops.gat_attention``: on the card its hand-written kernels, which
    never write the ``[K, D, H_in]`` leaves. Under ``OCC_GAT_AGG=fma`` the
    leaves are gathered whole and the weighted sum is an unrolled K-loop
    of broadcast multiply-adds in torch ops (JAX ``:345-357``). Above
    ``OCC_GAT_RESID_WARN_GB`` of residuals, as JAX estimates them for its
    gathered leaves, it warns, once a shape. ``plan`` is ``nbr``'s
    ``ScatterPlan``, which the kernels' gradient to ``x`` reads on the
    card (the batch's ``SplitLayer.scatter_plan``).

    Padding slots read the frame's reserved zero row ``x.shape[0] - 1`` and
    are masked to -inf before the exp, so no inf reaches the backward. The
    max is a shift and detached. Returns f32 ``(m_loc, s_loc [D, heads],
    v_loc [D, heads, Dh])``; a row with no valid leaf has ``m = -inf`` and
    zero sums. Under bf16 storage the products are taken in f32 on
    bf16-rounded operands, which is what JAX's bf16 dots with f32
    accumulation compute (``fma`` keeps the weights f32, as JAX does)."""
    with span("gat_attention_dense"):
        K, D = nbr.shape
        _warn_residuals(K, D, x, wl.shape[1])
        if gat_agg_impl() != "fma":
            return gat_attention(x, nbr, wl, w3, er_frame, plan)
        xg, pw, m_loc = attention_scores(x, nbr, wl, er_frame)
        agg = pw[0][..., None] * xg[0][:, None, :]
        for kk in range(1, K):
            agg = agg + pw[kk][..., None] * xg[kk][:, None, :]
        return (m_loc, pw.sum(dim=0),
                torch.einsum("dch,hco->dco", agg, w3))


# Shapes the residual warning has fired for in this process.
_WARNED_SHAPES: set = set()


def _warn_residuals(K: int, D: int, x: torch.Tensor, heads: int) -> None:
    """JAX's estimate of the batched form's residuals (``model.py:296-321``):
    the ``[K, D, H_in]`` leaves in the storage dtype and two ``[K, D,
    heads]`` f32 score tensors; warns above ``OCC_GAT_RESID_WARN_GB``
    (default 4), once for each shape."""
    res_gb = K * D * (x.shape[-1] * x.element_size() + 2 * heads * 4) / 1e9
    shape = (K, D, x.shape[-1], x.dtype, heads)
    if (res_gb > float(os.environ.get("OCC_GAT_RESID_WARN_GB", "4"))
            and shape not in _WARNED_SHAPES):
        _WARNED_SHAPES.add(shape)
        warnings.warn(
            f"batched GAT attention materializes ~{res_gb:.1f} GB "
            "of residuals; if this OOMs, set "
            "OCC_GAT_ATTENTION=online (flash-style streaming, "
            "O(D*H) residents)", stacklevel=3)


def _online_step(m, s, v, x, idx, w, wl, er_frame):
    """One k of ``online_attention``: fold leaf row k of every dst into
    the running (max, sum of exps, weighted values)."""
    heads, d_out = v.shape[1:]
    valid = (idx != x.shape[0] - 1)[:, None]
    xg = x.index_select(0, idx).float()
    zk = F.leaky_relu(attention_pre(xg, wl, er_frame), NEGATIVE_SLOPE)
    m_new = torch.maximum(m, zk.detach().masked_fill(~valid, float("-inf")))
    safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    scale = torch.where(torch.isfinite(m), torch.exp(m - safe), 0.0)
    pk = torch.exp((zk - safe).masked_fill(~valid, float("-inf")))
    fk = (xg @ w).reshape(-1, heads, d_out)
    return (m_new, s * scale + pk,
            v * scale[..., None] + pk[..., None] * fk)


def online_attention(x: torch.Tensor, nbr: torch.Tensor, wl: torch.Tensor,
                     w3: torch.Tensor, er_frame: torch.Tensor):
    """``dense_attention``'s partials by a flash-style pass over K
    (``OCC_GAT_ATTENTION=online``, JAX ``parallel/model.py:461-499``): k by
    k, each dst's leaf row is scored, the running max raised, the running
    sums rescaled by ``exp(m - m_new)`` and the projected leaf ``x_leaf @
    W`` added with its weight. Each step runs under ``torch.utils.
    checkpoint``, as JAX wraps it in ``jax.checkpoint``: autograd keeps the
    ``(m, s, v)`` carries between steps and recomputes a step's gather and
    product in the backward. The running max is detached and invalid
    scores are -inf before the exp, so no inf or nan reaches the backward.
    Leaves are taken in f32 under bf16 storage (JAX ``:476``)."""
    with span("gat_attention_online"):
        K, D = nbr.shape
        H, heads, d_out = w3.shape
        w = w3.reshape(H, heads * d_out)
        m = er_frame.new_full((D, heads), float("-inf"))
        s = er_frame.new_zeros((D, heads))
        v = er_frame.new_zeros((D, heads, d_out))
        for kk in range(K):
            m, s, v = checkpoint(_online_step, m, s, v, x, nbr[kk], w, wl,
                                 er_frame, use_reentrant=False)
        return m, s, v


def tiled_attention(x: torch.Tensor, nbr: torch.Tensor, wl: torch.Tensor,
                    w3: torch.Tensor, er_frame: torch.Tensor):
    """``dense_attention``'s partials over dst tiles of ``OCC_GAT_TILE``
    rows (``OCC_GAT_ATTENTION=tiled``, JAX ``parallel/model.py:407-459``):
    per tile one ``[K, T, H]`` leaf gather, the exact softmax over K, then
    project-then-weight, one ``[T, H] @ [H, heads * Dh]`` product a k
    added with its softmax weight. Same numerics as the batched form but
    for the order of the sums."""
    with span("gat_attention_tiled"):
        T = gat_tile()
        K, D = nbr.shape
        H, heads, d_out = w3.shape
        w3f = w3.reshape(H, heads * d_out)
        sentinel = x.shape[0] - 1
        wl_c = wl.to(x.dtype).float() if x.dtype != torch.float32 else wl
        ms, ss, vs = [], [], []
        for t0 in range(0, D, T):
            nbr_t = nbr[:, t0:t0 + T]
            xg = x.index_select(0, nbr_t.reshape(-1)).reshape(
                K, nbr_t.shape[1], H).float()
            valid = (nbr_t != sentinel)[..., None]
            z = F.leaky_relu(attention_pre(xg, wl_c,
                                           er_frame[None, t0:t0 + T]),
                             NEGATIVE_SLOPE)
            m = z.detach().masked_fill(~valid, float("-inf")).amax(dim=0)
            safe = torch.where(torch.isfinite(m), m, 0.0)
            pw = torch.exp((z - safe[None]).masked_fill(~valid,
                                                        float("-inf")))
            v = None
            for kk in range(K):
                f = (xg[kk] @ w3f).reshape(-1, heads, d_out)
                c = pw[kk][..., None] * f
                v = c if v is None else v + c
            ms.append(m)
            ss.append(pw.sum(dim=0))
            vs.append(v)
        return torch.cat(ms), torch.cat(ss), torch.cat(vs)


ATTENTION = {"batched": dense_attention, "online": online_attention,
             "tiled": tiled_attention}


def _save_products(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_dots(fn, *args):
    """``fn(*args)`` under ``OCC_GAT_REMAT=dots`` (JAX's
    ``dots_with_no_batch_dims_saveable``, ``model.py:501-524``): autograd
    keeps the outputs of the matrix products (``aten.mm``,
    ``aten.addmm``) and recomputes the rest of ``fn`` in the backward."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=partial(create_selective_checkpoint_contexts,
                                         _save_products))


class SplitGAT(_SplitModel):
    """Split-parallel GAT, the component the reference only stubbed
    (``dist_gatconv.py:3-6``). At P > 1 a layer runs two shuffles
    forward and two backward: ``reverse_shuffle`` sends the owners'
    attention terms ``er_v = a_r . W x_v`` to the partitions holding v's
    edges, and ``shuffle_softmax_merge`` merges the partitions' (max,
    sum-exp, weighted value) partials at the owner, exactly.

    Weights as ``models.gat.GATModel``'s. It has no dropout and keeps its
    activations f32, as the JAX trainer builds it (without ``--dropout``
    or ``--dtype``); a bf16 cache frame still feeds layer 0.

    A dense layer attends through the lowering ``OCC_GAT_ATTENTION``
    names (``dense_attention``, ``online_attention``,
    ``tiled_attention``). Under ``OCC_GAT_REMAT=dots`` the local attention
    between the two shuffles is recomputed in the backward
    (``checkpoint_dots``); the shuffles are not, so a step runs the same
    exchanges with or without it."""

    # The attention kernels' gradient to x sums a row a slot through the
    # batch's ScatterPlan, which the samplers build on the host.
    needs_scatter_plans = True

    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_layers: int, num_heads: int = 4,
                 generator: torch.Generator | None = None):
        """Weights are drawn on the CPU from ``generator``; move the model
        with ``.to(device)``."""
        super().__init__()
        self.in_dim = in_dim
        self.hidden = hidden
        self.num_classes = num_classes
        self.num_layers = num_layers
        self.num_heads = num_heads
        register_gat_params(self, in_dim, hidden, num_classes, num_layers,
                            num_heads, generator)

    def layer_params(self, i: int) -> dict:
        return {name: getattr(self, f"layer_{i}/{name}")
                for name in GAT_LEAVES}

    def layers(self, i: int, lyrs: list[SplitLayer], xs: list[torch.Tensor],
               is_last: bool) -> list[torch.Tensor]:
        """Layer ``i`` of every local partition, as ``SplitSAGE.layers``:
        each partition's er frame, one reverse shuffle, each partition's
        local attention, one softmax merge, then the tail at the owners'
        rows (``ops.gat_attention.gat_tail``: the softmax's division, and
        on a hidden layer the bias and ELU, on the last the heads'
        mean)."""
        p = self.layer_params(i)
        k, d_out = p["attn_l"].shape
        # The attention vectors contracted into W: el / er of a row are
        # x_row @ wl / wr, so the frame's projection is never needed whole.
        w3 = p["w"].reshape(xs[0].shape[-1], k, d_out)
        wl = torch.einsum("hkd,kd->hk", w3, p["attn_l"])
        wr = torch.einsum("hkd,kd->hk", w3, p["attn_r"])
        multi = _shuffled(lyrs)
        if multi:
            push, recv = _indices(lyrs)
        # er on the dst frame: the owned rows from their own features, the
        # foreign rows by the reverse shuffle from their owners.
        er_frames = []
        for lyr, x in zip(lyrs, xs):
            x_self = x.index_select(0, lyr.self_idx).float()
            er_own = (x_self @ wr) * lyr.owned_mask[:, None]
            tgt = torch.where(lyr.owned_idx < 0, lyr.dst_cap,
                              lyr.owned_idx).long()
            er_frames.append(er_own.new_zeros(lyr.dst_cap + 1, k).index_copy(
                0, tgt, er_own)[:lyr.dst_cap])
        if multi:
            er_frames = list(reverse_shuffle(_stack(er_frames), push,
                                             recv).unbind(0))
        partials = []
        for lyr, x, er_frame in zip(lyrs, xs, er_frames):

            def attend(x, w, attn_l, wl, w3, er_frame, lyr=lyr):
                if lyr.nbr_idx is not None:
                    impl = gat_attention_impl()
                    if impl == "batched":  # its kernels read the plan
                        return dense_attention(x, lyr.nbr_idx, wl, w3,
                                               er_frame, lyr.scatter_plan)
                    return ATTENTION[impl](x, lyr.nbr_idx, wl, w3, er_frame)
                feat = (x.float() @ w).reshape(-1, k, d_out)
                return coo_attention(feat, attn_l, lyr.edge_src,
                                     lyr.edge_dst, er_frame)

            operands = (x, p["w"], p["attn_l"], wl, w3, er_frame)
            if gat_remat_impl() == "dots":
                # Only the local attention, between the shuffles:
                # recomputing an exchange in the backward would add some.
                partials.append(checkpoint_dots(attend, *operands))
            else:
                partials.append(attend(*operands))
        ms, ss, vs = (list(t) for t in zip(*partials))
        if multi:
            s_all, v_all = shuffle_softmax_merge(_stack(ms), _stack(ss),
                                                 _stack(vs), push, recv)
            ss, vs = list(s_all.unbind(0)), list(v_all.unbind(0))
        with span("gat_tail"):
            return [gat_tail(v, s, lyr.owned_idx, lyr.owned_mask,
                             None if is_last else p["b"])
                    for lyr, s, v in zip(lyrs, ss, vs)]

    def layer(self, i: int, lyr: SplitLayer, x: torch.Tensor,
              is_last: bool) -> torch.Tensor:
        """Layer ``i`` of one partition."""
        return self.layers(i, [lyr], [x], is_last)[0]

UNIMP_LEAVES = ("w_q", "b_q", "w_k", "w_v", "b_v", "w_s", "b_s", "w_beta",
                "ln_g", "ln_b")


class SplitUniMP(_SplitModel):
    """Split-parallel UniMP (Shi et al., IJCAI 2021): PyG's
    ``TransformerConv`` with ``beta=True`` and ``root_weight=True``, each
    hidden layer followed by LayerNorm and ReLU. A layer, per head c of
    width dh over the slots S(i) of dst i (the node itself among them),

        q_i = W_q x_i + b_q,  alpha_ij = softmax_j(q_i,c . W_k,c x_j / sqrt(dh))
        m_i = sum_j alpha_ij (W_v x_j + b_v), heads concatenated (the last
              layer: averaged)
        r_i = W_s x_i + b_s,  beta_i = sigmoid(w_beta . [m_i, r_i, m_i - r_i])
        out_i = beta_i r_i + (1 - beta_i) m_i

    then on a hidden layer ``relu(layer_norm(out) * (1 + ln_g) + ln_b)``.
    The key bias cancels in the softmax and is left out.

    It runs split GAT's pipeline: ``q`` at the owned rows (one
    ``reverse_shuffle`` at P > 1 sends it, ``heads * dh`` wide, to the
    partitions holding the rows' edges), each partition forms the
    score vectors ``u = W_k,c^T q_c / sqrt(dh)`` in leaf space, the
    query-key attention kernels (``ops.gat_attention.qk_attention``) weight
    the leaves and ``W_v`` projects the sums, one ``shuffle_softmax_merge``
    merges the partials at the owners, and the tail
    (``ops.unimp_tail.unimp_tail``) adds the value bias, the skip, the
    gate and the LayerNorm. Dense layers only; no dropout; activations
    f32 (a bf16 frame is read as f32).

    Leaves ``layer_{i}/w_q, b_q, w_k, w_v, b_v, w_s, b_s, w_beta`` and on
    a hidden layer ``ln_g, ln_b``: Xavier matrices (``w_beta [3 W, 1]``, W
    the layer's output width), zero vectors."""

    needs_scatter_plans = True

    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_layers: int, num_heads: int = 4,
                 generator: torch.Generator | None = None):
        """Weights are drawn on the CPU from ``generator``; move the model
        with ``.to(device)``. ``hidden`` is a head's width."""
        super().__init__()
        self.in_dim = in_dim
        self.hidden = hidden
        self.num_classes = num_classes
        self.num_layers = num_layers
        self.num_heads = k = num_heads
        ins = [in_dim] + [hidden * k] * (num_layers - 1)
        outs = [hidden] * (num_layers - 1) + [num_classes]
        for i in range(num_layers):
            last = i == num_layers - 1
            hq = k * outs[i]
            width = outs[i] if last else hq
            init = {
                "w_q": xavier_uniform(generator, (ins[i], hq)),
                "b_q": torch.zeros(hq),
                "w_k": xavier_uniform(generator, (ins[i], hq)),
                "w_v": xavier_uniform(generator, (ins[i], hq)),
                "b_v": torch.zeros(hq),
                "w_s": xavier_uniform(generator, (ins[i], width)),
                "b_s": torch.zeros(width),
                "w_beta": xavier_uniform(generator, (3 * width, 1)),
            }
            if not last:
                init["ln_g"] = torch.zeros(width)
                init["ln_b"] = torch.zeros(width)
            for name, value in init.items():
                self.register_parameter(f"layer_{i}/{name}",
                                        nn.Parameter(value))

    def layer_params(self, i: int) -> dict:
        return {name: getattr(self, f"layer_{i}/{name}")
                for name in UNIMP_LEAVES
                if hasattr(self, f"layer_{i}/{name}")}

    def layers(self, i: int, lyrs: list[SplitLayer], xs: list[torch.Tensor],
               is_last: bool) -> list[torch.Tensor]:
        """Layer ``i`` of every local partition, as ``SplitGAT.layers``:
        each partition's query frame (span ``unimp_query``: ``q`` at the
        owned rows, its reverse shuffle, the score vectors ``u``), its
        local attention (``qk_attention_dense``), one softmax merge, then
        the tail at the owners' rows (``unimp_tail``)."""
        p = self.layer_params(i)
        k = self.num_heads
        xs = [x.float() for x in xs]
        h_in = xs[0].shape[-1]
        dh = p["w_q"].shape[1] // k
        # u's product is the per-head projection of q by W_k^T (its weight
        # gradient summed over chunks of the dst rows).
        wk_t = (p["w_k"] * dh ** -0.5).reshape(h_in, k, dh).permute(2, 1, 0)
        wv = p["w_v"].reshape(h_in, k, dh)
        multi = _shuffled(lyrs)
        if multi:
            push, recv = _indices(lyrs)
        with span("unimp_query"):
            selves, q_frames = [], []
            for lyr, x in zip(lyrs, xs):
                x_self = x.index_select(0, lyr.self_idx)
                q_own = (torch.addmm(p["b_q"], x_self, p["w_q"])
                         * lyr.owned_mask[:, None])
                # The owned rows are the dst frame's prefix; the rest of
                # the frame is zero until the reverse shuffle fills it.
                rest = lyr.dst_cap - q_own.shape[0]
                q_frames.append(F.pad(q_own, (0, 0, 0, rest)) if rest
                                else q_own)
                selves.append(x_self)
            if multi:
                q_frames = list(reverse_shuffle(_stack(q_frames), push,
                                                recv).unbind(0))
            us = [_Projection.apply(q.view(-1, k, dh), wk_t)
                  for q in q_frames]
        partials = []
        with span("qk_attention_dense"):
            for lyr, x, u in zip(lyrs, xs, us):
                if lyr.nbr_idx is None:
                    raise ValueError("SplitUniMP attends through the dense "
                                     "neighbour matrix: the batch's layer "
                                     "carries no nbr_idx")
                partials.append(qk_attention(x, lyr.nbr_idx, u, wv,
                                             lyr.scatter_plan))
        ms, ss, vs = (list(t) for t in zip(*partials))
        if multi:
            s_all, v_all = shuffle_softmax_merge(_stack(ms), _stack(ss),
                                                 _stack(vs), push, recv)
            ss, vs = list(s_all.unbind(0)), list(v_all.unbind(0))
        with span("unimp_tail"):
            return [unimp_tail(v, s, torch.addmm(p["b_s"], x_self, p["w_s"]),
                               p["b_v"], p["w_beta"], lyr.owned_mask,
                               *((None, None) if is_last
                                 else (p["ln_g"], p["ln_b"])))
                    for lyr, s, v, x_self in zip(lyrs, ss, vs, selves)]

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
                  ranks: DistContext | None) -> list[list[SplitLayer]]:
    """This process's layers, ``[partition j][layer i]``: the batch holds
    its L partitions' rows, and its P-slot axes span the run's P
    partitions (without ``ranks``, one process holds them all)."""
    L = batch.num_partitions
    P = ranks.num_partitions if ranks is not None else L
    if ranks is not None and L != ranks.local:
        raise ValueError(f"the batch holds {L} partitions, this process "
                         f"holds {ranks.local} ({ranks.lo}..{ranks.hi - 1})")
    for lyr in batch.layers:
        if lyr.push_idx is not None and lyr.push_idx.shape[1] != P:
            raise ValueError(f"the batch was sliced for "
                             f"{lyr.push_idx.shape[1]} partitions, the run "
                             f"has {P}")
    return [[lyr.partition(j) for lyr in batch.layers] for j in range(L)]


def _check_frames(x0: torch.Tensor, L: int) -> None:
    if x0.shape[0] != L:
        raise ValueError(f"the batch holds {L} partitions but x0 has "
                         f"{x0.shape[0]} input frames")


def _generators(sample_generator, L: int):
    """One device-draw generator per local partition: a sequence of L,
    or at L = 1 the generator itself."""
    if sample_generator is None or not isinstance(sample_generator,
                                                  torch.Generator):
        return sample_generator
    if L != 1:
        raise ValueError(f"{L} partitions in this process draw from one "
                         "generator each: pass sample_generator= as a list")
    return [sample_generator]


# The all-reduces ``global_update`` has issued in this process: two an
# update with a process group (the loss terms, then the gradients), none
# in a run of one process.
_UPDATE_COLLECTIVES = [0]


def update_collective_count() -> int:
    """The all-reduces of the updates this process issued."""
    return _UPDATE_COLLECTIVES[0]


def _global_ce(nll, count, correct):
    """``[nll, count, correct]`` summed over the processes, detached
    (JAX's psum of the three, ``model.py:683-687``), on the device."""
    totals = torch.stack([nll.detach().double(), count.double(),
                          correct.double()])
    torch_dist.all_reduce(totals)
    _UPDATE_COLLECTIVES[0] += 1
    return totals


def global_update(model: nn.Module, optimizer, logits, labels,
                  ranks: DistContext | None = None):
    """The masked CE of this process's ``logits``, its backward and one
    optimizer step -> ``(loss, correct, count)``, global over ``ranks``.
    ``logits`` and ``labels`` are one partition's tensors, or sequences
    of the local partitions'.

    ``[nll, count, correct]`` are summed over the local partitions; in a
    run of one process the loss is ``nll / max(count, 1)``. With several
    processes the terms are all-reduced first, each process
    differentiates ``nll_local / count_global`` and the gradients are
    SUM-all-reduced: the gradient of the global mean, as the JAX
    ``shard_map`` transpose gives it. The optimizer's ``zero_grad`` is
    the caller's, before the forward.

    Its spans: ``occ.step.loss`` (the CE terms and, grouped, their
    reduction), ``occ.step.backward`` (the backward and, grouped, the
    gradients' all-reduce) and ``occ.step.optimizer``."""
    if isinstance(logits, torch.Tensor):
        logits, labels = [logits], [labels]
    grouped = ranks is not None and ranks.grouped
    with span("occ.step.loss"):
        terms = [_local_ce(lg, lb) for lg, lb in zip(logits, labels)]
        nll, count, correct = (sum(t[k] for t in terms) for k in range(3))
        if grouped:
            totals = _global_ce(nll, count, correct)
            count_g = totals[1].clamp(min=1)
            loss = nll / count_g.float()
        else:
            loss = nll / count.clamp(min=1)
    with span("occ.step.backward"):
        loss.backward()
        if grouped:
            all_reduce_gradients(model.parameters())
            _UPDATE_COLLECTIVES[0] += 1
        else:
            zero_missing_grads(model.parameters())
    with span("occ.step.optimizer"):
        optimizer.step()
    if not grouped:
        return loss.detach(), correct, count
    return (totals[0] / count_g).float(), totals[2].long(), totals[1].long()


def make_split_train_step(model: SplitSAGE, optimizer, csr=None,
                          ranks: DistContext | None = None):
    """``step(batch, x0, generator=None, sample_generator=None) -> (loss,
    correct, count)``: forward, masked CE, backward and one optimizer
    update of ``model`` in place. ``batch`` holds this process's L
    partitions' rows and ``x0`` their input frames ``[L, F, H]`` (the
    cache frames or the gathered rows). ``ranks`` (``parallel.dist``)
    places the process in its run; without it the process holds every
    partition of the batch. The loss, correct and count returned are
    global, the same in every process.

    ``csr`` (``make_device_csr``) enables device-sampled innermost layers;
    those steps need ``sample_generator``, one generator on the device
    per local partition (a list; at L = 1 the generator itself).
    Nothing here waits for the device: the results are device tensors.
    A step is the span ``occ.step``; inside it ``occ.step.layers`` (the
    device-sampled layers' synthesis), ``occ.step.forward`` and
    ``global_update``'s spans."""

    def step(batch: SplitBatch, x0: torch.Tensor,
             generator: torch.Generator | None = None,
             sample_generator=None):
        with span("occ.step"):
            _check_dropout_rng(model, generator)
            L = batch.num_partitions
            _check_frames(x0, L)
            with span("occ.step.layers"):
                parts = _materialize_layers(_local_layers(batch, ranks), csr,
                                            _generators(sample_generator, L))
            model.train()
            optimizer.zero_grad(set_to_none=True)
            with span("occ.step.forward"):
                logits = model.forward_partitions(parts, x0, generator)
            return global_update(model, optimizer, logits,
                                 batch.labels.unbind(0), ranks)

    return step


def make_split_forward(model: SplitSAGE, csr=None,
                       ranks: DistContext | None = None):
    """``fwd(batch, x0, sample_generator=None) -> logits [L, T_cap, C]``:
    inference on this process's L partitions, without dropout or
    gradients (with the boundary shuffles when the run has P > 1
    partitions)."""

    @torch.no_grad()
    def fwd(batch: SplitBatch, x0: torch.Tensor, sample_generator=None):
        L = batch.num_partitions
        _check_frames(x0, L)
        parts = _materialize_layers(_local_layers(batch, ranks), csr,
                                    _generators(sample_generator, L))
        model.eval()
        return torch.stack(model.forward_partitions(parts, x0))

    return fwd
