"""Split-parallel models and the training step of one partition.

The JAX package's ``parallel/model.py``: ``SplitSAGE``, ``SplitGCN`` and
``SplitGAT`` as ``nn.Module``s whose weights are plain tensors registered
under the keys of the JAX parameter pytree (``layer_{i}/w``,
``layer_{i}/b``, and GAT's ``layer_{i}/attn_l`` / ``attn_r``), so
``utils.checkpoint`` loads JAX weights unchanged, the device CSR for
on-device innermost sampling, and the train step and forward.
Weights stay f32; SAGE's and GCN's ``dtype`` is the storage precision of
activations between layers, with f32 accumulation, as in the JAX models.

At P = 1 the step is the JAX step on a one-device mesh: no process group
and no collective. At P > 1 each rank runs the per-device body of the JAX
step (``model.py:647-744``) on its own partition's row of the batch
(``ranks``, a ``parallel.dist.DistContext``): the boundary shuffle of
every layer that carries ``push_idx``, the loss terms ``[nll, count,
correct]`` all-reduced before the backward, and one SUM all-reduce of the
gradients before the optimizer step.

Split GAT's dense attention has the JAX package's lowerings
(``ops/config.py``): ``OCC_GAT_ATTENTION`` = ``batched``
(``dense_attention``, with ``OCC_GAT_AGG=fma`` as the other form of its
weighted sum), ``online`` or ``tiled``, each returning the same partials,
and ``OCC_GAT_REMAT=dots``, which recomputes the local attention's
elementwise chain in the backward. ``OCC_DEVICE_SAMPLE=window`` makes
``make_device_csr`` build the doubled CSR.

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
from torch.profiler import record_function
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from occ_gnn_tpu_torch.models.common import (
    dropout,
    linear,
    linear_init,
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

_SEVERAL_PARTITIONS = ("a batch with several partitions in one process is "
                       "not ported: each rank takes its own partition's row "
                       "(ROADMAP.md queue 1, item 7b, several partitions per "
                       "process)")


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


def dense_attention(x: torch.Tensor, nbr: torch.Tensor, wl: torch.Tensor,
                    w3: torch.Tensor, er_frame: torch.Tensor):
    """GAT's local streaming-softmax partials through the dense ``[K, D]``
    neighbour matrix, in the batched two-pass form of the JAX package
    (``parallel/model.py:294-363``, its default): gather the K leaf rows of
    ``x`` once, score them ``leaky_relu(x_leaf @ wl + er)``, take the exact
    max over K, weight, sum the weighted leaves per head in leaf space, and
    project per head with ``w3 [H_in, heads, Dh]`` last. The weighted sum
    is one batched product, or under ``OCC_GAT_AGG=fma`` an unrolled K-loop
    of broadcast multiply-adds (JAX ``:345-357``). Above
    ``OCC_GAT_RESID_WARN_GB`` of estimated residuals it warns, once a shape.

    Padding slots read the frame's reserved zero row ``x.shape[0] - 1`` and
    are masked to -inf before the exp, so no inf reaches the backward. The
    max is a shift and detached. Returns f32 ``(m_loc, s_loc [D, heads],
    v_loc [D, heads, Dh])``; a row with no valid leaf has ``m = -inf`` and
    zero sums. Under bf16 storage the products are taken in f32 on
    bf16-rounded operands, which is what JAX's bf16 dots with f32
    accumulation compute (``fma`` keeps the weights f32, as JAX does)."""
    with record_function("gat_attention_dense"):
        K, D = nbr.shape
        _warn_residuals(K, D, x, wl.shape[1])
        xg = x.index_select(0, nbr.reshape(-1)).reshape(K, D, -1)
        valid = (nbr != x.shape[0] - 1)[..., None]
        low = x.dtype != torch.float32
        if low:
            wl = wl.to(x.dtype).float()
            xg = xg.float()
        z = F.leaky_relu(xg @ wl + er_frame[None], NEGATIVE_SLOPE)
        m_loc = z.detach().masked_fill(~valid, float("-inf")).amax(dim=0)
        safe = torch.where(torch.isfinite(m_loc), m_loc, 0.0)
        pw = torch.exp((z - safe[None]).masked_fill(~valid, float("-inf")))
        s_loc = pw.sum(dim=0)
        if gat_agg_impl() == "fma":
            agg = pw[0][..., None] * xg[0][:, None, :]
            for kk in range(1, K):
                agg = agg + pw[kk][..., None] * xg[kk][:, None, :]
        else:
            if low:
                pw = pw.to(x.dtype).float()
            agg = torch.einsum("kdc,kdh->dch", pw, xg)
        return m_loc, s_loc, torch.einsum("dch,hco->dco", agg, w3)


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
    zk = F.leaky_relu(xg @ wl + er_frame, NEGATIVE_SLOPE)
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
    with record_function("gat_attention_online"):
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
    with record_function("gat_attention_tiled"):
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
            z = F.leaky_relu(xg @ wl_c + er_frame[None, t0:t0 + T],
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


class SplitGAT(nn.Module):
    """Split-parallel GAT, the component the reference only stubbed
    (``dist_gatconv.py:3-6``). At P > 1 a layer runs two all-to-alls
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
    all-to-alls with or without it."""

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

    def layer(self, i: int, lyr: SplitLayer, x: torch.Tensor,
              is_last: bool) -> torch.Tensor:
        p = self.layer_params(i)
        k, d_out = p["attn_l"].shape
        dst_cap = lyr.dst_cap
        # The attention vectors contracted into W: el / er of a row are
        # x_row @ wl / wr, so the frame's projection is never needed whole.
        w3 = p["w"].reshape(x.shape[-1], k, d_out)
        wl = torch.einsum("hkd,kd->hk", w3, p["attn_l"])
        wr = torch.einsum("hkd,kd->hk", w3, p["attn_r"])
        # er on the dst frame: the owned rows from their own features, the
        # foreign rows by the reverse shuffle from their owners.
        x_self = x.index_select(0, lyr.self_idx).float()
        er_own = (x_self @ wr) * lyr.owned_mask[:, None]
        tgt = torch.where(lyr.owned_idx < 0, dst_cap, lyr.owned_idx).long()
        er_frame = er_own.new_zeros(dst_cap + 1, k).index_copy(
            0, tgt, er_own)[:dst_cap]
        multi = lyr.push_idx is not None and lyr.push_idx.shape[0] > 1
        if multi:
            er_frame = reverse_shuffle(er_frame, lyr.push_idx, lyr.recv_idx)

        def attend(x, w, attn_l, wl, w3, er_frame):
            if lyr.nbr_idx is not None:
                return ATTENTION[gat_attention_impl()](
                    x, lyr.nbr_idx, wl, w3, er_frame)
            feat = (x.float() @ w).reshape(-1, k, d_out)
            return coo_attention(feat, attn_l, lyr.edge_src, lyr.edge_dst,
                                 er_frame)

        operands = (x, p["w"], p["attn_l"], wl, w3, er_frame)
        if gat_remat_impl() == "dots":
            # Only the local attention, between the shuffles: recomputing
            # an all-to-all in the backward would add exchanges.
            m_loc, s, v = checkpoint_dots(attend, *operands)
        else:
            m_loc, s, v = attend(*operands)
        if multi:
            s, v = shuffle_softmax_merge(m_loc, s, v, lyr.push_idx,
                                         lyr.recv_idx)
        own = lyr.owned_idx.clamp(min=0)
        s_own = s.index_select(0, own).clamp(min=1e-16)
        out = v.index_select(0, own) / s_own[..., None]   # [O_cap, K, D]
        out = out * lyr.owned_mask[:, None, None]
        if is_last:
            return out.mean(dim=1)
        return (out.reshape(-1, k * d_out) + p["b"]) * lyr.owned_mask[:, None]

    def forward_local(self, layers: list[SplitLayer], x: torch.Tensor,
                      generator: torch.Generator | None = None):
        """One partition's forward, as ``SplitSAGE.forward_local``, with
        ELU between layers; ``generator`` is unused (no dropout)."""
        last = len(layers) - 1
        for i, lyr in enumerate(layers):
            x = self.layer(i, lyr, x, is_last=(i == last))
            if i != last:
                x = F.elu(x)
        return x


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


def global_update(model: nn.Module, optimizer, logits: torch.Tensor,
                  labels: torch.Tensor, ranks: DistContext | None = None):
    """The masked CE of this rank's ``logits``, its backward and one
    optimizer step -> ``(loss, correct, count)``, global over ``ranks``.

    At P = 1 the loss is ``nll / max(count, 1)``. At P > 1 the
    ``[nll, count, correct]`` terms are all-reduced first, each rank
    differentiates ``nll_local / count_global`` and the gradients are
    SUM-all-reduced: the gradient of the global mean, as the JAX
    ``shard_map`` transpose gives it. The optimizer's ``zero_grad`` is
    the caller's, before the forward."""
    nll, count, correct = _local_ce(logits, labels)
    if ranks is None:
        loss = nll / count.clamp(min=1)
        loss.backward()
        zero_missing_grads(model.parameters())
        optimizer.step()
        return loss.detach(), correct, count
    totals = _global_ce(nll, count, correct)
    count_g = totals[1].clamp(min=1)
    (nll / count_g.float()).backward()
    all_reduce_gradients(model.parameters())
    optimizer.step()
    return (totals[0] / count_g).float(), totals[2].long(), totals[1].long()


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
        return global_update(model, optimizer, logits, batch.labels[0],
                             ranks)

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
