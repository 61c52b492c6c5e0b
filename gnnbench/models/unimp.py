"""UniMP's graph transformer: PyG's ``TransformerConv`` (``beta=True``,
``root_weight=True``) with LayerNorm and ReLU after each hidden layer,
heads concatenated on hidden layers and averaged on the last; its
query-key attention kernels' bound."""

from __future__ import annotations

from gnnbench import flops
from gnnbench.flops import F32_BYTES, LayerCounts

# The form of the port's split UniMP, which the configuration states.
FORM = {"dropout": 0.0, "label_input": "none", "self_in_softmax": True,
        "key_bias": False, "draws_with_replacement": True}


def widths(cfg: dict) -> list[tuple[int, int]]:
    """``(h_in, h_out)`` of each layer, innermost first; ``h_out`` is a
    head's width."""
    n, hidden, k = (int(cfg["num_layers"]), int(cfg["hidden"]),
                    int(cfg["heads"]))
    ins = [int(cfg["feature_dim"])] + [hidden * k] * (n - 1)
    return list(zip(ins, [hidden] * (n - 1) + [int(cfg["num_classes"])]))


def param_shapes(cfg: dict) -> dict:
    """``{name: (shape, xavier gain or None for zeros)}``, the port's
    names and order; ``W`` is a layer's output width (the heads' on a
    hidden layer, a head's on the last)."""
    k = int(cfg["heads"])
    layers = widths(cfg)
    out = {}
    for i, (h_in, h_out) in enumerate(layers):
        last = i == len(layers) - 1
        hq = k * h_out
        width = h_out if last else hq
        out[f"layer_{i}/w_q"] = ((h_in, hq), 1.0)
        out[f"layer_{i}/b_q"] = ((hq,), None)
        out[f"layer_{i}/w_k"] = ((h_in, hq), 1.0)
        out[f"layer_{i}/w_v"] = ((h_in, hq), 1.0)
        out[f"layer_{i}/b_v"] = ((hq,), None)
        out[f"layer_{i}/w_s"] = ((h_in, width), 1.0)
        out[f"layer_{i}/b_s"] = ((width,), None)
        out[f"layer_{i}/w_beta"] = ((3 * width, 1), 1.0)
        if not last:
            out[f"layer_{i}/ln_g"] = ((width,), None)
            out[f"layer_{i}/ln_b"] = ((width,), None)
    return out


def output_leaf(cfg: dict) -> str:
    """The output layer's skip weights, which ``check.py``'s
    ``grad1_out_gap`` reads: the shortest way from the loss to a
    weight."""
    return f"layer_{int(cfg['num_layers']) - 1}/w_s"


def layer_flops(c: LayerCounts, heads: int, first: bool, last: bool) -> float:
    """The port's UniMP form on valid rows: the query, score-vector and
    value products (``2 D h_in heads h_out`` each), the skip (``2 D h_in
    W``), the attention kernels' scores and weighted sums of each filled
    slot's row per head, and the gate's two dots, forward and backward;
    the first layer's frame takes no gradient."""
    hq = heads * c.h_out
    width = c.h_out if last else hq
    proj = 2 * c.D * c.h_in * hq
    skip = 2 * c.D * c.h_in * width
    att = c.V * heads * c.h_in
    softmax = 3 * c.V * heads
    gate = 4 * c.D * width
    fwd = 3 * proj + skip + 4 * att + softmax + gate
    bwd = ((5 if first else 6) * proj + (1 if first else 2) * skip
           + (6 if first else 10) * att + softmax + 2 * gate)
    return fwd + bwd


def step_flops(layers: list[LayerCounts], cfg: dict) -> float:
    heads = int(cfg["heads"])
    return sum(layer_flops(c, heads, i == 0, i == len(layers) - 1)
               for i, c in enumerate(layers))


def qk_attention_bound(c: LayerCounts, heads: int, first: bool) -> float:
    """``qk_attn_fwd`` and ``qk_attn_bwd`` (with the rows' gradient above
    the first layer): ``flops.gat_attention_bound``'s count with the
    columns' score vectors ``u`` (``4 D heads h_in`` bytes) read in place
    of ``wl`` and ``er``, no ``der``, and ``du`` written backward."""
    h, hb = c.h_in, heads * c.h_in
    fwd = flops.bound_s(4 * c.K * c.D + F32_BYTES * c.R * h + 4 * c.D * hb
                        + 8 * c.D * heads + 4 * c.D * hb, 4 * c.V * hb)
    grad_x = not first
    bwd = flops.bound_s(4 * c.K * c.D + F32_BYTES * c.R * h + 4 * c.D * hb
                        + 8 * c.D * heads + 4 * c.D * hb + 4 * c.D * hb
                        + (4 * c.V * h if grad_x else 0),
                        (6 + (4 if grad_x else 0)) * c.V * hb)
    return fwd + bwd


def split_kernel_bounds(layers: list[LayerCounts], cfg: dict) -> dict:
    """A split step's query-key attention kernels' bound seconds."""
    heads = int(cfg["heads"])
    return {"qk_attention": sum(qk_attention_bound(c, heads, i == 0)
                                for i, c in enumerate(layers))}


def split_model(cfg: dict, dims: tuple, generator):
    from occ_gnn_tpu_torch.parallel.model import SplitUniMP

    return SplitUniMP(*dims, num_heads=int(cfg["heads"]),
                      generator=generator)


def dense_model(cfg: dict, dims: tuple, generator):
    raise ValueError("the port's quiver baseline trains SAGE only")
