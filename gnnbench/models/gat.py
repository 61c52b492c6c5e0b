"""GAT: heads concatenated with a bias on hidden layers, averaged on the
last."""

from __future__ import annotations

from gnnbench import flops
from gnnbench.flops import LayerCounts

# The form of the port's split GAT, which the configuration states.
FORM = {"dropout": 0.0, "skip_projection": False, "last_layer_bias": False,
        "draws_with_replacement": True}


def widths(cfg: dict) -> list[tuple[int, int]]:
    """``(h_in, h_out)`` of each layer, innermost first; ``h_out`` is a
    head's width."""
    n, hidden, k = (int(cfg["num_layers"]), int(cfg["hidden"]),
                    int(cfg["heads"]))
    ins = [int(cfg["feature_dim"])] + [hidden * k] * (n - 1)
    return list(zip(ins, [hidden] * (n - 1) + [int(cfg["num_classes"])]))


def param_shapes(cfg: dict) -> dict:
    """``{name: (shape, xavier gain or None for zeros)}``, the port's
    names and order."""
    k = int(cfg["heads"])
    out = {}
    for i, (h_in, h_out) in enumerate(widths(cfg)):
        out[f"layer_{i}/w"] = ((h_in, k * h_out), 1.0)
        out[f"layer_{i}/attn_l"] = ((k, h_out), 1.0)
        out[f"layer_{i}/attn_r"] = ((k, h_out), 1.0)
        out[f"layer_{i}/b"] = ((k * h_out,), None)
    return out


def output_leaf(cfg: dict) -> str:
    """The output layer's weights, which ``check.py``'s ``grad1_out_gap``
    reads."""
    return f"layer_{int(cfg['num_layers']) - 1}/w"


def layer_flops(c: LayerCounts, heads: int, first: bool) -> float:
    """The port's GAT form: scores and the weighted sum of each filled
    slot's row per head (the attention kernels' operations), the dst's
    score term, and the per-head projection of the sums, forward and
    backward; the first layer's frame takes no gradient."""
    hb = heads * c.h_in
    er = 2 * c.D * c.h_in * heads
    proj = 2 * c.D * heads * c.h_in * c.h_out
    softmax = 3 * c.V * heads
    fwd = 4 * c.V * hb + er + proj + softmax
    bwd = ((6 + (0 if first else 4)) * c.V * hb + 2 * er + 2 * proj
           + softmax)
    return fwd + bwd


def step_flops(layers: list[LayerCounts], cfg: dict) -> float:
    heads = int(cfg["heads"])
    return sum(layer_flops(c, heads, i == 0) for i, c in enumerate(layers))


def split_kernel_bounds(layers: list[LayerCounts], cfg: dict) -> dict:
    """A split step's attention kernels' bound seconds."""
    heads = int(cfg["heads"])
    return {"gat_attention": sum(flops.gat_attention_bound(c, heads, i == 0)
                                 for i, c in enumerate(layers))}


def split_model(cfg: dict, dims: tuple, generator):
    from occ_gnn_tpu_torch.parallel.model import SplitGAT

    return SplitGAT(*dims, num_heads=int(cfg["heads"]), generator=generator)


def dense_model(cfg: dict, dims: tuple, generator):
    raise ValueError("the port's quiver baseline trains SAGE only")
