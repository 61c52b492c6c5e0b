"""GraphSAGE, mean aggregator: ``h = W [x_v, mean] + b`` a layer."""

from __future__ import annotations

from gnnbench import flops
from gnnbench.flops import LayerCounts

RELU_GAIN = 2.0 ** 0.5

# The form of the port's SAGE models, which the configuration states.
FORM = {"dropout": 0.0, "self_in_mean": True, "draws_with_replacement": True}


def widths(cfg: dict) -> list[tuple[int, int]]:
    """``(h_in, h_out)`` of each layer, innermost first."""
    n, hidden = int(cfg["num_layers"]), int(cfg["hidden"])
    ins = [int(cfg["feature_dim"])] + [hidden] * (n - 1)
    return list(zip(ins, [hidden] * (n - 1) + [int(cfg["num_classes"])]))


def param_shapes(cfg: dict) -> dict:
    """``{name: (shape, xavier gain or None for zeros)}``, the port's
    names and order: ``[2 h_in, h_out]`` matrices with the ReLU gain."""
    out = {}
    for i, (h_in, h_out) in enumerate(widths(cfg)):
        out[f"layer_{i}/w"] = ((2 * h_in, h_out), RELU_GAIN)
        out[f"layer_{i}/b"] = ((h_out,), None)
    return out


def output_leaf(cfg: dict) -> str:
    """The output layer's weights, which ``check.py``'s ``grad1_out_gap``
    reads."""
    return f"layer_{int(cfg['num_layers']) - 1}/w"


def layer_flops(c: LayerCounts, first: bool) -> float:
    """Mean aggregation and the projection of ``[self, mean]``, forward
    and backward; the first layer's frame takes no gradient."""
    agg = c.V * c.h_in + c.D * c.h_in
    proj = 2 * c.D * (2 * c.h_in) * c.h_out
    fwd = agg + proj + c.D * c.h_out
    bwd = proj + c.D * c.h_out + (0 if first else proj + agg)
    return fwd + bwd


def step_flops(layers: list[LayerCounts], cfg: dict) -> float:
    return sum(layer_flops(c, i == 0) for i, c in enumerate(layers))


def split_kernel_bounds(layers: list[LayerCounts], cfg: dict) -> dict:
    """A split step's dense aggregation kernels' bound seconds."""
    return {"dense_gather_sum": sum(flops.dense_gather_sum_bound(c, i == 0)
                                    for i, c in enumerate(layers))}


def split_model(cfg: dict, dims: tuple, generator):
    from occ_gnn_tpu_torch.parallel.model import SplitSAGE
    import torch

    return SplitSAGE(*dims, dtype=torch.float32, generator=generator)


def dense_model(cfg: dict, dims: tuple, generator):
    from occ_gnn_tpu_torch.models import get_model

    return get_model("sage", *dims, dropout=0.0, generator=generator)
