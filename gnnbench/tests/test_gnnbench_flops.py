"""The bytes and FLOPs formulas against hand counts on a tiny batch."""

from __future__ import annotations

import pytest

from gnnbench import flops
from gnnbench.flops import LayerCounts
from gnnbench.models import gat, sage

# A layer: 3 slot rows (fan-out 2 and the node), 4 dst rows, 10 filled
# slots, 6 distinct input rows, 5 input rows, widths 8 -> 2.
C = LayerCounts(K=3, D=4, V=10, R=6, S=5, h_in=8, h_out=2)


def test_dense_gather_sum_bound():
    fwd_bytes = 4 * 3 * 4 + 4 * 6 * 8 + 4 * 4 * 8   # nbr, rows, out
    bwd_bytes = 4 * 3 * 4 + 4 * 4 * 8 + 4 * 5 * 8   # nbr, grad, dx
    assert flops.dense_gather_sum_bound(C, True) == pytest.approx(
        max(fwd_bytes / flops.MEMORY_RATE, 80 / flops.F32_RATE))
    assert flops.dense_gather_sum_bound(C, False) == pytest.approx(
        fwd_bytes / flops.MEMORY_RATE + bwd_bytes / flops.MEMORY_RATE)


def test_gat_attention_bound():
    heads = 2
    hb = 16
    fwd_bytes = 48 + 4 * 6 * 8 + 4 * hb + 12 * 4 * heads + 4 * 4 * hb
    bwd_bytes = (48 + 4 * 6 * 8 + 4 * hb + 16 * 4 * heads + 4 * 4 * hb
                 + 4 * 10 * 8)
    fwd = max(fwd_bytes / flops.MEMORY_RATE, 4 * 10 * hb / flops.F32_RATE)
    bwd = max(bwd_bytes / flops.MEMORY_RATE, 10 * 10 * hb / flops.F32_RATE)
    assert flops.gat_attention_bound(C, heads, False) == pytest.approx(
        fwd + bwd)


def test_sampler_bounds():
    n, K = 5, 3
    draw = 4 * 5 + 4 * 15 + 4 * 20 + 8 * 5 + 4 * 4 * 3
    assert flops.draw_bound(n, K, 4) == pytest.approx(
        max(draw / flops.MEMORY_RATE, 15 / flops.F32_RATE))
    mean = 4 * 20 + 8 * 5 * 8 + 7 * 8 * 4
    assert flops.gather_mean_bound(n, K, 8, 7) == pytest.approx(
        max(mean / flops.MEMORY_RATE, 5 * 5 * 8 / flops.F32_RATE))


def test_step_flops():
    # SAGE, first layer: adds 10 * 8 + mean 4 * 8; projection
    # 2 * 4 * 16 * 2 forward and again for dW; bias 4 * 2 each way.
    first = 80 + 32 + 256 + 8 + 256 + 8
    assert sage.layer_flops(C, True) == first
    # above it, dX of the projection and of the aggregation too.
    assert sage.layer_flops(C, False) == first + 256 + 112
    assert sage.step_flops([C, C], {}) == 2 * first + 368
    # GAT, two heads: scores and sums 4 * 10 * 16, er 2 * 4 * 8 * 2,
    # projection 2 * 4 * 2 * 8 * 2, softmax 3 * 10 * 2; backward.
    fwd = 640 + 128 + 256 + 60
    bwd = 6 * 10 * 16 + 256 + 512 + 60
    assert gat.layer_flops(C, 2, True) == fwd + bwd
    assert gat.layer_flops(C, 2, False) == fwd + bwd + 640
    assert gat.step_flops([C, C], {"heads": 2}) == 2 * (fwd + bwd) + 640


def test_widths_and_weights():
    cfg = {"feature_dim": 100, "num_classes": 47, "hidden": 128,
           "num_layers": 3, "model": "gat", "heads": 4}
    assert gat.widths(cfg) == [(100, 128), (512, 128), (512, 47)]
    shapes = gat.param_shapes(cfg)
    assert shapes["layer_1/w"] == ((512, 512), 1.0)
    assert shapes["layer_2/attn_r"] == ((4, 47), 1.0)
    cfg.update(model="sage", hidden=256)
    assert sage.widths(cfg) == [(100, 256), (256, 256), (256, 47)]
    assert sage.param_shapes(cfg)["layer_0/w"][0] == (200, 256)
