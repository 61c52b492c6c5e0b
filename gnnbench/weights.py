"""The model's initial weights, made from the seed on the device in one
draw, in the layout of ``models/<model>.py`` (the port's parameter
names): Xavier-uniform matrices and vectors, zero biases, as the port
initialises them. Both the port's model and the reference are given
these."""

from __future__ import annotations

import torch

from gnnbench import models


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """f32 weights on ``device`` from ``seed`` (a 63-bit sub-seed)."""
    spec = models.load(cfg).param_shapes(cfg)
    total = sum(int(torch.Size(s).numel()) for s, g in spec.values()
                if g is not None)
    gen = torch.Generator(device).manual_seed(seed)
    draw = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, (shape, gain) in spec.items():
        if gain is None:
            out[name] = torch.zeros(shape, device=device)
            continue
        size = int(torch.Size(shape).numel())
        limit = gain * (6.0 / (shape[-2] + shape[-1])) ** 0.5
        out[name] = (draw[at:at + size] * limit).view(shape)
        at += size
    return out
