"""What the drivers share: the port's weights loaded from the
benchmark's, and the first steps' readings."""

from __future__ import annotations

import torch

BETA1 = 0.9  # torch.optim.Adam's default, which the port uses


def load_weights(model: torch.nn.Module, weights: dict) -> None:
    """Give the port's model the benchmark's weights, by the port's
    parameter names."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the port's parameters {sorted(params)} are not "
                         f"the benchmark's {sorted(weights)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name].to(p.device, p.dtype))


def first_moment_grad(model: torch.nn.Module, optimizer) -> dict | None:
    """The gradient as Adam got it at its first step: its first moment over
    ``1 - beta1`` (the moment starts at zero). None when the optimizer
    kept no state."""
    out = {}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        if "exp_avg" not in state:
            return None
        out[name] = (state["exp_avg"].detach() / (1 - BETA1)).cpu()
    return out


def weights_now(model: torch.nn.Module) -> dict:
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def bitmap_count(ids: torch.Tensor, size: int) -> torch.Tensor:
    """Distinct values of ``ids`` in ``[0, size)``, on the device."""
    seen = torch.zeros(size, dtype=torch.bool, device=ids.device)
    seen[ids.reshape(-1).long()] = True
    return seen.sum()
