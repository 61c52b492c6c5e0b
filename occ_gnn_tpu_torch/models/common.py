"""Shared model utilities: init, linear map, masked loss and accuracy,
dropout. The JAX package's ``models/common.py`` in torch."""

from __future__ import annotations

import torch

RELU_GAIN = 2.0 ** 0.5


def xavier_uniform(generator: torch.Generator | None, shape,
                   gain: float = 1.0) -> torch.Tensor:
    """Xavier/Glorot uniform, ``nn.init.xavier_uniform_`` for an ``[in, out]``
    matrix, drawn from ``generator`` on the CPU."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = gain * (6.0 / (fan_in + fan_out)) ** 0.5
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def linear_init(generator: torch.Generator | None, in_dim: int, out_dim: int,
                gain: float = RELU_GAIN) -> dict:
    """``{"w": [in, out], "b": [out]}``: Xavier weights with the ReLU gain
    (the reference's SAGE conv init), zero bias."""
    return {
        "w": xavier_uniform(generator, (in_dim, out_dim), gain=gain),
        "b": torch.zeros(out_dim),
    }


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def masked_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over rows whose label != -1 (padding rows masked).

    Written out, not ``F.cross_entropy(ignore_index=-1)``: that gives NaN
    when every label is padding, where this divides by ``max(count, 1)``
    and gives 0, as the JAX loss does."""
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = valid.sum().clamp(min=1)
    return nll.sum() / count


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    """(correct, total) over rows whose label != -1, as int64 tensors."""
    valid = labels >= 0
    pred = logits.argmax(dim=-1)
    correct = ((pred == labels) & valid).sum()
    return correct, valid.sum()


def zero_missing_grads(params) -> None:
    """Give each parameter the loss did not read (GAT's last-layer bias) a
    zero gradient, as ``jax.grad`` does, so that Adam counts the step for
    it as optax does (``torch.optim.Adam`` skips a ``None`` gradient)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (a generator
    on ``x``'s device). Masks cannot match JAX's, so parity runs at 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
