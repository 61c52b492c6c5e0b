"""Weights carried across from the JAX package.

A JAX checkpoint is a flat ``.npz`` keyed by tree paths: ``params/layer_{i}/w``
and ``params/layer_{i}/b`` hold the plain ``[in, out]`` weights and biases,
``opt/...`` the optax state and ``meta/epoch`` the epoch. The port's models
register the same weights as ``layer_{i}/w`` and ``layer_{i}/b``, so the
conversion only renames keys. (``jax.random`` and ``torch.Generator`` draw
different numbers, so this is how both packages get the same weights.)
"""

from __future__ import annotations

import numpy as np
import torch

_PREFIX = "params/"


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """A port model's state from JAX weights: either the ``{layer_i: {w, b}}``
    parameter pytree (leaves as numpy or JAX arrays) or the mapping of a
    JAX ``.npz`` checkpoint with its ``params/layer_i/w`` keys."""
    state = {}
    for key in params.keys():
        value = params[key]
        if hasattr(value, "keys"):
            for name in value.keys():
                state[f"{key}/{name}"] = _tensor(value[name])
        elif key.startswith(_PREFIX):
            state[key[len(_PREFIX):]] = _tensor(value)
    if not state:
        raise ValueError("no JAX parameters found: expected a {layer_i: "
                         "{w, b}} pytree or params/... checkpoint keys")
    return state


def _tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def load_jax_checkpoint(path: str, model: torch.nn.Module) -> int:
    """Load the weights of a JAX ``.npz`` checkpoint into ``model`` (shapes
    and keys must match exactly) and return the checkpoint's epoch."""
    with np.load(path, allow_pickle=False) as data:
        state = params_from_jax(data)
        epoch = int(data["meta/epoch"])
    model.load_state_dict(state, strict=True)
    return epoch
