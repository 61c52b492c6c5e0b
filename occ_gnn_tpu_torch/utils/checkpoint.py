"""Checkpoints in the JAX package's ``.npz`` layout, readable by both packages.

A JAX checkpoint (``occ_gnn_tpu/utils/checkpoint.py``) is a flat ``.npz``
keyed by tree paths: ``params/layer_{i}/w`` and ``params/layer_{i}/b`` hold
the plain ``[in, out]`` weights and biases, ``opt/...`` the optax state and
``meta/epoch`` the epoch. The port's models register the same weights as
``layer_{i}/w`` and ``layer_{i}/b``, so the weights only change key.

optax's Adam state is ``(ScaleByAdamState(count, mu, nu), EmptyState())``,
saved as ``opt/0/.count`` (int32, the number of updates), ``opt/0/.mu/
layer_{i}/w`` and ``opt/0/.nu/...`` (one tree like the weights). It maps
to ``torch.optim.Adam``'s per-parameter state: ``step`` = count,
``exp_avg`` = mu, ``exp_avg_sq`` = nu; the two updates are the same
arithmetic. (``jax.random`` and ``torch.Generator`` draw different
numbers, so a checkpoint is also how both packages get the same weights.)
"""

from __future__ import annotations

import os

import numpy as np
import torch

_PREFIX = "params/"
_COUNT = "opt/0/.count"
_MU = "opt/0/.mu/"
_NU = "opt/0/.nu/"


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


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Adam, epoch: int) -> str:
    """Write ``model``'s weights, ``optimizer``'s Adam state and ``epoch``
    to ``path`` in the JAX layout (through a temporary file, so a reader
    never sees half a checkpoint). Returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {}
    count = 0
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        value = p.detach().cpu().numpy()
        payload[_PREFIX + name] = value
        if state:
            count = int(state["step"])
            payload[_MU + name] = state["exp_avg"].detach().cpu().numpy()
            payload[_NU + name] = state["exp_avg_sq"].detach().cpu().numpy()
        else:
            payload[_MU + name] = np.zeros_like(value)
            payload[_NU + name] = np.zeros_like(value)
    payload[_COUNT] = np.asarray(count, dtype=np.int32)
    payload["meta/epoch"] = np.asarray(epoch, dtype=np.int64)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Adam | None = None) -> int:
    """Load a checkpoint of either package into ``model`` and, when given,
    ``optimizer``'s Adam state (shapes and keys must match exactly).
    Returns the checkpoint's epoch."""
    with np.load(path, allow_pickle=False) as data:
        model.load_state_dict(params_from_jax(data), strict=True)
        epoch = int(data["meta/epoch"])
        if optimizer is not None:
            count = int(data[_COUNT])
            for name, p in model.named_parameters():
                mu, nu = data[_MU + name], data[_NU + name]
                if mu.shape != tuple(p.shape) or nu.shape != tuple(p.shape):
                    raise ValueError(f"checkpoint Adam state for {name} has "
                                     f"shape {mu.shape}, the model "
                                     f"{tuple(p.shape)}")
                optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": torch.tensor(mu, dtype=p.dtype,
                                            device=p.device),
                    "exp_avg_sq": torch.tensor(nu, dtype=p.dtype,
                                               device=p.device),
                }
    return epoch
