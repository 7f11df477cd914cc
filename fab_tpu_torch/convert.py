"""Carry ``fab_tpu`` state into the port, from numpy leaves.

- ``from_jax_params``: ``fab_tpu``'s flow pytree ``{"base": ..., "layers": (...)}``
  -> a state dict for the port's Flow (``flow.load_state_dict(...)``);
  ``to_jax_params`` is its inverse (numpy leaves), used by checkpoints.
- ``transition_state_from_jax``: the HMC state (epsilons, common_epsilon, mass).
- ``buffer_state_from_jax``: a ``PrioritisedBufferState``.

Leaves may be numpy arrays or anything ``numpy.asarray`` accepts; every tensor is a
copy.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from fab_tpu_torch.buffer import PrioritisedBufferState


def _tensor(a, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def from_jax_params(tree: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """Flow state dict from ``fab_tpu``'s flow params: a diagonal-Gaussian base or a
    base without parameters (``UniformGaussianBase``), and AffineCoupling,
    SplineCoupling (an MLP each), LULinear, ActNorm and parameter-free
    (``PeriodicShift``) layers."""
    state = {f"base.{k}": _tensor(v, device) for k, v in tree["base"].items()}
    for i, layer in enumerate(tree["layers"]):
        prefix = f"bijectors.{i}."
        if not layer:
            continue
        if "mlp" in layer:
            for j, dense in enumerate(layer["mlp"]):
                state[f"{prefix}mlp.{j}.w"] = _tensor(dense["w"], device)
                state[f"{prefix}mlp.{j}.b"] = _tensor(dense["b"], device)
        elif "lower" in layer:
            for name in ("lower", "upper", "log_s", "sign_s"):
                state[prefix + name] = _tensor(layer[name], device)
        elif "shift" in layer:
            for name in ("shift", "log_scale"):
                state[prefix + name] = _tensor(layer[name], device)
        else:
            raise ValueError(f"layer {i}: unknown parameter keys {sorted(layer)}")
    return state


def to_jax_params(state: Mapping[str, torch.Tensor], n_layers: int = 0) -> Dict[str, Any]:
    """``fab_tpu``'s flow pytree, with numpy leaves, from a port Flow's state dict:
    ``{"base": {...}, "layers": ({"mlp": [{"w", "b"}, ...]} | {"lower", ...}, ...)}``.
    A layer without parameters has no key in the state dict: ``n_layers`` (the
    flow's bijector count) gives it its empty dict."""
    base, layers = {}, {}
    for name, value in state.items():
        leaf = value.detach().cpu().numpy()
        if name.startswith("base."):
            base[name[len("base."):]] = leaf
            continue
        m = re.fullmatch(r"bijectors\.(\d+)\.(?:mlp\.(\d+)\.)?(\w+)", name)
        if m is None:
            raise ValueError(f"unknown state-dict key {name!r}")
        layer = layers.setdefault(int(m.group(1)), {})
        if m.group(2) is None:
            layer[m.group(3)] = leaf
        else:
            layer.setdefault("mlp", {}).setdefault(int(m.group(2)), {})[m.group(3)] = leaf
    for layer in layers.values():
        if "mlp" in layer:
            layer["mlp"] = [layer["mlp"][j] for j in sorted(layer["mlp"])]
    n_layers = max([n_layers] + [i + 1 for i in layers])
    return {"base": base, "layers": tuple(layers.get(i, {}) for i in range(n_layers))}


def transition_state_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """HMC adaptation state: {"epsilons", "common_epsilon", "mass"}."""
    return {k: _tensor(tree[k], device) for k in ("epsilons", "common_epsilon", "mass")}


def buffer_state_from_jax(state, device=None) -> PrioritisedBufferState:
    """The JAX package's ``PrioritisedBufferState`` (``fab_tpu/buffer.py``) (or any 5-tuple in its order)."""
    x, log_w, log_q_old, cursor, n_added = state
    return PrioritisedBufferState(
        x=_tensor(x, device),
        log_w=_tensor(log_w, device),
        log_q_old=_tensor(log_q_old, device),
        cursor=_tensor(np.asarray(cursor, np.int32), device),
        n_added=_tensor(np.asarray(n_added, np.int32), device),
    )
