"""Carry ``fab_tpu`` state into the port, from numpy leaves.

- ``from_jax_params``: ``fab_tpu``'s flow pytree ``{"base": ..., "layers": (...)}``
  (or a defensive mixture's) -> a state dict for the port's flow
  (``flow.load_state_dict(...)``); ``to_jax_params`` is its inverse (numpy leaves),
  used by checkpoints.
- ``transition_state_from_jax``: the HMC state (epsilons, common_epsilon, mass).
- ``buffer_state_from_jax``: a ``PrioritisedBufferState``.

Leaves may be numpy arrays or anything ``numpy.asarray`` accepts; every tensor is a
copy. The ``fab_tpu`` side is always whole: given a ``flow`` whose conditioners are
split over a model axis (``parallel/tensor.py``), ``from_jax_params`` cuts the split
entries to this rank's shards and ``to_jax_params`` gathers them whole (a
collective: every rank of the model group calls it).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from fab_tpu_torch.buffer import PrioritisedBufferState


def _tensor(a, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def _mlp_state(prefix: str, mlp, device) -> Dict[str, torch.Tensor]:
    state = {}
    for j, dense in enumerate(mlp):
        state[f"{prefix}{j}.w"] = _tensor(dense["w"], device)
        state[f"{prefix}{j}.b"] = _tensor(dense["b"], device)
    return state


def from_jax_params(tree: Dict[str, Any], device=None, flow=None) -> Dict[str, torch.Tensor]:
    """State dict from ``fab_tpu``'s params of a flow or a ``DefensiveMixture``
    (``{"flow", "defensive": {loc, log_scale}, "mixture_logit"}``). A flow's base is
    a diagonal Gaussian, parameter-free (``UniformGaussianBase``) or the LARS base
    (``{"accept_net": [{w, b}, ...], "z_points"}``); its layers are AffineCoupling,
    SplineCoupling and MaskedAffineAutoregressive (an MLP each), LULinear, ActNorm,
    or parameter-free (``PeriodicShift``, ``Permutation``, an SNF's MH layers).
    ``flow``: cut to its shards, if it is split over a model axis."""
    if flow is not None:
        from fab_tpu_torch.parallel.tensor import cut_state

        return cut_state(flow, from_jax_params(tree, device))
    if "mixture_logit" in tree:
        state = {f"flow.{k}": v for k, v in from_jax_params(tree["flow"], device).items()}
        for k, v in tree["defensive"].items():
            state[f"defensive.{k}"] = _tensor(v, device)
        state["mixture_logit"] = _tensor(tree["mixture_logit"], device)
        return state
    state = {}
    for k, v in tree["base"].items():
        if k == "accept_net":
            state.update(_mlp_state("base.accept_net.", v, device))
        else:
            state[f"base.{k}"] = _tensor(v, device)
    for i, layer in enumerate(tree["layers"]):
        prefix = f"bijectors.{i}."
        if not layer:
            continue
        if "mlp" in layer:
            state.update(_mlp_state(prefix + "mlp.", layer["mlp"], device))
        elif "lower" in layer:
            for name in ("lower", "upper", "log_s", "sign_s"):
                state[prefix + name] = _tensor(layer[name], device)
        elif "shift" in layer:
            for name in ("shift", "log_scale"):
                state[prefix + name] = _tensor(layer[name], device)
        else:
            raise ValueError(f"layer {i}: unknown parameter keys {sorted(layer)}")
    return state


def _mlp_list(layers: Dict[int, Dict[str, Any]]):
    return [layers[j] for j in sorted(layers)]


def to_jax_params(state: Mapping[str, torch.Tensor], n_layers: int = 0,
                  flow=None) -> Dict[str, Any]:
    """``fab_tpu``'s params, with numpy leaves, from a port Flow's (or
    ``DefensiveMixture``'s) state dict: ``{"base": {...}, "layers": ({"mlp": [{"w",
    "b"}, ...]} | {"lower", ...}, ...)}``. A layer without parameters has no key in
    the state dict: ``n_layers`` (the flow's bijector count) gives it its empty
    dict. ``flow``: the flow ``state`` is of, whose split entries are gathered whole."""
    if flow is not None:
        from fab_tpu_torch.parallel.tensor import gather_state

        state = gather_state(flow, state)
    if "mixture_logit" in state:
        flow = {k[len("flow."):]: v for k, v in state.items() if k.startswith("flow.")}
        return {
            "flow": to_jax_params(flow, n_layers),
            "defensive": {k[len("defensive."):]: v.detach().cpu().numpy()
                          for k, v in state.items() if k.startswith("defensive.")},
            "mixture_logit": state["mixture_logit"].detach().cpu().numpy(),
        }
    base, layers = {}, {}
    for name, value in state.items():
        leaf = value.detach().cpu().numpy()
        m = re.fullmatch(r"base\.(?:accept_net\.(\d+)\.)?(\w+)", name)
        if m is not None:
            if m.group(1) is None:
                base[m.group(2)] = leaf
            else:
                base.setdefault("accept_net", {}).setdefault(int(m.group(1)), {})[m.group(2)] = leaf
            continue
        m = re.fullmatch(r"bijectors\.(\d+)\.(?:mlp\.(\d+)\.)?(\w+)", name)
        if m is None:
            raise ValueError(f"unknown state-dict key {name!r}")
        layer = layers.setdefault(int(m.group(1)), {})
        if m.group(2) is None:
            layer[m.group(3)] = leaf
        else:
            layer.setdefault("mlp", {}).setdefault(int(m.group(2)), {})[m.group(3)] = leaf
    if "accept_net" in base:
        base["accept_net"] = _mlp_list(base["accept_net"])
    for layer in layers.values():
        if "mlp" in layer:
            layer["mlp"] = _mlp_list(layer["mlp"])
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
