"""Shared helpers for the parity tests of the PyTorch port against fab_tpu.

Parameters and inputs are made with numpy from a seed and handed to both packages;
JAX's random draws are regenerated by replaying fab_tpu's key splits and fed to the
port through ``fab_tpu_torch.random``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import fab_tpu_torch.random as port_random
from fab_tpu.flows import make_realnvp as jax_make_realnvp
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.flows import make_realnvp as port_make_realnvp

JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed_jax_flow_params(flow, seed: int, dtype, scale: float = 0.05):
    """fab_tpu flow params with every trainable leaf perturbed.

    The coupling's last layer is zero-initialised, so an unperturbed flow would hide
    a wrong first or second layer. ``sign_s`` stays a +-1 pattern.
    """
    rng = np.random.default_rng(seed)
    params = flow.init(jax.random.key(seed), dtype)

    def perturb(path, leaf):
        if any(getattr(p, "key", None) == "sign_s" for p in path):
            return leaf
        noise = scale * rng.standard_normal(leaf.shape)
        return leaf + jnp.asarray(noise, leaf.dtype)

    return jax.tree_util.tree_map_with_path(perturb, params)


def make_flow_pair(dim, n_layers, nodes_per_dim, torch_dtype, seed=0, fused=False):
    """(jax flow, jax params as numpy, port flow with the same params) on the CPU.

    Call under ``jax.enable_x64()`` for float64.
    """
    jax_flow = jax_make_realnvp(
        dim, n_flow_layers=n_layers, layer_nodes_per_dim=nodes_per_dim,
        act_norm=False, fused=fused,
    )
    params = to_np(perturbed_jax_flow_params(jax_flow, seed, JAX_DTYPE[torch_dtype]))
    port_flow = port_make_realnvp(
        dim, n_flow_layers=n_layers, layer_nodes_per_dim=nodes_per_dim, fused=fused,
        dtype=torch_dtype, device="cpu",
    )
    port_flow.load_state_dict(from_jax_params(params))
    return jax_flow, params, port_flow


def hmc_noise(key, n_outer: int, shape, dtype):
    """Momenta and exponential-race draws of one HMC transition (hmc.py:103-148)."""
    normals, exps = [], []
    for key_n in jax.random.split(key, n_outer):
        key_mom, key_acc = jax.random.split(key_n)
        normals.append(np.asarray(jax.random.normal(key_mom, shape, dtype)))
        exps.append(np.asarray(jax.random.exponential(key_acc, shape[:1], dtype)))
    return {"normal": normals, "exponential": exps}


def ais_noise(key, n_dists: int, n_outer: int, batch: int, dim: int, dtype):
    """All draws of one AIS pass with HMC, in the port's call order (ais.py:81,133)."""
    key_init, key_chain = jax.random.split(key)
    noise = {
        "normal": [np.asarray(jax.random.normal(key_init, (batch, dim), dtype))],
        "exponential": [],
    }
    for key_d in jax.random.split(key_chain, n_dists):
        step = hmc_noise(key_d, n_outer, (batch, dim), dtype)
        noise["normal"] += step["normal"]
        noise["exponential"] += step["exponential"]
    return noise


class NoiseReplay:
    """Replaces the port's random draws with given arrays, in call order."""

    def __init__(self, monkeypatch, noise):
        self.queues = {k: list(v) for k, v in noise.items()}
        for kind in ("normal", "exponential", "gumbel"):
            monkeypatch.setattr(port_random, kind, self._draw(kind))

    def _draw(self, kind):
        def draw(generator, shape, dtype, device):
            del generator
            value = self.queues[kind].pop(0)
            assert tuple(value.shape) == tuple(shape), (kind, value.shape, shape)
            return torch.tensor(value, dtype=dtype, device=device)

        return draw

    def assert_consumed(self):
        left = {k: len(v) for k, v in self.queues.items() if v}
        assert not left, f"unused replayed draws: {left}"


def assert_close(actual, expected, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(actual.detach().cpu() if torch.is_tensor(actual) else actual),
        np.asarray(expected),
        rtol=tol,
        atol=tol,
        err_msg=what,
    )
