"""Shared helpers for the parity tests of the PyTorch port against fab_tpu.

Parameters and inputs are made with numpy from a seed and handed to both packages;
JAX's random draws are regenerated by replaying fab_tpu's key splits and fed to the
port through ``fab_tpu_torch.random``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import fab_tpu_torch.random as port_random
from fab_tpu.buffer import PrioritisedReplayBuffer as JaxBuffer
from fab_tpu.flows import make_realnvp as jax_make_realnvp
from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.sampling import HamiltonianMonteCarlo as JaxHMC
from fab_tpu.train import BufferTrainState as JaxBufferTrainState
from fab_tpu.train import PrioritisedBufferTrainer as JaxTrainer
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.convert import (
    buffer_state_from_jax,
    from_jax_params,
    transition_state_from_jax,
)
from fab_tpu_torch.flows import make_realnvp as port_make_realnvp
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.sampling import HamiltonianMonteCarlo
from fab_tpu_torch.train import BufferTrainState, PrioritisedBufferTrainer, make_optimizer

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


def make_flow_pair(dim, n_layers, nodes_per_dim, torch_dtype, seed=0, fused=False,
                   **flow_kw):
    """(jax flow, jax params as numpy, port flow with the same params) on the CPU.

    ``flow_kw`` (``scale_cap``, ``fused_coupling``) goes to both factories. Call
    under ``jax.enable_x64()`` for float64.
    """
    jax_flow = jax_make_realnvp(
        dim, n_flow_layers=n_layers, layer_nodes_per_dim=nodes_per_dim,
        act_norm=False, fused=fused, **flow_kw,
    )
    params = to_np(perturbed_jax_flow_params(jax_flow, seed, JAX_DTYPE[torch_dtype]))
    port_flow = port_make_realnvp(
        dim, n_flow_layers=n_layers, layer_nodes_per_dim=nodes_per_dim, fused=fused,
        dtype=torch_dtype, device="cpu", **flow_kw,
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


def ais_noise(key, n_dists: int, n_outer: int, batch: int, dim: int, dtype,
              uniform_base: bool = False):
    """All draws of one AIS pass with HMC, in the port's call order (ais.py:81,133).
    ``uniform_base``: the flow's base is a ``UniformGaussianBase``, which splits its
    key into a normal and a uniform draw."""
    key_init, key_chain = jax.random.split(key)
    noise = {
        "normal": [np.asarray(jax.random.normal(key_init, (batch, dim), dtype))],
        "exponential": [],
    }
    if uniform_base:
        key_g, key_u = jax.random.split(key_init)
        noise["normal"] = [np.asarray(jax.random.normal(key_g, (batch, dim), dtype))]
        noise["uniform"] = [np.asarray(jax.random.uniform(key_u, (batch, dim), dtype))]
    for key_d in jax.random.split(key_chain, n_dists):
        step = hmc_noise(key_d, n_outer, (batch, dim), dtype)
        noise["normal"] += step["normal"]
        noise["exponential"] += step["exponential"]
    return noise


def metropolis_ais_noise(key, n_dists: int, n_updates: int, batch: int, dim: int, dtype):
    """All draws of one AIS pass with Metropolis, in the port's call order: the flow
    draw, then per distribution and update a proposal (normal) and an acceptance
    uniform (ais.py, metropolis.py)."""
    key_init, key_chain = jax.random.split(key)
    noise = {"normal": [np.asarray(jax.random.normal(key_init, (batch, dim), dtype))],
             "uniform": []}
    for key_d in jax.random.split(key_chain, n_dists):
        for key_n in jax.random.split(key_d, n_updates):
            key_prop, key_acc = jax.random.split(key_n)
            noise["normal"].append(np.asarray(jax.random.normal(key_prop, (batch, dim), dtype)))
            noise["uniform"].append(np.asarray(jax.random.uniform(key_acc, (batch,), dtype)))
    return noise


class NoiseReplay:
    """Replaces the port's random draws with given arrays, in call order (kinds:
    normal, exponential, gumbel, uniform and randint)."""

    def __init__(self, monkeypatch, noise):
        self.queues = {k: list(v) for k, v in noise.items()}
        for kind in ("normal", "exponential", "gumbel", "uniform"):
            monkeypatch.setattr(port_random, kind, self._draw(kind))
        monkeypatch.setattr(port_random, "randint", self._randint)

    def _pop(self, kind, shape):
        value = self.queues[kind].pop(0)
        assert tuple(value.shape) == tuple(shape), (kind, value.shape, shape)
        return value

    def _draw(self, kind):
        def draw(generator, shape, dtype, device):
            del generator
            return torch.tensor(self._pop(kind, shape), dtype=dtype, device=device)

        return draw

    def _randint(self, generator, low, high, shape, device):
        del generator
        value = self._pop("randint", shape)
        assert ((value >= low) & (value < high)).all()
        return torch.tensor(value, dtype=torch.int64, device=device)

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


def assert_close_to_scale(actual, expected, tol, what=""):
    """|actual - expected| <= tol * max(max|expected|, 1): for float32 results whose
    rounding error grows with the largest value a sum runs through."""
    actual = np.asarray(actual.detach().cpu() if torch.is_tensor(actual) else actual)
    expected = np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1.0)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=tol * scale, err_msg=what)


def random_buffer_inputs(rng, n, dim):
    """(x, log_w, log_q, mask) of a buffer add, with dead and masked rows."""
    x = rng.standard_normal((n, dim))
    log_w = rng.standard_normal(n) * 3
    log_w[::7] = np.nan  # non-finite rows must become -inf priorities
    mask = rng.random(n) > 0.2
    return x, log_w, rng.standard_normal(n), mask


def assert_buffer(state, state_j, tol):
    for name, a, b in zip(state._fields, state, state_j):
        assert_close(a, b, tol, name)


def check_train_step(monkeypatch, flow_pair, targets, dim, batch, n_dists, n_batches,
                     hmc_kw, tol=1e-8, filters=None, trainer_kw=None,
                     with_replacement=False, optimizer_kw=None, uniform_base=False):
    """One full f64 PrioritisedBufferTrainer step of the port against fab_tpu's, on
    a shared buffer (192 rows, some dead) and shared noise: flow parameters, Adam
    state, HMC state, buffer and logged info agree to ``tol``.

    ``flow_pair`` is (jax flow, jax params, port flow); ``targets`` is (jax target,
    port target); ``filters`` an optional (jax, port) train-time sample filter;
    ``trainer_kw`` and ``optimizer_kw`` go to both trainers and both
    ``make_optimizer``s; ``with_replacement`` makes both buffers draw with
    replacement; ``uniform_base`` replays a ``UniformGaussianBase``'s draws. Returns
    (port info, port state, fab_tpu's info, fab_tpu's state).
    """
    jax_flow, params, flow = flow_pair
    target_j, target = targets
    trainer_kw = trainer_kw or {}
    optimizer_kw = optimizer_kw or {}
    rng = np.random.default_rng(9)
    with jax.enable_x64():
        model_j = JaxFABModel.create(
            jax_flow, target_j, transition_operator=JaxHMC(**hmc_kw),
            n_intermediate_distributions=n_dists,
        )
        if filters is not None:
            model_j = dataclasses.replace(model_j, sample_filter=filters[0])
        buf_j = JaxBuffer(dim=dim, max_length=512, min_sample_length=128,
                          sample_with_replacement=with_replacement)
        trainer_j = JaxTrainer(
            model_j, jax_make_optimizer(1e-2, 100.0, **optimizer_kw), buf_j,
            n_batches_buffer_sampling=n_batches, w_adjust_max_clip=10.0,
            dtype=jnp.float64, **trainer_kw,
        )
        buffer_j = buf_j.init(jnp.float64)
        for _ in range(3):
            x, lw, lq, m = random_buffer_inputs(rng, batch, dim)
            buffer_j = buf_j.add(buffer_j, x, lw, lq, m)
        trans_j = to_np(model_j.ais.transition_operator.init_state(dim, jnp.float64))
        state_j = JaxBufferTrainState(
            params={"flow": params, "transition": trans_j},
            opt_state=trainer_j.optimizer.init(params),
            buffer_state=buffer_j,
            step=jnp.zeros((), jnp.int32),
        )
        key = jax.random.key(5)
        key_ais, key_sample = jax.random.split(key)
        noise = ais_noise(key_ais, n_dists, 1, batch, dim, jnp.float64, uniform_base)
        gumbel_shape = (n_batches * batch, 512) if with_replacement else (512,)
        noise["gumbel"] = [np.asarray(jax.random.gumbel(key_sample, gumbel_shape,
                                                        jnp.float64))]
        new_j, info_j = to_np(jax.jit(trainer_j._train_step_fn(batch))(state_j, key))

    model = FABModel.create(
        flow, target, transition_operator=HamiltonianMonteCarlo(**hmc_kw),
        n_intermediate_distributions=n_dists,
    )
    if filters is not None:
        model = dataclasses.replace(model, sample_filter=filters[1])
    trainer = PrioritisedBufferTrainer(
        model, make_optimizer(1e-2, 100.0, **optimizer_kw),
        PrioritisedReplayBuffer(dim=dim, max_length=512, min_sample_length=128,
                                sample_with_replacement=with_replacement),
        n_batches_buffer_sampling=n_batches, w_adjust_max_clip=10.0,
        dtype=torch.float64, device="cpu", **trainer_kw,
    )
    state = BufferTrainState(
        transition_state=transition_state_from_jax(trans_j),
        opt_state=trainer.optimizer.init(trainer.params),
        buffer_state=buffer_state_from_jax(to_np(buffer_j)),
        step=0,
    )
    replay = NoiseReplay(monkeypatch, noise)
    new, info = trainer.train_step(state, None, batch)
    replay.assert_consumed()

    expected = from_jax_params(new_j.params["flow"])
    for name, value in flow.state_dict().items():
        assert_close(value, expected[name], tol, name)
    adam_j = new_j.opt_state[1][0]
    mu_j, nu_j = from_jax_params(adam_j.mu), from_jax_params(adam_j.nu)
    names = [n for n, p in flow.named_parameters() if p.requires_grad]
    assert int(new.opt_state.count) == int(adam_j.count)
    for name, mu, nu in zip(names, new.opt_state.mu, new.opt_state.nu):
        assert_close(mu, mu_j[name], tol, "mu " + name)
        assert_close(nu, nu_j[name], tol, "nu " + name)
    for k in ("epsilons", "common_epsilon", "mass"):
        assert_close(new.transition_state[k], new_j.params["transition"][k], tol, k)
    assert_buffer(new.buffer_state, new_j.buffer_state, tol)
    for k in ("loss", "grad_norm", "n_valid", "w_adjust_mean", "sampled_log_w_mean",
              "sampled_log_w_std", "ess_ais"):
        assert_close(info[k], info_j[k], tol, k)
    if filters is not None:
        assert_close(info["frac_filter_pass"], info_j["frac_filter_pass"], 0.0,
                     "frac_filter_pass")
    assert bool(info["update_applied"]) and bool(info_j["update_applied"])
    assert float(info["loss"]) != 0.0 and int(info["n_valid"]) > 0
    return info, new, info_j, new_j
