"""Shared helpers for the parity tests of the PyTorch port against fab_tpu.

Parameters and inputs are made with numpy from a seed and handed to both packages;
JAX's random draws are regenerated by replaying fab_tpu's key splits and fed to the
port through ``fab_tpu_torch.random``.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def _extend(noise, more):
    for kind, values in more.items():
        noise.setdefault(kind, []).extend(values)
    return noise


def mh_layer_noise(key, n_steps: int, shape, dtype):
    """The draws of one SNF Metropolis layer run (snf.py ``_mcmc``): per step a
    proposal normal [B, D], then an acceptance uniform [B]."""
    noise = {"normal": [], "uniform": []}
    for key_t in jax.random.split(key, n_steps):
        key_prop, key_acc = jax.random.split(key_t)
        noise["normal"].append(np.asarray(jax.random.normal(key_prop, shape, dtype)))
        noise["uniform"].append(np.asarray(jax.random.uniform(key_acc, shape[:-1], dtype)))
    return noise


def snf_log_prob_noise(flow, key, shape, dtype):
    """The draws of a ``StochasticFlow.log_prob(params, x, key)`` on x of ``shape``, in
    the port's order: the MH layers in reverse, each on ``fold_in(key, i)`` with i
    its index in the reversed chain."""
    noise = {"normal": [], "uniform": []}
    for i, layer in enumerate(reversed(flow.layers)):
        if getattr(layer, "is_stochastic", False):
            _extend(noise, mh_layer_noise(jax.random.fold_in(key, i), layer.n_steps, shape,
                                          dtype))
    return noise


def base_sample_noise(base, key, n: int, dim: int, dtype):
    """The draws of a fab_tpu base's ``sample_and_log_prob(params, key, n)``: a
    diagonal Gaussian's normal; a ``UniformGaussianBase``'s normal and uniform; the
    LARS base's initial proposal (in JAX's default float, as fab_tpu draws it) and
    its T-1 rounds of (proposal, uniform)."""
    from fab_tpu.flows import ResampledGaussianBase, UniformGaussianBase

    if isinstance(base, UniformGaussianBase):
        key_g, key_u = jax.random.split(key)
        return {"normal": [np.asarray(jax.random.normal(key_g, (n, dim), dtype))],
                "uniform": [np.asarray(jax.random.uniform(key_u, (n, dim), dtype))]}
    if isinstance(base, ResampledGaussianBase):
        key_init, key_scan = jax.random.split(key)
        z0 = jax.random.normal(key_init, (n, dim))
        z_dtype = jnp.promote_types(z0.dtype, dtype)
        noise = {"normal": [np.asarray(z0)], "uniform": []}
        for key_t in jax.random.split(key_scan, base.T - 1):
            key_prop, key_u = jax.random.split(key_t)
            noise["normal"].append(np.asarray(jax.random.normal(key_prop, (n, dim), z0.dtype)))
            noise["uniform"].append(np.asarray(jax.random.uniform(key_u, (n,), z_dtype)))
        return noise
    return {"normal": [np.asarray(jax.random.normal(key, (n, dim), dtype))]}


def flow_sample_noise(flow, key, n: int, dim: int, dtype):
    """The draws of a fab_tpu flow's ``sample_and_log_prob(params, key, n)`` in the
    port's order: the base, then (a ``StochasticFlow``) each MH layer in forward
    order on ``fold_in(key_layers, i)``."""
    if not getattr(flow, "is_stochastic", False):
        return base_sample_noise(flow.base, key, n, dim, dtype)
    key_base, key_layers = jax.random.split(key)
    noise = base_sample_noise(flow.base, key_base, n, dim, dtype)
    for i, layer in enumerate(flow.layers):
        if getattr(layer, "is_stochastic", False):
            _extend(noise, mh_layer_noise(jax.random.fold_in(key_layers, i), layer.n_steps,
                                          (n, dim), dtype))
    return noise


def ais_noise(key, n_dists: int, n_outer: int, batch: int, dim: int, dtype, flow=None):
    """All draws of one AIS pass with HMC, in the port's call order (ais.py:81,133).
    ``flow``: the fab_tpu flow, whose ``flow_sample_noise`` makes the first draw (any
    base, SNF layers); without it, the draw of a diagonal-Gaussian base."""
    key_init, key_chain = jax.random.split(key)
    if flow is None:
        noise = {"normal": [np.asarray(jax.random.normal(key_init, (batch, dim), dtype))]}
    else:
        noise = flow_sample_noise(flow, key_init, batch, dim, dtype)
    noise["exponential"] = []
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
    normal, exponential, gumbel, uniform and randint).

    ``keys``: the draws of each log-q key (``random.split``), in the order the port
    splits them. Every ``random.restart`` of a key replays that key's draws from
    the start; a split past the last key fails, so a log-q call that split a key of
    its own would fail here."""

    def __init__(self, monkeypatch, noise, keys=()):
        self.queues = {k: list(v) for k, v in noise.items()}
        self.keys = list(keys)
        self.cursors = []
        for kind in ("normal", "exponential", "gumbel", "uniform"):
            monkeypatch.setattr(port_random, kind, self._draw(kind))
        monkeypatch.setattr(port_random, "randint", self._randint)
        monkeypatch.setattr(port_random, "split", self._split)
        monkeypatch.setattr(port_random, "restart", self._restart)

    def _split(self, generator):
        assert self.keys, "a log-q key was split past the replayed ones"
        return _ReplayKey(self.keys.pop(0))

    def _restart(self, key):
        assert isinstance(key, _ReplayKey), key
        cursor = _Cursor({k: list(v) for k, v in key.noise.items()})
        self.cursors.append(cursor)
        return cursor

    def _pop(self, kind, shape, generator=None):
        queues = generator.queues if isinstance(generator, _Cursor) else self.queues
        value = queues[kind].pop(0)
        assert tuple(value.shape) == tuple(shape), (kind, value.shape, shape)
        return value

    def _draw(self, kind):
        def draw(generator, shape, dtype, device):
            return torch.tensor(self._pop(kind, shape, generator), dtype=dtype, device=device)

        return draw

    def _randint(self, generator, low, high, shape, device):
        del generator
        value = self._pop("randint", shape)
        assert ((value >= low) & (value < high)).all()
        return torch.tensor(value, dtype=torch.int64, device=device)

    def assert_consumed(self):
        left = {k: len(v) for k, v in self.queues.items() if v}
        assert not left, f"unused replayed draws: {left}"
        assert not self.keys, f"{len(self.keys)} replayed log-q keys never split"
        for cursor in self.cursors:
            left = {k: len(v) for k, v in cursor.queues.items() if v}
            assert not left, f"a log-q call left draws of its key: {left}"


class _ReplayKey:
    def __init__(self, noise):
        self.noise = noise


class _Cursor:
    def __init__(self, queues):
        self.queues = queues


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
                     with_replacement=False, optimizer_kw=None, n_steps=1, lr=1e-2,
                     compiled=None):
    """One full f64 PrioritisedBufferTrainer step of the port against fab_tpu's, on
    a shared buffer (192 rows, some dead) and shared noise: flow parameters, Adam
    state, HMC state, buffer and logged info agree to ``tol``.

    With ``n_steps`` > 1, that many consecutive steps, each on its own shared noise
    (step k's key is ``fold_in(key(5), k)``, step 0's ``key(5)``): after every step
    ``n_valid`` is equal and the flow parameters and logged info agree to ``tol``;
    the rest is compared after the last.

    ``flow_pair`` is (jax flow, jax params, port flow); ``targets`` is (jax target,
    port target); ``filters`` an optional (jax, port) train-time sample filter;
    ``trainer_kw`` and ``optimizer_kw`` go to both trainers and both
    ``make_optimizer``s (with ``lr``); ``with_replacement`` makes both buffers draw with
    replacement. The flow's draws (any base, an SNF's layers) are replayed from the
    fab_tpu flow, and so are an SNF's log-q keys, one per AIS pass and per replay
    batch. Returns the last step's
    (port info, port state, fab_tpu's info, fab_tpu's state).

    ``compiled``: ``"step"`` takes the port's steps through ``make_train_step``;
    ``"scanned"`` takes all ``n_steps`` in one ``make_scanned_train_step`` call
    against ``fab_tpu``'s (its ``lax.scan`` over ``split(key(5), n_steps)``, whose
    keys then make each step's noise), and compares after the last only.
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
            model_j, jax_make_optimizer(lr, 100.0, **optimizer_kw), buf_j,
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
        step_j = jax.jit(trainer_j._train_step_fn(batch))
        steps_j = []  # (noise, log-q keys, fab_tpu's new state, its info) per step
        scanned = compiled == "scanned"
        for k in range(n_steps):
            key = jax.random.key(5) if k == 0 else jax.random.fold_in(jax.random.key(5), k)
            if scanned:
                key = jax.random.split(jax.random.key(5), n_steps)[k]
            key_ais, key_sample = jax.random.split(key)
            noise = ais_noise(key_ais, n_dists, 1, batch, dim, jnp.float64, flow=jax_flow)
            keys = []
            if getattr(jax_flow, "is_stochastic", False):
                # One log-q key per AIS pass (fold_in 0x10C9) and per replay batch.
                keys = [snf_log_prob_noise(jax_flow, kk, (batch, dim), jnp.float64) for kk in (
                    [jax.random.fold_in(key_ais, 0x10C9)]
                    + list(jax.random.split(jax.random.fold_in(key, 0x11A7), n_batches)))]
            gumbel_shape = (n_batches * batch, 512) if with_replacement else (512,)
            noise["gumbel"] = [np.asarray(jax.random.gumbel(key_sample, gumbel_shape,
                                                            jnp.float64))]
            if scanned:
                steps_j.append((noise, keys))
                continue
            state_j = step_j(state_j, key)
            steps_j.append((noise, keys, *to_np(state_j)))
            state_j = state_j[0]
        if scanned:
            merged = {}
            for noise, _ in steps_j:
                for kind, values in noise.items():
                    merged.setdefault(kind, []).extend(values)
            steps_j = [(merged, [k for _, keys in steps_j for k in keys], *to_np(
                trainer_j.make_scanned_train_step(batch, n_steps)(state_j, jax.random.key(5))))]

    model = FABModel.create(
        flow, target, transition_operator=HamiltonianMonteCarlo(**hmc_kw),
        n_intermediate_distributions=n_dists,
    )
    if filters is not None:
        model = dataclasses.replace(model, sample_filter=filters[1])
    trainer = PrioritisedBufferTrainer(
        model, make_optimizer(lr, 100.0, **optimizer_kw),
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
    take = lambda s: trainer.train_step(s, None, batch)
    if compiled == "step":
        take = lambda s: trainer.make_train_step(batch)(s, None)
    elif compiled == "scanned":
        take = lambda s: trainer.make_scanned_train_step(batch, n_steps)(s, None)
    for k, (noise, keys, new_j, info_j) in enumerate(steps_j):
        replay = NoiseReplay(monkeypatch, noise, keys)
        new, info = take(state)
        replay.assert_consumed()
        state = new
        assert int(info["n_valid"]) == int(info_j["n_valid"]), f"step {k + 1}: n_valid"
        expected = from_jax_params(new_j.params["flow"])
        for name, value in flow.state_dict().items():
            assert_close(value, expected[name], tol, f"step {k + 1}: {name}")
        for key in ("loss", "grad_norm", "ess_ais"):
            assert_close(info[key], info_j[key], tol, f"step {k + 1}: {key}")
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a test module's torch work (import this name into the
    module to use it): the suite runs six workers on the machine's cores, and
    OpenMP threads that outnumber the cores wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trained_state_steps(path: str, n_steps: int = 5, batch: int = 128, overrides=()) -> dict:
    """The flow and transition state of a GMM-40 fab_no_buffer checkpoint (gmm.yaml,
    f64) in both packages' ``Trainer`` with a fresh Adam state (fab_tpu resumes no
    port optimizer state: the port keys Adam's moments by parameter name), then
    ``n_steps`` steps of each on shared noise (step k on ``key(1000 + k)``): the
    largest relative difference of the flow's parameters after each step, and each
    step's ``n_valid`` and loss in both. ``overrides``: the run's gmm.yaml overrides
    (its widths). For a state that only a long run reaches, run it by hand on that
    run's checkpoint:

        JAX_PLATFORMS=cpu python3 -c "import sys; sys.path[:0] = ['tests', '.'];
            import torch_parity_utils as u; print(u.trained_state_steps('PATH'))"
    """
    from experiments.setup_run import setup_model as jax_setup_model
    from fab_tpu.targets import GMM as JaxGMM
    from fab_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
    from fab_tpu.train import Trainer as JaxPlainTrainer
    from fab_tpu.train import TrainState as JaxTrainState
    from fab_tpu_torch.experiments.setup_run import setup_model
    from fab_tpu_torch.targets import GMM
    from fab_tpu_torch.train import Trainer
    from fab_tpu_torch.utils.training import apply_overrides, load_config

    config = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "configs" / "gmm.yaml"
    cfg = apply_overrides(load_config(str(config)),
                          ["fab.loss_type=fab_alpha_div", "training.use_buffer=false",
                           *overrides])
    kw = dict(dim=2, n_mixes=40, loc_scaling=40.0, log_var_scaling=1.0,
              true_expectation_estimation_n_samples=1000)
    out = {"param_rel_diff": [], "n_valid": [], "loss": []}
    with jax.enable_x64():
        trainer_j = JaxPlainTrainer(jax_setup_model(cfg, JaxGMM(**kw, dtype=jnp.float64)),
                                    jax_make_optimizer(1e-4, 100.0), dtype=jnp.float64)
        params = jax_load_checkpoint(path)["params"]
        state_j = JaxTrainState(params, trainer_j.optimizer.init(params["flow"]),
                                jnp.zeros((), jnp.int32))
        step_j = jax.jit(trainer_j._train_step_fn(batch))
    trainer = Trainer(setup_model(cfg, GMM(**kw, dtype=torch.float64, device="cpu"),
                                  torch.float64, "cpu"),
                      make_optimizer(1e-4, 100.0), dtype=torch.float64, device="cpu")
    state, _ = trainer.load_state(path)
    state = state._replace(opt_state=trainer.optimizer.init(trainer.params), step=0)
    for k in range(n_steps):
        key = jax.random.key(1000 + k)
        with jax.enable_x64():
            state_j, info_j = step_j(state_j, key)
            noise = metropolis_ais_noise(key, 1, 1, batch, 2, jnp.float64)
        with pytest.MonkeyPatch.context() as mp:
            replay = NoiseReplay(mp, noise)
            state, info = trainer.train_step(state, None, batch)
            replay.assert_consumed()
        want = from_jax_params(to_np(state_j.params["flow"]))
        out["param_rel_diff"].append(max(
            float((v - torch.as_tensor(want[n])).abs().max()
                  / torch.as_tensor(want[n]).abs().max().clamp(min=1e-300))
            for n, v in trainer.model.flow.state_dict().items()))
        out["n_valid"].append((int(info["n_valid"]), int(info_j["n_valid"])))
        out["loss"].append((float(info["loss"]), float(info_j["loss"])))
    return out


def shared_noise_run(n_steps: int, out_dir: str, seed: int = 0, every: int = 1000,
                     batch: int = 128, overrides=()) -> dict:
    """GMM-40 fab_no_buffer (gmm.yaml, f64) trained by both packages' ``Trainer`` from
    fab_tpu's initial flow at ``key(seed)`` on shared noise: step k on
    ``fold_in(key(seed), k)``, fab_tpu's draws replayed into the port. Every ``every``
    steps: the step, the largest relative difference of the flow's parameters, and
    each package's mean ``n_valid`` and loss since the last record. At the end both
    states are checkpoints, ``out_dir/{port,fab_tpu}/model_checkpoints/iter_<n_steps>``,
    which ``gmm_fab_cells --tails`` reads. ``overrides``: gmm.yaml overrides (widths).
    A long run is for the command line:

        JAX_PLATFORMS=cpu python3 -c "import sys; sys.path[:0] = ['tests', '.'];
            import torch_parity_utils as u; print(u.shared_noise_run(19532, 'OUT'))"
    """
    from experiments.setup_run import setup_model as jax_setup_model
    from fab_tpu.targets import GMM as JaxGMM
    from fab_tpu.train import Trainer as JaxPlainTrainer
    from fab_tpu_torch.experiments.setup_run import setup_model
    from fab_tpu_torch.targets import GMM
    from fab_tpu_torch.train import Trainer
    from fab_tpu_torch.utils.training import apply_overrides, load_config

    config = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "configs" / "gmm.yaml"
    cfg = apply_overrides(load_config(str(config)),
                          ["fab.loss_type=fab_alpha_div", "training.use_buffer=false",
                           *overrides])
    kw = dict(dim=2, n_mixes=40, loc_scaling=40.0, log_var_scaling=1.0,
              true_expectation_estimation_n_samples=1000)
    with jax.enable_x64():
        trainer_j = JaxPlainTrainer(jax_setup_model(cfg, JaxGMM(**kw, dtype=jnp.float64)),
                                    jax_make_optimizer(1e-4, 100.0), dtype=jnp.float64,
                                    save_path=str(pathlib.Path(out_dir) / "fab_tpu"))
        state_j = trainer_j.init_state(jax.random.key(seed))
        step_j = jax.jit(trainer_j._train_step_fn(batch))
    trainer = Trainer(setup_model(cfg, GMM(**kw, dtype=torch.float64, device="cpu"),
                                  torch.float64, "cpu"),
                      make_optimizer(1e-4, 100.0), dtype=torch.float64, device="cpu",
                      save_path=str(pathlib.Path(out_dir) / "port"))
    flow = trainer.model.flow
    flow.load_state_dict(from_jax_params(to_np(state_j.params["flow"]), flow=flow))
    state = trainer.state_type(
        transition_state={k: torch.tensor(np.array(v)) for k, v in
                          to_np(state_j.params["transition"]).items()},
        opt_state=trainer.optimizer.init(trainer.params), step=0)
    records, since = [], {"n_valid": [], "n_valid_j": [], "loss": [], "loss_j": []}
    for k in range(n_steps):
        key = jax.random.fold_in(jax.random.key(seed), k)
        with jax.enable_x64():
            state_j, info_j = step_j(state_j, key)
            noise = metropolis_ais_noise(key, 1, 1, batch, 2, jnp.float64)
        with pytest.MonkeyPatch.context() as mp:
            replay = NoiseReplay(mp, noise)
            state, info = trainer.train_step(state, None, batch)
            replay.assert_consumed()
        for name, value in (("n_valid", info["n_valid"]), ("n_valid_j", info_j["n_valid"]),
                            ("loss", info["loss"]), ("loss_j", info_j["loss"])):
            since[name].append(float(value))
        if (k + 1) % every == 0 or k + 1 == n_steps:
            want = from_jax_params(to_np(state_j.params["flow"]))
            diff = max(float((v - torch.as_tensor(want[n])).abs().max()
                             / torch.as_tensor(want[n]).abs().max().clamp(min=1e-300))
                       for n, v in flow.state_dict().items())
            records.append(dict({n: float(np.mean(v)) for n, v in since.items()},
                                step=k + 1, param_rel_diff=diff))
            since = {n: [] for n in since}
    trainer.save_checkpoint(state, n_steps)
    with jax.enable_x64():
        trainer_j.save_checkpoint(state_j, n_steps)
    return {"records": records}
