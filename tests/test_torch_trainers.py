"""Parity of the port's plain and uniform-buffer trainers, ReplayBuffer and ActNorm
with fab_tpu (CPU, float64), and their checkpoints.

- One ``Trainer`` step (GMM, Metropolis AIS, fab_alpha_div) and one
  ``BufferTrainer`` step (the same, with a recency-weighted buffer and top-k
  log-weight clipping) on shared noise: flow parameters, Adam state, transition
  state, buffer and logged info to 1e-8 (the step compounds summation-order
  differences through AIS and the updates).
- ``ReplayBuffer`` add and sample, ``ActNorm`` and ``data_dependent_init``: 1e-10.
- ``run`` with a checkpoint, then ``load_state``: the restored state is the run's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.buffer import ReplayBuffer as JaxReplayBuffer
from fab_tpu.flows import data_dependent_init as jax_data_dependent_init
from fab_tpu.flows import make_realnvp as jax_make_realnvp
from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.sampling import Metropolis as JaxMetropolis
from fab_tpu.targets import GMM as JaxGMM
from fab_tpu.train import BufferTrainer as JaxBufferTrainer
from fab_tpu.train import BufferTrainState as JaxBufferTrainState
from fab_tpu.train import Trainer as JaxTrainer
from fab_tpu.train import TrainState as JaxTrainState
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu_torch.buffer import ReplayBuffer, UniformBufferState
from fab_tpu_torch.checkpoint import latest_checkpoint
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.flows import data_dependent_init, make_realnvp
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.sampling import Metropolis
from fab_tpu_torch.targets import GMM
from fab_tpu_torch.train import (
    BufferTrainer,
    BufferTrainState,
    Trainer,
    TrainState,
    make_optimizer,
)
from torch_parity_utils import (
    NoiseReplay,
    assert_close,
    make_flow_pair,
    metropolis_ais_noise,
    perturbed_jax_flow_params,
    to_np,
)

DT = torch.float64
DIM, BATCH, N_DISTS, N_UPDATES = 2, 64, 1, 2
MH_KW = dict(n_ais_intermediate_distributions=N_DISTS, n_updates=N_UPDATES,
             max_step_size=3.0, min_step_size=1.0)


@functools.lru_cache(maxsize=None)
def _targets():
    with jax.enable_x64():
        target_j = JaxGMM(n_mixes=8, loc_scaling=5.0, dtype=jnp.float64,
                          true_expectation_estimation_n_samples=1000)
    return target_j, GMM(n_mixes=8, loc_scaling=5.0, dtype=DT, device="cpu",
                         true_expectation_estimation_n_samples=1000)


def _models(seed):
    target_j, target = _targets()
    jax_flow, params, flow = make_flow_pair(DIM, 3, 8, DT, seed=seed)
    model_j = JaxFABModel.create(jax_flow, target_j, JaxMetropolis(**MH_KW), N_DISTS)
    model = FABModel.create(flow, target, Metropolis(**MH_KW), N_DISTS)
    return model_j, params, model


def _check_flow_and_adam(trainer, new_opt, new_j, tol):
    flow = trainer.model.flow
    expected = from_jax_params(new_j.params["flow"])
    for name, value in flow.state_dict().items():
        assert_close(value, expected[name], tol, name)
    adam_j = new_j.opt_state[1][0]
    mu_j, nu_j = from_jax_params(adam_j.mu), from_jax_params(adam_j.nu)
    names = [n for n, p in flow.named_parameters() if p.requires_grad]
    assert int(new_opt.count) == int(adam_j.count)
    for name, mu, nu in zip(names, new_opt.mu, new_opt.nu):
        assert_close(mu, mu_j[name], tol, "mu " + name)
        assert_close(nu, nu_j[name], tol, "nu " + name)


def test_trainer_step_matches_fab_tpu(monkeypatch):
    with jax.enable_x64():
        model_j, params, model = _models(seed=1)
        trainer_j = JaxTrainer(model_j, jax_make_optimizer(1e-2, 100.0), dtype=jnp.float64)
        trans_j = to_np(model_j.ais.transition_operator.init_state(DIM, jnp.float64))
        state_j = JaxTrainState({"flow": params, "transition": trans_j},
                                trainer_j.optimizer.init(params), jnp.zeros((), jnp.int32))
        key = jax.random.key(2)
        new_j, info_j = to_np(jax.jit(trainer_j._train_step_fn(BATCH))(state_j, key))
        noise = metropolis_ais_noise(key, N_DISTS, N_UPDATES, BATCH, DIM, jnp.float64)
    trainer = Trainer(model, make_optimizer(1e-2, 100.0), dtype=DT, device="cpu")
    state = TrainState({"noise_scalings": torch.tensor(trans_j["noise_scalings"])},
                       trainer.optimizer.init(trainer.params), 0)
    replay = NoiseReplay(monkeypatch, noise)
    new, info = trainer.train_step(state, None, BATCH)
    replay.assert_consumed()
    _check_flow_and_adam(trainer, new.opt_state, new_j, 1e-8)
    assert_close(new.transition_state["noise_scalings"],
                 new_j.params["transition"]["noise_scalings"], 1e-12)
    for k in ("loss", "grad_norm", "ess_ais", "ess_base", "n_valid", "log_Z"):
        assert_close(info[k], info_j[k], 1e-8, k)
    assert bool(info["update_applied"]) and new.step == 1


def _buffer_pair(temperature):
    return (JaxReplayBuffer(DIM, 256, 64, temperature), ReplayBuffer(DIM, 256, 64, temperature))


def _fill(buf_j, buf, rng, n_adds, batch):
    """The same adds (some rows masked, some weights NaN) into both buffers."""
    with jax.enable_x64():
        state_j = buf_j.init(jnp.float64)
        state = buf.init(DT)
        for _ in range(n_adds):
            x, log_w = rng.standard_normal((batch, DIM)), rng.standard_normal(batch) * 2
            log_w[::9] = np.nan
            mask = rng.random(batch) > 0.2
            state_j = buf_j.add(state_j, jnp.asarray(x), jnp.asarray(log_w), jnp.asarray(mask))
            state = buf.add(state, torch.tensor(x), torch.tensor(log_w), torch.tensor(mask))
    return to_np(state_j), state


@pytest.mark.parametrize("temperature", [0.0, 1.5], ids=["uniform", "recency"])
def test_replay_buffer_add_and_sample_match_fab_tpu(temperature, monkeypatch):
    buf_j, buf = _buffer_pair(temperature)
    state_j, state = _fill(buf_j, buf, np.random.default_rng(3), 5, 60)  # wraps the ring
    assert isinstance(state, UniformBufferState)
    for name, a, b in zip(state._fields, state, state_j):
        assert_close(a, b, 0.0, name)
    key = jax.random.key(4)
    with jax.enable_x64():
        x_j, lw_j = to_np(buf_j.sample(jax.tree.map(jnp.asarray, state_j), key, 32))
    gumbel = np.asarray(jax.random.gumbel(key, (32, 256), jnp.float32))
    replay = NoiseReplay(monkeypatch, {"gumbel": [gumbel]})
    x, lw = buf.sample(state, None, 32)
    replay.assert_consumed()
    assert_close(x, x_j, 0.0, "x")
    assert_close(lw, lw_j, 0.0, "log_w")
    assert bool(buf.can_sample(state))


def test_buffer_trainer_step_matches_fab_tpu(monkeypatch):
    n_batches, clip = 2, 0.25
    buf_j, buf = _buffer_pair(1.0)
    state_b_j, state_b = _fill(buf_j, buf, np.random.default_rng(5), 2, 64)
    with jax.enable_x64():
        model_j, params, model = _models(seed=6)
        trainer_j = JaxBufferTrainer(model_j, jax_make_optimizer(1e-2, 100.0), buf_j,
                                     n_batches_buffer_sampling=n_batches,
                                     clip_ais_weights_frac=clip, dtype=jnp.float64)
        trans_j = to_np(model_j.ais.transition_operator.init_state(DIM, jnp.float64))
        state_j = JaxBufferTrainState(
            {"flow": params, "transition": trans_j}, trainer_j.optimizer.init(params),
            jax.tree.map(jnp.asarray, state_b_j), jnp.zeros((), jnp.int32))
        key = jax.random.key(7)
        new_j, info_j = to_np(jax.jit(trainer_j._train_step_fn(BATCH))(state_j, key))
        key_ais, key_sample = jax.random.split(key)
        noise = metropolis_ais_noise(key_ais, N_DISTS, N_UPDATES, BATCH, DIM, jnp.float64)
        noise["gumbel"] = [np.asarray(jax.random.gumbel(k, (BATCH, 256), jnp.float32))
                           for k in jax.random.split(key_sample, n_batches)]
    trainer = BufferTrainer(model, make_optimizer(1e-2, 100.0), buf,
                            n_batches_buffer_sampling=n_batches, clip_ais_weights_frac=clip,
                            dtype=DT, device="cpu")
    state = BufferTrainState({"noise_scalings": torch.tensor(trans_j["noise_scalings"])},
                             trainer.optimizer.init(trainer.params), state_b, 0)
    replay = NoiseReplay(monkeypatch, noise)
    new, info = trainer.train_step(state, None, BATCH)
    replay.assert_consumed()
    _check_flow_and_adam(trainer, new.opt_state, new_j, 1e-8)
    for name, a, b in zip(new.buffer_state._fields, new.buffer_state, new_j.buffer_state):
        assert_close(a, b, 1e-8, name)
    for k in ("loss", "grad_norm", "replay_loss", "ess_ais", "n_valid"):
        assert_close(info[k], info_j[k], 1e-8, k)


def test_act_norm_and_data_dependent_init_match_fab_tpu():
    """A RealNVP with ActNorm layers: the data-dependent init on shared data, then
    the flow's log-prob and forward pass, against fab_tpu's."""
    rng = np.random.default_rng(8)
    data = rng.standard_normal((300, 4)) * 2 + 1
    x = rng.standard_normal((50, 4))
    with jax.enable_x64():
        jax_flow = jax_make_realnvp(4, n_flow_layers=2, layer_nodes_per_dim=3, act_norm=True)
        params = perturbed_jax_flow_params(jax_flow, 9, jnp.float64)
        flow = make_realnvp(4, 2, 3, act_norm=True, dtype=DT, device="cpu")
        flow.load_state_dict(from_jax_params(to_np(params)))
        params = jax_data_dependent_init(jax_flow, params, jax.random.key(0),
                                         data=jnp.asarray(data))
        lp_j = np.asarray(jax_flow.log_prob(params, jnp.asarray(x)))
        y_j, ld_j = to_np(jax_flow.forward_and_log_det(params, jnp.asarray(x)))
        params = to_np(params)
    assert data_dependent_init(flow, None, data=torch.tensor(data)) is flow
    expected = from_jax_params(params)
    for name, value in flow.state_dict().items():
        assert_close(value, expected[name], 1e-10, name)
    with torch.no_grad():
        assert_close(flow.log_prob(torch.tensor(x)), lp_j, 1e-10, "log_prob")
        y, ld = flow.forward_and_log_det(torch.tensor(x))
    assert_close(y, y_j, 1e-10, "y")
    assert_close(ld, ld_j, 1e-10, "log_det")
    with pytest.raises(ValueError, match="alternating"):
        make_realnvp(4, 2, 3, act_norm=True, fused=True, dtype=DT, device="cpu")


@pytest.mark.parametrize("kind", ["plain", "buffer"])
def test_run_checkpoint_restores_the_state(kind, tmp_path):
    """``run`` writes a checkpoint at its last iteration; ``load_state`` gives back
    the flow, the optimizer, the transition state and (for the buffer trainer) the
    buffer, and training goes on from there."""
    with jax.enable_x64():
        _, params, model = _models(seed=10)
    common = dict(save_path=str(tmp_path), dtype=DT, device="cpu")
    if kind == "plain":
        trainer = Trainer(model, make_optimizer(1e-3, 100.0), **common)
    else:
        trainer = BufferTrainer(model, make_optimizer(1e-3, 100.0), ReplayBuffer(DIM, 256, 64),
                                **common)
    gen = torch.Generator().manual_seed(0)
    state = trainer.run(gen, n_iterations=3, batch_size=32, n_checkpoints=1)
    params_run = {k: v.clone() for k, v in model.flow.state_dict().items()}
    with torch.no_grad():
        for p in model.flow.parameters():
            p.zero_()
    loaded, step = trainer.load_state(latest_checkpoint(trainer.checkpoints_dir))
    assert step == 3 and type(loaded) is type(state)
    for name, value in model.flow.state_dict().items():
        assert_close(value, params_run[name], 0.0, name)
    for a, b in zip(loaded.opt_state.mu + [loaded.opt_state.count],
                    state.opt_state.mu + [state.opt_state.count]):
        assert_close(a, b, 0.0)
    assert_close(loaded.transition_state["noise_scalings"],
                 state.transition_state["noise_scalings"], 0.0)
    if kind == "buffer":
        for a, b in zip(loaded.buffer_state, state.buffer_state):
            assert_close(a, b, 0.0)
    trainer.run(gen, n_iterations=4, batch_size=32, state=loaded, start_iter=step)
    assert latest_checkpoint(trainer.checkpoints_dir).endswith("iter_3/state.pkl")
