"""Options of ported modules, each turned on against fab_tpu (CPU, float64), and the
prioritised trainer's train-time sample filter.

- ``PrioritisedBufferTrainer`` with a ``sample_filter`` (rows with x_0 <= 0 dropped):
  the rejected AIS rows go into the buffer with priority -inf, as in fab_tpu; flow
  parameters, Adam state and buffer after the step agree to 1e-8, and
  ``frac_filter_pass`` equals fab_tpu's.
- ``w_adjust_in_buffer_after_update=True``, and ``sample_with_replacement=True``
  (the categorical draw on shared Gumbel noise): whole steps to 1e-8, and the
  buffer draw itself exactly.
- ``PrioritisedReplayBuffer.can_sample`` and ``GMM.save_as_numpy``: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.buffer import PrioritisedReplayBuffer as JaxBuffer
from fab_tpu.targets import GMM as JaxGMM
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.targets import GMM, ManyWellEnergy
from torch_parity_utils import (
    NoiseReplay,
    assert_close,
    check_train_step,
    make_flow_pair,
    random_buffer_inputs,
    to_np,
)

DT = torch.float64
DIM, BATCH, N_DISTS = 4, 64, 2
HMC_KW = dict(n_ais_intermediate_distributions=N_DISTS, n_leapfrog=3, epsilon=0.3)


def _step(monkeypatch, **kw):
    with jax.enable_x64():
        flow_pair = make_flow_pair(DIM, 2, 2, DT, seed=2)
        target_j = JaxManyWell(DIM)
    return check_train_step(
        monkeypatch, flow_pair, (target_j, ManyWellEnergy(DIM, device="cpu")),
        DIM, BATCH, N_DISTS, n_batches=2, hmc_kw=HMC_KW, **kw,
    )


def test_prioritised_trainer_applies_the_sample_filter(monkeypatch):
    filters = (lambda x, mask: mask & (x[:, 0] > 0), lambda x, mask: mask & (x[:, 0] > 0))
    info, new, info_j, new_j = _step(monkeypatch, filters=filters)
    # The AIS batch went in at rows 192..255 (the ring's cursor before the step).
    rows = slice(192, 192 + BATCH)
    x_new = new.buffer_state.x[rows]
    log_w_new = new.buffer_state.log_w[rows]
    rejected = x_new[:, 0] <= 0
    assert 0 < int(rejected.sum()) < BATCH
    assert torch.isneginf(log_w_new[rejected]).all()
    assert np.isneginf(np.asarray(new_j.buffer_state.log_w)[rows][rejected.numpy()]).all()
    n_valid = int(info["n_valid"])
    assert float(info["frac_filter_pass"]) == float(info_j["frac_filter_pass"])
    assert 0.0 < float(info["frac_filter_pass"]) < 1.0 and n_valid > 0


def test_w_adjust_in_buffer_after_update_matches(monkeypatch):
    _step(monkeypatch, trainer_kw=dict(w_adjust_in_buffer_after_update=True))


def test_sampling_with_replacement_step_matches(monkeypatch):
    _step(monkeypatch, with_replacement=True)


@pytest.mark.parametrize("replace", [False, True], ids=["top-k", "categorical"])
def test_buffer_draw_and_can_sample_match(replace, monkeypatch):
    rng = np.random.default_rng(3)
    with jax.enable_x64():
        buf_j = JaxBuffer(dim=3, max_length=256, min_sample_length=100,
                          sample_with_replacement=replace)
        state_j = buf_j.init(jnp.float64)
    buf = PrioritisedReplayBuffer(dim=3, max_length=256, min_sample_length=100,
                                  sample_with_replacement=replace)
    state = buf.init(DT)
    for n_adds in range(3):
        with jax.enable_x64():
            assert bool(buf_j.can_sample(state_j)) == bool(buf.can_sample(state))
        x, lw, lq, m = random_buffer_inputs(rng, 60, 3)
        with jax.enable_x64():
            state_j = buf_j.add(state_j, jnp.asarray(x), jnp.asarray(lw), jnp.asarray(lq),
                                jnp.asarray(m))
        state = buf.add(state, *(torch.tensor(a) for a in (x, lw, lq, m)))
    assert bool(buf.can_sample(state)) and int(state.n_added) == 180
    key = jax.random.key(4)
    with jax.enable_x64():
        out_j = to_np(buf_j.sample(state_j, key, 40))
        shape = (40, 256) if replace else (256,)
        gumbel = np.asarray(jax.random.gumbel(key, shape, jnp.float64))
    replay = NoiseReplay(monkeypatch, {"gumbel": [gumbel]})
    out = buf.sample(state, None, 40)
    replay.assert_consumed()
    for a, b, what in zip(out, out_j, ("x", "log_w", "log_q_old", "indices")):
        assert_close(a, b, 0.0, what)
    if replace:  # with replacement, some rows are drawn twice
        assert len(set(out[3].tolist())) < 40


def test_gmm_save_as_numpy_matches(tmp_path):
    with jax.enable_x64():
        JaxGMM(dim=2, n_mixes=5, loc_scaling=3.0, dtype=jnp.float64,
               true_expectation_estimation_n_samples=10).save_as_numpy(str(tmp_path / "j.npz"))
    GMM(dim=2, n_mixes=5, loc_scaling=3.0, dtype=DT, device="cpu",
        true_expectation_estimation_n_samples=10).save_as_numpy(str(tmp_path / "t.npz"))
    a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files) == ["locs", "scales", "weights"]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
