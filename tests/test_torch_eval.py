"""Parity of the port's evaluation and run loop with fab_tpu, and its checkpoints
(CPU).

- generate_eval_data / get_eval_info on a small LGCP with the fused_coupling flow,
  on replayed JAX noise: the flow-sample weights come from the same draw the AIS
  chain starts from, so the replay is consumed exactly (float64, 1e-8: AIS with
  HMC compounds summation-order differences).
- format_transition_info and _schedule against fab_tpu's.
- PrioritisedBufferTrainer.run: the CSV it writes, and save -> latest_checkpoint ->
  load -> next step equal to the uninterrupted run.
- to_jax_params inverts from_jax_params.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.model import format_transition_info as jax_format_transition_info
from fab_tpu.sampling import HamiltonianMonteCarlo as JaxHMC
from fab_tpu.targets import LogGaussianCoxProcess as JaxLGCP
from fab_tpu.train import _schedule as jax_schedule
from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.checkpoint import latest_checkpoint, load_checkpoint
from fab_tpu_torch.convert import from_jax_params, to_jax_params, transition_state_from_jax
from fab_tpu_torch.flows import make_realnvp
from fab_tpu_torch.model import FABModel, format_transition_info
from fab_tpu_torch.sampling import HamiltonianMonteCarlo
from fab_tpu_torch.targets import LogGaussianCoxProcess
from fab_tpu_torch.train import PrioritisedBufferTrainer, _schedule, make_optimizer
from fab_tpu_torch.utils.logging import CSVLogger, ListLogger
from torch_parity_utils import NoiseReplay, ais_noise, assert_close, make_flow_pair, to_np

DT = torch.float64
GRID, N_DISTS = 8, 2
HMC_KW = dict(n_ais_intermediate_distributions=N_DISTS, n_leapfrog=3, epsilon=0.1)


def _eval_pair():
    """fab_tpu's and the port's FABModel on a grid-8 LGCP with the same f64 flow."""
    with jax.enable_x64():
        jax_flow, params, flow = make_flow_pair(
            GRID * GRID, 2, 2, DT, seed=11, scale_cap=5.0, fused_coupling=True
        )
        model_j = JaxFABModel.create(
            jax_flow, JaxLGCP(grid_size=GRID, dtype=jnp.float64),
            transition_operator=JaxHMC(**HMC_KW), n_intermediate_distributions=N_DISTS,
        )
        trans_j = to_np(model_j.ais.transition_operator.init_state(GRID * GRID, jnp.float64))
    model = FABModel.create(
        flow, LogGaussianCoxProcess(grid_size=GRID, dtype=DT, device="cpu"),
        transition_operator=HamiltonianMonteCarlo(**HMC_KW),
        n_intermediate_distributions=N_DISTS,
    )
    return model_j, {"flow": params, "transition": trans_j}, model


def _eval_noise(key, n_chunks, inner):
    """fab_tpu's draws for get_eval_info(key): chunk i runs on fold_in(key_data, i)
    (model.py:245-248), and its flow sample is the AIS pass's own first draw."""
    noise = {"normal": [], "exponential": []}
    with jax.enable_x64():
        key_data, _ = jax.random.split(key)
        for i in range(n_chunks):
            chunk = ais_noise(jax.random.fold_in(key_data, i), N_DISTS, 1, inner,
                              GRID * GRID, jnp.float64)
            for k in noise:
                noise[k] += chunk[k]
    return noise


@pytest.mark.parametrize("p_target", [True, False], ids=["p_target", "min_var_target"])
def test_get_eval_info_matches_fab_tpu(p_target, monkeypatch):
    model_j, params_j, model = _eval_pair()
    key = jax.random.key(21)
    outer, inner = 64, 32
    with jax.enable_x64():
        info_j = model_j.get_eval_info(
            params_j, key, outer, inner, p_target=p_target, ais_only=not p_target
        )
        key_data, _ = jax.random.split(key)
        data_j = model_j.generate_eval_data(params_j, key_data, outer, inner, p_target)
    trans = transition_state_from_jax(params_j["transition"])

    replay = NoiseReplay(monkeypatch, _eval_noise(key, outer // inner, inner))
    info = model.get_eval_info(trans, None, outer, inner, p_target=p_target,
                               ais_only=not p_target)
    replay.assert_consumed()  # one flow draw per chunk: no second flow pass
    assert set(info) == set(info_j)
    for k in info:
        assert_close(info[k], info_j[k], 1e-8, k)
    assert info["eval_ess_ais"] > 0

    replay = NoiseReplay(monkeypatch, _eval_noise(key, outer // inner, inner))
    data = model.generate_eval_data(trans, None, outer, inner, p_target)
    replay.assert_consumed()
    for name, a, b in zip(("base_x", "base_log_w", "base_mask", "ais_x", "ais_log_w",
                           "ais_mask"), data, data_j):
        assert a.shape == np.asarray(b).shape and a.shape[0] == outer
        assert_close(a, b, 1e-8, name)


def test_generate_eval_data_needs_whole_chunks():
    _, _, model = _eval_pair()
    trans = HamiltonianMonteCarlo(**HMC_KW).init_state(GRID * GRID, DT)
    with pytest.raises(ValueError, match="multiple of inner_batch_size"):
        model.generate_eval_data(trans, torch.Generator(), 100, 32)


@pytest.mark.parametrize("n_dists", [1, 3])
def test_format_transition_info_matches_fab_tpu(n_dists):
    rng = np.random.default_rng(n_dists)
    t_info = {"p_accept": rng.random((n_dists, 2)), "avg_distance": rng.random(n_dists)}
    out_j = jax_format_transition_info(t_info, n_dists)
    out = format_transition_info({k: torch.tensor(v) for k, v in t_info.items()}, n_dists)
    assert list(out) == list(out_j)
    for k in out:
        assert float(out[k]) == float(out_j[k])


@pytest.mark.parametrize("n_iterations, n_points",
                         [(10, None), (10, 0), (10, 1), (10, 3), (7, 7), (10000, 5)])
def test_schedule_matches_fab_tpu(n_iterations, n_points):
    assert _schedule(n_iterations, n_points) == jax_schedule(n_iterations, n_points)


def _small_trainer(tmp_path, seed=0, logger=None):
    """A grid-4 LGCP trainer on the CPU; the flow takes the FusedCoupling route
    (f32, width 128, scale cap 5)."""
    dim = 16
    gen = torch.Generator().manual_seed(seed)
    flow = make_realnvp(dim, 2, 8, scale_cap=5.0, fused_coupling=True, generator=gen,
                        device="cpu")
    model = FABModel.create(
        flow, LogGaussianCoxProcess(grid_size=4, device="cpu"),
        transition_operator=HamiltonianMonteCarlo(
            n_ais_intermediate_distributions=2, n_leapfrog=2, epsilon=0.1
        ),
        n_intermediate_distributions=2,
    )
    return PrioritisedBufferTrainer(
        model, make_optimizer(1e-3, 100.0),
        PrioritisedReplayBuffer(dim=dim, max_length=256, min_sample_length=64),
        n_batches_buffer_sampling=2, logger=logger, save_path=str(tmp_path),
        device="cpu",
    )


STEP_COLUMNS = {
    "ess_base", "ess_ais", "log_Z", "n_valid", "n_logw_bound_masked", "loss",
    "grad_norm", "update_applied", "w_adjust_mean", "w_adjust_min", "w_adjust_max",
    "log_q_x_mean", "sampled_log_w_mean", "sampled_log_w_std", "dist0_p_accept_0",
    "average_distance_dist0", "dist1_p_accept_0", "average_distance_dist_1", "step",
}
EVAL_COLUMNS = {
    f"{k}_p_target" for k in (
        "eval_ess_flow", "eval_ess_ais", "flow_post_mean_field_rmse",
        "flow_post_mean_log_intensity", "flow_sample_mean_log_q",
        "ais_post_mean_field_rmse", "ais_post_mean_log_intensity",
    )
} | {
    f"{k}_min_var_target" for k in (
        "eval_ess_flow", "eval_ess_ais", "ais_post_mean_field_rmse",
        "ais_post_mean_log_intensity",
    )
}


@pytest.mark.parametrize("log_every, logged", [(1, [1, 2, 3]), (2, [1, 3])],
                         ids=["every_step", "chunks_of_2"])
def test_run_writes_step_and_eval_rows(tmp_path, log_every, logged):
    """Three iterations with two evals (at 1 and 3): one row per logged chunk with
    the step info and the flattened transition info, one row per eval with both
    targets' metrics. A chunk stops at every scheduled event."""
    path = tmp_path / "log.csv"
    trainer = _small_trainer(tmp_path, logger=CSVLogger(str(path)))
    state = trainer.run(torch.Generator().manual_seed(1), 3, 32, eval_batch_size=64,
                        n_eval=2, n_checkpoints=0, log_every=log_every)
    assert state.step == 3
    with open(path) as f:
        rows = list(csv.DictReader(f))
    step_rows = [r for r in rows if r["loss"]]
    eval_rows = [r for r in rows if r["eval_ess_ais_p_target"]]
    assert set(rows[0]) == STEP_COLUMNS | EVAL_COLUMNS
    assert [float(r["step"]) for r in step_rows] == logged
    assert [float(r["step"]) for r in eval_rows] == [1, 3]
    for r in eval_rows:
        for k in EVAL_COLUMNS:
            assert np.isfinite(float(r[k])), k
    assert not (tmp_path / "model_checkpoints").exists() or not any(
        (tmp_path / "model_checkpoints").iterdir()
    )


def _assert_tree_of_numpy(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            _assert_tree_of_numpy(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _assert_tree_of_numpy(v)
    else:
        assert isinstance(tree, (np.ndarray, int, float)), type(tree)


def test_checkpoint_resume_continues_the_run(tmp_path):
    """save -> latest_checkpoint -> load into a fresh trainer -> the next step is
    the same as the uninterrupted run's, to the bit."""
    trainer = _small_trainer(tmp_path, logger=ListLogger())
    gen = torch.Generator().manual_seed(2)
    state = trainer.run(gen, 1, 32, n_checkpoints=1)
    path = latest_checkpoint(trainer.checkpoints_dir)
    assert path is not None and path.endswith("iter_1/state.pkl")
    raw = load_checkpoint(path)
    _assert_tree_of_numpy(raw)
    assert set(raw) == {"params", "opt_state", "buffer_state", "step"}
    assert set(raw["params"]["flow"]) == {"base", "layers"}

    gen_state = gen.get_state()
    expected, _ = trainer.train_step(state, gen, 32)

    resumed = _small_trainer(tmp_path, seed=5)  # other initial parameters
    loaded, step = resumed.load_state(path)
    assert step == loaded.step == 1
    gen2 = torch.Generator()
    gen2.set_state(gen_state)
    got, _ = resumed.train_step(loaded, gen2, 32)
    for (name, a), b in zip(resumed.model.flow.state_dict().items(),
                            trainer.model.flow.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(got.opt_state.count, expected.opt_state.count)
    for a, b in zip(got.opt_state.mu + got.opt_state.nu,
                    expected.opt_state.mu + expected.opt_state.nu):
        assert torch.equal(a, b)
    for a, b in zip(got.buffer_state, expected.buffer_state):
        assert torch.equal(a, b)
    for k in expected.transition_state:
        assert torch.equal(got.transition_state[k], expected.transition_state[k])
    assert got.step == expected.step == 2


def test_to_jax_params_inverts_from_jax_params():
    with jax.enable_x64():
        _, params, flow = make_flow_pair(16, 2, 8, DT, seed=3, scale_cap=5.0,
                                         fused_coupling=True)
    back = to_jax_params(from_jax_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    state = flow.state_dict()
    again = from_jax_params(to_jax_params(state))
    assert list(again) == list(state)
    for k in state:
        assert torch.equal(again[k], state[k])
