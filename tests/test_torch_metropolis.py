"""Parity of the port's Metropolis kernel, resampling and a Metropolis AIS pass with
fab_tpu on shared noise (CPU, float64).

JAX's proposals (normals) and acceptance uniforms are regenerated by replaying
fab_tpu's key splits (ais.py, metropolis.py) and fed to the port. Tolerance 1e-10
for one transition (the same float64 arithmetic), 1e-8 for a whole AIS pass (flow
log-probs summed in other orders, carried through the chain).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.sampling import AnnealedImportanceSampler as JaxAIS
from fab_tpu.sampling import Metropolis as JaxMetropolis
from fab_tpu.sampling import create_point as jax_create_point
from fab_tpu.sampling.point import resample as jax_resample
from fab_tpu.targets import GMM as JaxGMM
from fab_tpu_torch.sampling import AnnealedImportanceSampler, Metropolis, create_point, resample
from fab_tpu_torch.targets import GMM
from fab_tpu_torch.typing import Point
from torch_parity_utils import (
    NoiseReplay,
    assert_close,
    make_flow_pair,
    metropolis_ais_noise,
    to_np,
)

DIM, BATCH, N_DISTS = 2, 64, 2
DT = torch.float64
KW = dict(n_ais_intermediate_distributions=N_DISTS, n_updates=3, max_step_size=2.0,
          min_step_size=0.5, target_p_accept=0.65)


def _targets():
    with jax.enable_x64():
        target_j = JaxGMM(n_mixes=8, loc_scaling=5.0, dtype=jnp.float64,
                          true_expectation_estimation_n_samples=1000)
    return target_j, GMM(n_mixes=8, loc_scaling=5.0, dtype=DT, device="cpu",
                         true_expectation_estimation_n_samples=1000)


def test_metropolis_init_state_matches_fab_tpu():
    with jax.enable_x64():
        want = JaxMetropolis(**KW).init_state(DIM, jnp.float64)["noise_scalings"]
    got = Metropolis(**KW).init_state(DIM, dtype=DT)["noise_scalings"]
    assert_close(got, np.asarray(want), 0.0)
    assert Metropolis(**KW).uses_grad_info is False


@pytest.mark.parametrize("tune", [True, False], ids=["tune", "eval"])
def test_metropolis_transition_on_shared_noise(tune, monkeypatch):
    """Proposals, uniforms, NaN/inf rejection (a few rows start at non-finite log
    q) and the x1.05 / /1.05 tuning from the masked acceptance mean."""
    target_j, target = _targets()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, DIM)) * 3
    mask = np.ones(BATCH, bool)
    mask[:4] = False
    key = jax.random.key(2)

    def log_q_j(xx):
        return jnp.where(xx[:, 0] > 6.0, jnp.nan, -0.5 * jnp.sum(xx**2, -1) / 9)

    def log_q(xx):
        return torch.where(xx[:, 0] > 6.0, torch.nan, -0.5 * (xx**2).sum(-1) / 9)

    op_j, op = JaxMetropolis(**KW), Metropolis(**KW)
    with jax.enable_x64():
        point_j = jax_create_point(jnp.asarray(x), log_q_j, target_j.log_prob, with_grad=False)
        state_j = op_j.init_state(DIM, jnp.float64)
        new_point_j, new_state_j, info_j = to_np(op_j.transition(
            state_j, key, point_j, jnp.asarray(0.5), 1, log_q_j, target_j.log_prob, 2.0,
            jnp.asarray(mask), tune))
        noise = {"normal": [], "uniform": []}
        for key_n in jax.random.split(key, KW["n_updates"]):
            key_prop, key_acc = jax.random.split(key_n)
            noise["normal"].append(
                np.asarray(jax.random.normal(key_prop, (BATCH, DIM), jnp.float64)))
            noise["uniform"].append(np.asarray(jax.random.uniform(key_acc, (BATCH,), jnp.float64)))
    replay = NoiseReplay(monkeypatch, noise)
    point = create_point(torch.tensor(x), log_q, target.log_prob, with_grad=False)
    new_point, new_state, info = op.transition(
        op.init_state(DIM, dtype=DT), None, point, 0.5, 1, log_q, target.log_prob, 2.0,
        torch.tensor(mask), tune)
    replay.assert_consumed()
    for name in ("x", "log_q", "log_p"):
        assert_close(getattr(new_point, name), getattr(new_point_j, name), 1e-10, name)
    assert_close(new_state["noise_scalings"], new_state_j["noise_scalings"], 1e-12)
    for k in ("p_accept", "avg_distance"):
        assert_close(info[k], info_j[k], 1e-10, k)
    moved = (new_point.x != point.x).any(-1)
    assert 0 < int(moved.sum()) < BATCH


def test_resample_on_shared_gumbels(monkeypatch):
    rng = np.random.default_rng(3)
    x, log_w = rng.standard_normal((32, 3)), rng.standard_normal(32) * 2
    log_w[::5] = -np.inf
    key = jax.random.key(4)
    with jax.enable_x64():
        pj = jax_resample(key, jax_create_point(
            jnp.asarray(x), lambda v: jnp.sum(v, -1), lambda v: -jnp.sum(v**2, -1),
            with_grad=False), jnp.asarray(log_w))
        gumbel = np.asarray(jax.random.gumbel(key, (32, 32), jnp.float64))
    replay = NoiseReplay(monkeypatch, {"gumbel": [gumbel]})
    xt = torch.tensor(x)
    p = resample(None, Point(xt, xt.sum(-1), -(xt**2).sum(-1)), torch.tensor(log_w))
    replay.assert_consumed()
    for name in ("x", "log_q", "log_p"):
        assert_close(getattr(p, name), np.asarray(getattr(pj, name)), 0.0, name)
    assert p.grad_log_q is None


@pytest.mark.parametrize("p_target", [False, True], ids=["min_var", "p_target"])
def test_metropolis_ais_pass_on_shared_noise(p_target, monkeypatch):
    target_j, target = _targets()
    with jax.enable_x64():
        jax_flow, params, flow = make_flow_pair(DIM, 3, 8, DT, seed=5)
        ais_j = JaxAIS(jax_flow, target_j.log_prob, JaxMetropolis(**KW), N_DISTS)
        key = jax.random.key(6)
        state_j = ais_j.transition_operator.init_state(DIM, jnp.float64)
        result_j = to_np(ais_j.sample_and_log_weights(params, state_j, key, BATCH,
                                                      p_target=p_target, tune=True))
        noise = metropolis_ais_noise(key, N_DISTS, KW["n_updates"], BATCH, DIM, jnp.float64)
    ais = AnnealedImportanceSampler(flow, target.log_prob, Metropolis(**KW), N_DISTS)
    replay = NoiseReplay(monkeypatch, noise)
    result = ais.sample_and_log_weights(
        ais.transition_operator.init_state(DIM, dtype=DT), None, BATCH, p_target=p_target)
    replay.assert_consumed()
    assert_close(result.point.x, result_j.point.x, 1e-8, "x")
    assert_close(result.log_w, result_j.log_w, 1e-8, "log_w")
    assert np.array_equal(result.mask.numpy(), result_j.mask)
    assert_close(result.transition_state["noise_scalings"],
                 result_j.transition_state["noise_scalings"], 1e-12)
    for k in ("ess_base", "ess_ais", "log_Z", "n_valid"):
        assert_close(result.info[k], result_j.info[k], 1e-8, k)
    for k in ("p_accept", "avg_distance"):
        assert_close(result.info["transition"][k], result_j.info["transition"][k], 1e-8, k)
