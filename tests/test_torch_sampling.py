"""Parity of the port's HMC transition and AIS pass with fab_tpu on shared noise.

JAX's draws are regenerated by replaying fab_tpu's key splits (ais.py:81,133;
hmc.py:103,107,133,148) and fed to the port. Float64; tolerance 1e-8 (the chain
multiplies small summation-order differences through 5 leapfrog steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.sampling import AnnealedImportanceSampler as JaxAIS
from fab_tpu.sampling import HamiltonianMonteCarlo as JaxHMC
from fab_tpu.sampling import create_point as jax_create_point
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu_torch.convert import transition_state_from_jax
from fab_tpu_torch.sampling import AnnealedImportanceSampler, HamiltonianMonteCarlo
from fab_tpu_torch.sampling import create_point
from fab_tpu_torch.targets import ManyWellEnergy
from torch_parity_utils import NoiseReplay, ais_noise, assert_close, hmc_noise, make_flow_pair, to_np

DIM, BATCH, N_DISTS, TOL = 4, 64, 3, 1e-8
DT = torch.float64


def _setup(fused):
    jax_flow, params, flow = make_flow_pair(DIM, 2, 2, DT, fused=fused)
    hmc_kw = dict(n_ais_intermediate_distributions=N_DISTS, n_outer=2, n_leapfrog=3,
                  epsilon=0.3)
    return jax_flow, params, flow, JaxHMC(**hmc_kw), HamiltonianMonteCarlo(**hmc_kw)


def _assert_state(state, state_j):
    for k in ("epsilons", "common_epsilon", "mass"):
        assert_close(state[k], state_j[k], TOL, k)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_hmc_transition_matches_fab_tpu(fused, monkeypatch):
    with jax.enable_x64():
        jax_flow, params, flow, hmc_j, hmc = _setup(fused)
        target_j = JaxManyWell(DIM)
        x = np.random.default_rng(4).standard_normal((BATCH, DIM)) * 1.5
        mask = np.ones(BATCH, bool)
        mask[:3] = False
        key = jax.random.key(7)
        noise = hmc_noise(key, hmc_j.n_outer, (BATCH, DIM), jnp.float64)
        log_q_j = lambda xx: jax_flow.log_prob(params, xx)

        @jax.jit
        def reference(x):
            point = jax_create_point(x, log_q_j, target_j.log_prob, with_grad=True)
            state = hmc_j.init_state(DIM, jnp.float64)
            out = hmc_j.transition(
                state, key, point, jnp.asarray(0.4), 1, log_q_j, target_j.log_prob,
                2.0, jnp.asarray(mask), True,
            )
            return point, out

        point_j, (new_point_j, state_j, info_j) = to_np(reference(x))

    replay = NoiseReplay(monkeypatch, noise)
    target = ManyWellEnergy(DIM, device="cpu")
    point = create_point(torch.tensor(x), flow.log_prob, target.log_prob, with_grad=True)
    for a, b in zip(point, point_j):
        assert_close(a, b, TOL, "create_point")
    new_point, state, info = hmc.transition(
        hmc.init_state(DIM, DT), None, point, 0.4, 1, flow.log_prob, target.log_prob,
        2.0, torch.tensor(mask), True,
    )
    replay.assert_consumed()
    for name, a, b in zip(new_point._fields, new_point, new_point_j):
        assert_close(a, b, TOL, name)
    _assert_state(state, state_j)
    assert_close(info["p_accept"], info_j["p_accept"], TOL)
    assert_close(info["avg_distance"], info_j["avg_distance"], TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_ais_pass_matches_fab_tpu(fused, monkeypatch):
    with jax.enable_x64():
        jax_flow, params, flow, hmc_j, hmc = _setup(fused)
        target_j = JaxManyWell(DIM)
        ais_j = JaxAIS(jax_flow, target_j.log_prob, hmc_j, N_DISTS)
        key = jax.random.key(11)
        noise = ais_noise(key, N_DISTS, hmc_j.n_outer, BATCH, DIM, jnp.float64)
        state_j0 = to_np(hmc_j.init_state(DIM, jnp.float64))
        result_j = to_np(
            jax.jit(
                lambda p, s: ais_j.sample_and_log_weights(p, s, key, BATCH)
            )(params, state_j0)
        )

    replay = NoiseReplay(monkeypatch, noise)
    target = ManyWellEnergy(DIM, device="cpu")
    ais = AnnealedImportanceSampler(flow, target.log_prob, hmc, N_DISTS)
    result = ais.sample_and_log_weights(transition_state_from_jax(state_j0), None, BATCH)
    replay.assert_consumed()
    assert bool(result.mask.any())
    assert torch.equal(result.mask, torch.tensor(result_j.mask))
    for name, a, b in zip(result.point._fields, result.point, result_j.point):
        assert_close(a, b, TOL, name)
    assert_close(result.log_w, result_j.log_w, TOL, "log_w")
    _assert_state(result.transition_state, result_j.transition_state)
    for k in ("ess_base", "ess_ais", "log_Z", "n_valid", "n_logw_bound_masked"):
        assert_close(result.info[k], result_j.info[k], TOL, k)
    for k in ("p_accept", "avg_distance"):
        assert_close(result.info["transition"][k], result_j.info["transition"][k], TOL, k)
    # The flow's parameters are frozen only during the pass.
    assert all(p.requires_grad for p in flow.parameters())
