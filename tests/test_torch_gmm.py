"""Parity of the port's GMM and Gaussian targets, their metrics and the numerical
helpers with fab_tpu (CPU, float64).

The GMM's means are torch-seeded constants (``utils/seeding.py``) and must be the
same bits in both packages. Draws (component indices, normals) are regenerated by
replaying fab_tpu's key splits and fed to the port. Tolerance 1e-10: the same
float64 arithmetic, summed in other orders.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.targets import GMM as JaxGMM
from fab_tpu.targets import Gaussian as JaxGaussian
from fab_tpu.utils import numerical as jax_num
from fab_tpu.utils import seeding as jax_seeding
from fab_tpu_torch.targets import GMM, Gaussian
from fab_tpu_torch.utils import numerical, seeding
from torch_parity_utils import NoiseReplay, assert_close

TOL = 1e-10
DT = torch.float64


def _gmm_pair(**kw):
    with jax.enable_x64():
        target_j = JaxGMM(dtype=jnp.float64, true_expectation_estimation_n_samples=1000, **kw)
    target = GMM(dtype=DT, true_expectation_estimation_n_samples=1000, device="cpu", **kw)
    return target_j, target


def _sample_noise(key, n, n_mixes, dim, dtype):
    """The draws of fab_tpu's GMM.sample(key, n): component indices, then normals."""
    key_comp, key_eps = jax.random.split(key)
    return {"randint": [np.asarray(jax.random.randint(key_comp, (n,), 0, n_mixes))],
            "normal": [np.asarray(jax.random.normal(key_eps, (n, dim), dtype))]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_gmm_means_are_the_same_bits(dtype):
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    with jax.enable_x64(dtype == torch.float64):
        target_j = JaxGMM(dtype=jdt, true_expectation_estimation_n_samples=1000)
    target = GMM(dtype=dtype, true_expectation_estimation_n_samples=1000, device="cpu")
    assert target.locs.numpy().tobytes() == np.asarray(target_j.locs).tobytes()
    assert target.scales.numpy().tobytes() == np.asarray(target_j.scales).tobytes()
    np.testing.assert_array_equal(seeding.gmm_mean_draws(40, 2, 0),
                                  jax_seeding.gmm_mean_draws(40, 2, 0))
    for got, want in zip(seeding.quadratic_constants(5, 3), jax_seeding.quadratic_constants(5, 3)):
        np.testing.assert_array_equal(got, want)


def test_gmm_log_prob_matches_fab_tpu():
    target_j, target = _gmm_pair(dim=2, n_mixes=40, loc_scaling=40.0)
    x = np.random.default_rng(0).standard_normal((256, 2)) * 40
    x[:4] = 1e4  # far out: log-prob below -1e4 is masked to -inf in both
    with jax.enable_x64():
        want = np.asarray(target_j.log_prob(jnp.asarray(x)))
    got = target.log_prob(torch.tensor(x))
    assert np.isinf(want[:4]).all() and torch.isinf(got[:4]).all()
    assert_close(got[4:], want[4:], TOL)


def test_gmm_sample_and_true_expectation_on_replayed_draws(monkeypatch):
    target_j, target = _gmm_pair(dim=2, n_mixes=40, loc_scaling=40.0)
    key = jax.random.key(1)
    with jax.enable_x64():
        want = np.asarray(target_j.sample(key, 64))
        noise = _sample_noise(key, 64, 40, 2, jnp.float64)
        # Three chunks of 100 exact samples, as mc_estimate_true_expectation draws them.
        key_e = jax.random.key(2)
        want_e = float(jax_num.mc_estimate_true_expectation(
            target_j.sample, jax_num.quadratic_function, 300, key_e, batch_size=100))
        for key_i in jax.random.split(key_e, 3):
            for kind, draws in _sample_noise(key_i, 100, 40, 2, jnp.float64).items():
                noise[kind] += draws
    replay = NoiseReplay(monkeypatch, noise)
    assert_close(target.sample(None, 64), want, 0.0)
    got_e = numerical.mc_estimate_true_expectation(
        target.sample, numerical.quadratic_function, 300, None, batch_size=100)
    replay.assert_consumed()
    assert_close(got_e, want_e, TOL)


@pytest.mark.parametrize("with_log_q", [False, True], ids=["weights", "with_log_q"])
def test_gmm_performance_metrics_match_fab_tpu(with_log_q, monkeypatch):
    """Same samples, weights, mask and true expectation; with log q, the same test
    set (replayed draws), one row of which has a non-finite log q and is counted."""
    target_j, target = _gmm_pair(dim=2, n_mixes=40, loc_scaling=40.0)
    target.true_expectation = torch.tensor(float(target_j.true_expectation), dtype=DT)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((200, 2)) * 30
    log_w = rng.standard_normal(200) * 2
    mask = rng.random(200) > 0.1
    key = jax.random.key(4)

    def log_q_j(xx):
        lq = -0.5 * jnp.sum((xx / 30) ** 2, -1)
        return jnp.where(jnp.arange(xx.shape[0]) == 5, -jnp.inf, lq)

    def log_q(xx):
        lq = -0.5 * ((xx / 30) ** 2).sum(-1)
        return torch.where(torch.arange(xx.shape[0]) == 5, -math.inf, lq)

    with jax.enable_x64():
        info_j = target_j.performance_metrics(
            jnp.asarray(x), jnp.asarray(log_w), log_q_j if with_log_q else None,
            mask=jnp.asarray(mask), key=key)
        noise = _sample_noise(key, 1000, 40, 2, jnp.float64)
    replay = NoiseReplay(monkeypatch, noise if with_log_q else {})
    info = target.performance_metrics(
        torch.tensor(x), torch.tensor(log_w), log_q if with_log_q else None,
        mask=torch.tensor(mask), generator=None)
    replay.assert_consumed()
    assert set(info) == set(info_j)
    for k in info:
        assert_close(info[k], info_j[k], TOL, k)
    if with_log_q:
        assert int(info["test_set_n_nonfinite"]) == 1


def test_gaussian_matches_fab_tpu(monkeypatch):
    rng = np.random.default_rng(5)
    loc, scale = rng.standard_normal(3), np.exp(0.3 * rng.standard_normal(3))
    x, log_w = rng.standard_normal((50, 3)), rng.standard_normal(50)
    key = jax.random.key(6)
    with jax.enable_x64():
        target_j = JaxGaussian(jnp.asarray(loc), jnp.asarray(scale), n_test_set_samples=40)
        lp_j = np.asarray(target_j.log_prob(jnp.asarray(x)))
        info_j = target_j.performance_metrics(
            jnp.asarray(x), jnp.asarray(log_w), lambda xx: -0.5 * jnp.sum(xx**2, -1), key=key)
        draws = np.asarray(jax.random.normal(key, (40, 3), jnp.float64))
    target = Gaussian(torch.tensor(loc), torch.tensor(scale), n_test_set_samples=40)
    assert_close(target.log_prob(torch.tensor(x)), lp_j, TOL)
    replay = NoiseReplay(monkeypatch, {"normal": [draws]})
    info = target.performance_metrics(torch.tensor(x), torch.tensor(log_w),
                                      lambda xx: -0.5 * (xx**2).sum(-1),
                                      generator=torch.Generator())
    replay.assert_consumed()
    assert set(info) == set(info_j)
    for k in info:
        assert_close(info[k], info_j[k], TOL, k)


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "masked"])
def test_numerical_helpers_match_fab_tpu(masked):
    rng = np.random.default_rng(7)
    x, log_w = rng.standard_normal((64, 5)), rng.standard_normal(64)
    mask = rng.random(64) > 0.3 if masked else None
    with jax.enable_x64():
        jm = None if mask is None else jnp.asarray(mask)
        want = [
            jax_num.effective_sample_size_over_p(jnp.asarray(log_w) - 3, jm),
            jax_num.importance_weighted_expectation(
                jax_num.quadratic_function, jnp.asarray(x), jnp.asarray(log_w), jm),
            jax_num.quadratic_function(jnp.asarray(x), seed=2),
        ]
    tm = None if mask is None else torch.tensor(mask)
    got = [
        numerical.effective_sample_size_over_p(torch.tensor(log_w) - 3, tm),
        numerical.importance_weighted_expectation(
            numerical.quadratic_function, torch.tensor(x), torch.tensor(log_w), tm),
        numerical.quadratic_function(torch.tensor(x), seed=2),
    ]
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w), TOL)
