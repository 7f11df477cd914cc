"""Exact sampling and ManyWell's evaluation metrics in the port (CPU).

- Rejection sampling's accept-and-scatter logic against fab_tpu's on shared
  proposals and uniforms (replayed key splits; the output is the same numbers).
- ManyWellEnergy.sample: the first dimension of every well against its density by
  quadrature (mean and variance within 3 standard errors), the second N(0, 1).
- ManyWellEnergy.performance_metrics against fab_tpu's on the same weights and the
  same exact samples (float64, 1e-10), and the random mode test set for D >= 40.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.sampling.rejection import rejection_sampling as jax_rejection_sampling
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu_torch import random
from fab_tpu_torch.sampling.rejection import rejection_sampling
from fab_tpu_torch.targets import ManyWellEnergy
from torch_parity_utils import NoiseReplay, assert_close


def test_rejection_sampling_scatters_the_same_draws(monkeypatch):
    """A N(0, 1) target under a 2 N(0, 1) envelope: the accepted draws fill the
    buffer in draw order over several batches, the last batch's surplus dropped."""
    n, k = 50, 2.5

    def target_log_prob(x):
        return -0.5 * x**2

    def proposal_log_prob(x):
        return -0.5 * (x / 2) ** 2 - math.log(2.0)

    key = jax.random.key(3)
    with jax.enable_x64():
        want = np.asarray(jax_rejection_sampling(
            key, n, lambda kk, m: 2 * jax.random.normal(kk, (m,), jnp.float64),
            proposal_log_prob, target_log_prob, k, batch_multiplier=1))
        noise = {"normal": [], "uniform": []}
        for _ in range(12):  # more batches than the loop needs
            key, key_prop, key_u = jax.random.split(key, 3)
            noise["normal"].append(np.asarray(jax.random.normal(key_prop, (n,), jnp.float64)))
            noise["uniform"].append(np.asarray(jax.random.uniform(key_u, (n,), jnp.float64)))
    n_batches = next(i for i in range(1, 13) if sum(
        int((np.log(u) < target_log_prob(2 * z) - proposal_log_prob(2 * z) - math.log(k)).sum())
        for z, u in zip(noise["normal"][:i], noise["uniform"][:i])) >= n)
    assert n_batches > 1
    replay = NoiseReplay(monkeypatch, noise)
    got = rejection_sampling(
        None, n, lambda gen, m: 2 * random.normal(gen, (m,), torch.float64, "cpu"),
        proposal_log_prob, target_log_prob, k, batch_multiplier=1)
    assert_close(got, want, 0.0)
    assert len(replay.queues["normal"]) == len(replay.queues["uniform"]) == 12 - n_batches


def _first_dim_moments():
    """Mean, variance and 4th central moment of exp(-x^4 + 6 x^2 + 0.5 x) by
    quadrature."""
    x = np.linspace(-4, 4, 400_001)
    p = np.exp(-(x**4) + 6 * x**2 + 0.5 * x)
    p /= np.trapezoid(p, x)
    mean = np.trapezoid(x * p, x)
    var = np.trapezoid((x - mean) ** 2 * p, x)
    m4 = np.trapezoid((x - mean) ** 4 * p, x)
    return mean, var, m4


def test_many_well_exact_samples_have_the_right_marginals():
    n, dim = 20_000, 6
    target = ManyWellEnergy(dim, device="cpu")
    x = target.sample(torch.Generator().manual_seed(0), n, torch.float64).numpy()
    assert x.shape == (n, dim) and np.isfinite(x).all()
    mean, var, m4 = _first_dim_moments()
    for x1 in x[:, 0::2].T:
        assert abs(x1.mean() - mean) < 3 * math.sqrt(var / n)
        assert abs(x1.var() - var) < 3 * math.sqrt((m4 - var**2) / n)
    for x2 in x[:, 1::2].T:
        assert abs(x2.mean()) < 3 / math.sqrt(n) and abs(x2.var() - 1) < 3 * math.sqrt(2 / n)


@pytest.mark.parametrize("with_log_q", [False, True], ids=["log_z", "with_log_q"])
def test_many_well_performance_metrics_match_fab_tpu(with_log_q):
    """The same weights (some masked) and, with log q, the same exact samples in
    both packages (each target's ``sample`` returns the shared array)."""
    dim, n = 8, 1000
    rng = np.random.default_rng(4)
    log_w = rng.standard_normal(n) * 2 + 4 * math.log(11784.50927 * math.sqrt(2 * math.pi))
    mask = rng.random(n) > 0.1
    x_exact = rng.standard_normal((200, dim))
    target_j, target = JaxManyWell(dim), ManyWellEnergy(dim, device="cpu")
    target_j.sample = lambda key, m: jnp.asarray(x_exact[:m])
    target.sample = lambda gen, m, dtype: torch.tensor(x_exact[:m], dtype=dtype)

    def log_q_j(x):  # float64, as a float64 flow promotes the float32 mode set
        return -0.5 * jnp.sum(x.astype(jnp.float64) ** 2, -1)

    def log_q(x):
        return -0.5 * (x**2).sum(-1)

    with jax.enable_x64():
        info_j = target_j.performance_metrics(
            jnp.zeros((n, dim)), jnp.asarray(log_w), log_q_j if with_log_q else None,
            batch_size=200, mask=jnp.asarray(mask), key=jax.random.key(0))
    info = target.performance_metrics(
        torch.zeros((n, dim), dtype=torch.float64), torch.tensor(log_w),
        log_q if with_log_q else None, batch_size=200, mask=torch.tensor(mask),
        generator=torch.Generator())
    assert set(info) == set(info_j)
    for k in info:
        assert_close(info[k], info_j[k], 1e-10, k)


def test_random_mode_test_set_on_replayed_draws(monkeypatch):
    """D >= 40: n random sign patterns on the even dims, at +-1.7."""
    key = jax.random.key(5)
    want = np.asarray(JaxManyWell(40).modes_test_set(key, n=30))
    signs = np.asarray(jax.random.randint(key, (30, 20), 0, 2))
    replay = NoiseReplay(monkeypatch, {"randint": [signs]})
    got = ManyWellEnergy(40, device="cpu").modes_test_set(torch.Generator(), n=30)
    replay.assert_consumed()
    assert_close(got, want, 0.0)
