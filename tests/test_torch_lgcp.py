"""Parity of the port's LGCP target with fab_tpu (CPU): the synthetic data, the
Cholesky factor, log_prob and its x-gradient (at grid 8 and at the full grid 40),
both branches of the f32 overflow guard, and the performance metrics.

Tolerances: the counts and the factor are built by the same numpy code, so they are
equal; float64 1e-10 (summation order only); float32 rtol 1e-5 against the value's
scale (1600-term f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.targets import LogGaussianCoxProcess as JaxLGCP
from fab_tpu_torch.targets import LogGaussianCoxProcess
from torch_parity_utils import JAX_DTYPE, NP_DTYPE, assert_close, assert_close_to_scale


def _pair(grid, dtype):
    with jax.enable_x64(dtype == torch.float64):
        target_j = JaxLGCP(grid_size=grid, dtype=JAX_DTYPE[dtype])
    return target_j, LogGaussianCoxProcess(grid_size=grid, dtype=dtype, device="cpu")


def _value_and_grad_j(target_j, e, dtype):
    with jax.enable_x64(dtype == torch.float64):
        lp, g = jax.vmap(jax.value_and_grad(lambda ei: target_j.log_prob(ei)))(e)
        return np.asarray(lp), np.asarray(g)


def _value_and_grad(target, e):
    et = torch.tensor(e, requires_grad=True)
    lp = target.log_prob(et)
    (g,) = torch.autograd.grad(lp.sum(), et)
    return lp.detach().numpy(), g.numpy()


@pytest.mark.parametrize("grid", [8, 40])
def test_data_and_factor_match_fab_tpu(grid):
    target_j, target = _pair(grid, torch.float64)
    np.testing.assert_array_equal(target.chol_np, target_j.chol_np)
    np.testing.assert_array_equal(target.counts.numpy(), np.asarray(target_j.counts))
    np.testing.assert_array_equal(target._x_true.numpy(), np.asarray(target_j._x_true))
    assert target.dim == target_j.dim == grid * grid
    assert target.mu == target_j.mu and target.cell_area == target_j.cell_area


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("grid", [8, 40])
def test_log_prob_and_grad_match_fab_tpu(grid, dtype):
    target_j, target = _pair(grid, dtype)
    e = np.random.default_rng(grid).standard_normal((16, grid * grid)).astype(NP_DTYPE[dtype])
    lp_j, g_j = _value_and_grad_j(target_j, e, dtype)
    lp, g = _value_and_grad(target, e)
    assert lp.dtype == NP_DTYPE[dtype]
    if dtype == torch.float64:
        assert_close(lp, lp_j, 1e-10, "log_prob")
        assert_close(g, g_j, 1e-10, "grad")
    else:
        assert_close_to_scale(lp, lp_j, 1e-5, "log_prob")
        assert_close_to_scale(g, g_j, 1e-5, "grad")


def test_overflow_guard_branches_match_fab_tpu():
    """Fields past x = 80 (linear continuation) and past x = 1080 (capped) stay
    finite in f32 and agree with fab_tpu, value and gradient."""
    target_j, target = _pair(8, torch.float32)
    # Aim the field at chosen values: x = mu + L e, so e = L^-1 (x - mu).
    fields = np.full((3, 64), target.mu)
    fields[0, 5] = 85.0  # linear branch
    fields[1, 9] = 2000.0  # overshoot capped at 1e3
    fields[2, :] = 90.0 + np.arange(64)  # many cells in the linear branch
    e = np.linalg.solve(target.chol_np, (fields - target.mu).T).T.astype(np.float32)
    lp_j, g_j = _value_and_grad_j(target_j, e, torch.float32)
    lp, g = _value_and_grad(target, e)
    assert np.isfinite(lp).all() and np.isfinite(g).all()
    x = target.latent_to_field(torch.tensor(e)).numpy()
    assert (x > 80).any(axis=1).all() and (x - 80 > 1e3).any()
    assert_close_to_scale(lp, lp_j, 1e-5, "log_prob")
    assert_close_to_scale(g, g_j, 1e-5, "grad")


def test_performance_metrics_match_fab_tpu():
    with jax.enable_x64():
        target_j, target = _pair(8, torch.float64)
        rng = np.random.default_rng(4)
        e = rng.standard_normal((32, 64))
        log_w = rng.standard_normal(32)
        mask = rng.random(32) > 0.25
        log_q = lambda x: -0.5 * jnp.sum(x**2, -1)
        info_j = target_j.performance_metrics(
            jnp.asarray(e), jnp.asarray(log_w), log_q, mask=jnp.asarray(mask)
        )
        info_j_plain = target_j.performance_metrics(jnp.asarray(e), jnp.asarray(log_w))
    info = target.performance_metrics(
        torch.tensor(e), torch.tensor(log_w), lambda x: -0.5 * (x**2).sum(-1),
        mask=torch.tensor(mask),
    )
    assert set(info) == set(info_j)
    for k in info:
        assert_close(info[k], info_j[k], 1e-10, k)
    info_plain = target.performance_metrics(torch.tensor(e), torch.tensor(log_w))
    assert set(info_plain) == set(info_j_plain) == {
        "post_mean_field_rmse", "post_mean_log_intensity"
    }
    for k in info_plain:
        assert_close(info_plain[k], info_j_plain[k], 1e-10, k)


def test_sample_prior_is_standard_normal_from_the_generator():
    target = LogGaussianCoxProcess(grid_size=8, device="cpu")
    draw = lambda: target.sample_prior(torch.Generator().manual_seed(3), 4096)
    e = draw()
    assert e.shape == (4096, 64) and e.dtype == torch.float32
    assert torch.equal(e, draw())
    assert abs(float(e.mean())) < 0.01 and abs(float(e.std()) - 1.0) < 0.01
