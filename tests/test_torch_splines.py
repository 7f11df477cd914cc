"""Parity of the port's spline flow pieces with fab_tpu's, on the CPU in float64.

- ``rational_quadratic_spline`` forward and inverse, log-det, on linear, circular and
  mixed per-dim blocks, with inputs in the tails, on the bound, at knots and near
  +-pi: 1e-10.
- ``SplineCoupling`` and ``PeriodicShift`` with parameters carried by
  ``convert.from_jax_params``: 1e-10 on the linear dims. fab_tpu builds the circular
  bound as a float32 pi, the port as pi in the tensor's dtype, so the circular dims
  differ by about 1e-7 (held to 1e-6); with the port's bound set to fab_tpu's
  float32 pi they agree to 1e-10 as well.
- ``UniformGaussianBase``: log-prob (-inf outside the bound on a circular dim) and
  a replayed draw; the whole ALDP flow's log-prob and sample.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.make_aldp_model import make_aldp_flow as jax_make_aldp_flow
from fab_tpu.flows.base import UniformGaussianBase as JaxUniformGaussianBase
from fab_tpu.flows.splines import PeriodicShift as JaxPeriodicShift
from fab_tpu.flows.splines import SplineCoupling as JaxSplineCoupling
from fab_tpu.flows.splines import rational_quadratic_spline as jax_spline
from fab_tpu_torch.convert import from_jax_params, to_jax_params
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_flow
from fab_tpu_torch.flows import splines
from fab_tpu_torch.flows.base import UniformGaussianBase
from fab_tpu_torch.flows.splines import PeriodicShift, SplineCoupling, rational_quadratic_spline
from torch_parity_utils import NoiseReplay, assert_close, to_np

DT = torch.float64
K = 4
F32_PI = float(np.float32(np.pi))


def _spline_inputs(rng, n, d, bound):
    """Raw spline parameters and inputs: inside, in both tails, on the bounds, and
    at x = 0."""
    raw = [rng.standard_normal((n, d, K)) * 1.5 for _ in range(3)]
    x = rng.uniform(-1.3 * bound, 1.3 * bound, (n, d))
    x[0] = bound
    x[1] = -bound
    x[2] = 0.0
    return raw, x


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("kind", ["linear", "circular", "mixed"])
def test_rational_quadratic_spline_matches_fab_tpu(kind, inverse):
    rng = np.random.default_rng(1)
    n, d = 64, 5
    bound = np.pi if kind == "circular" else 2.5
    (rw, rh, rd), x = _spline_inputs(rng, n, d, bound)
    if kind == "linear":
        rd = rd[..., : K - 1]
        tb, circ_j, circ = 2.5, False, False
    elif kind == "circular":  # fab_tpu's scalar form; the port takes per-dim tensors
        tb, circ_j, circ = np.pi, True, torch.ones(d, dtype=torch.bool)
        tb_np = np.full(d, np.pi)
    else:
        mask = np.array([True, False, True, False, False])
        tb_np = np.where(mask, np.pi, 2.5)
        circ = torch.tensor(mask)
    with jax.enable_x64():
        if kind == "mixed":
            tb, circ_j = jnp.asarray(tb_np), jnp.asarray(mask)
        y_j, ld_j = to_np(jax_spline(*(jnp.asarray(a) for a in (x, rw, rh, rd)), inverse,
                                     tb, circ_j))
    tb_t = 2.5 if kind == "linear" else torch.tensor(tb_np)
    y, ld = rational_quadratic_spline(*(torch.tensor(a) for a in (x, rw, rh, rd)), inverse,
                                      tb_t, circ)
    assert_close(y, y_j, 1e-10, "y")
    assert_close(ld, ld_j, 1e-10, "log_det")
    # Round trip through the other direction, off the bound itself (an image of the
    # bound can round to just outside it, where the map is the identity).
    x_back, ld_back = rational_quadratic_spline(
        y, *(torch.tensor(a) for a in (rw, rh, rd)), not inverse, tb_t, circ)
    assert_close(x_back[2:], x[2:], 1e-9, "round trip")
    assert_close((ld + ld_back)[2:], np.zeros_like(ld_j[2:]), 1e-9, "log-det round trip")


def _coupling_pair(rng, dim, swap, circ_trans, circ_cond, hidden=16):
    jax_bij = JaxSplineCoupling(hidden_units=hidden, n_bins=K, tail_bound=4.0, swap=swap,
                                circular_mask=circ_trans, circular_cond_mask=circ_cond)
    with jax.enable_x64():
        params = to_np(jax_bij.init(jax.random.key(0), dim, jnp.float64))
    # The last layer is zero at init: perturb every leaf so that it matters.
    params = jax.tree.map(lambda a: a + 0.3 * rng.standard_normal(a.shape), params)
    bij = SplineCoupling(dim, hidden, n_bins=K, tail_bound=4.0, swap=swap,
                         circular_mask=circ_trans, circular_cond_mask=circ_cond, dtype=DT)
    bij.load_state_dict({f"mlp.{j}.{k}": torch.tensor(v) for j, layer in
                         enumerate(params["mlp"]) for k, v in layer.items()})
    return jax_bij, params, bij


@pytest.mark.parametrize("swap", [False, True], ids=["first", "swap"])
def test_spline_coupling_matches_fab_tpu(swap, monkeypatch):
    rng = np.random.default_rng(2)
    dim = 7
    d = (dim + 1) // 2
    n_trans, n_cond = (d, dim - d) if swap else (dim - d, d)
    circ_trans = tuple(bool(v) for v in rng.random(n_trans) < 0.5)
    circ_cond = tuple(bool(v) for v in rng.random(n_cond) < 0.5)
    circ_trans = (True,) + circ_trans[1:]  # at least one circular dim
    jax_bij, params, bij = _coupling_pair(rng, dim, swap, circ_trans, circ_cond)
    x = rng.uniform(-3.5, 3.5, (40, dim))
    trans = slice(0, d) if swap else slice(d, dim)
    circ_cols = np.arange(dim)[trans][np.array(circ_trans)]
    lin_cols = np.setdiff1d(np.arange(dim), circ_cols)
    for inverse in (False, True):
        with jax.enable_x64():
            fn = jax_bij.inverse_and_log_det if inverse else jax_bij.forward_and_log_det
            y_j, ld_j = to_np(jax.jit(fn)(params, jnp.asarray(x)))
        fn = bij.inverse_and_log_det if inverse else bij.forward_and_log_det
        y, ld = fn(torch.tensor(x))
        # Linear dims to 1e-10; the circular dims see fab_tpu's float32 pi.
        assert_close(y[:, lin_cols], y_j[:, lin_cols], 1e-10, "linear dims")
        err = np.abs(y.detach().numpy()[:, circ_cols] - y_j[:, circ_cols]).max()
        assert 0 < err < 1e-6, err
        assert_close(ld, ld_j, 1e-5, "log-det")
        # With fab_tpu's float32 pi as the port's bound, every value to 1e-10.
        monkeypatch.setattr(splines, "CIRCULAR_BOUND", F32_PI)
        bij._bounds.clear()
        y, ld = fn(torch.tensor(x))
        assert_close(y, y_j, 1e-10, "y, float32 pi")
        assert_close(ld, ld_j, 1e-10, "log-det, float32 pi")
        monkeypatch.undo()
        bij._bounds.clear()


def test_linear_spline_coupling_and_periodic_shift_match_fab_tpu():
    rng = np.random.default_rng(3)
    dim = 6
    jax_bij, params, bij = _coupling_pair(rng, dim, False, (), ())
    x = rng.uniform(-5, 5, (30, dim))
    with jax.enable_x64():
        y_j, ld_j = to_np(jax.jit(jax_bij.forward_and_log_det)(params, jnp.asarray(x)))
        shift_j = JaxPeriodicShift(circular_dims=(0, 3, 4), shift=2.3)
        s_j = to_np(shift_j.forward_and_log_det({}, jnp.asarray(x)))
        si_j = to_np(shift_j.inverse_and_log_det({}, jnp.asarray(x)))
    y, ld = bij.forward_and_log_det(torch.tensor(x))
    assert_close(y, y_j, 1e-10, "y")
    assert_close(ld, ld_j, 1e-10, "log-det")
    shift = PeriodicShift(dim, (0, 3, 4), 2.3)
    for (a, b), (a_j, b_j) in ((shift.forward_and_log_det(torch.tensor(x)), s_j),
                               (shift.inverse_and_log_det(torch.tensor(x)), si_j)):
        assert_close(a, a_j, 1e-12, "shifted")
        assert_close(b, b_j, 0.0, "zero log-det")
    assert dict(shift.state_dict()) == {}


def test_uniform_gaussian_base_matches_fab_tpu(monkeypatch):
    rng = np.random.default_rng(4)
    dim, circ = 5, (1, 3)
    z = rng.standard_normal((50, dim)) * 2.5
    z[:4, 1] = [np.pi, -np.pi, 3.2, -3.5]  # on and outside the bound
    z[:4, 3] = 0.0
    with jax.enable_x64():
        base_j = JaxUniformGaussianBase(dim=dim, circular_dims=circ)
        lp_j = np.asarray(base_j.log_prob({}, jnp.asarray(z)))
        key = jax.random.key(7)
        z_j, lpz_j = to_np(base_j.sample_and_log_prob({}, key, 16))
        key_g, key_u = jax.random.split(key)
        noise = {"normal": [np.asarray(jax.random.normal(key_g, (16, dim)))],
                 "uniform": [np.asarray(jax.random.uniform(key_u, (16, dim)))]}
    base = UniformGaussianBase(dim, circ, dtype=DT)
    lp = base.log_prob(torch.tensor(z))
    assert np.isneginf(lp_j[2:4]).all() and np.isfinite(lp_j[:2]).all()
    assert_close(lp, lp_j, 1e-12, "log_prob")
    replay = NoiseReplay(monkeypatch, noise)
    z_s, lp_s = base.sample_and_log_prob(16, None)
    replay.assert_consumed()
    assert_close(z_s, z_j, 1e-12, "sample")
    assert_close(lp_s, lpz_j, 1e-12, "sample log_prob")


def test_aldp_flow_matches_fab_tpu(monkeypatch):
    """The ALDP flow at a small size (3 blocks, hidden 16, 4 bins, random shifts):
    parameters carried across, log-prob and a replayed sample; and back through
    ``to_jax_params`` (the periodic shifts have no parameters)."""
    rng = np.random.default_rng(5)
    dim, circ = 12, (1, 4, 5, 8, 11)
    kw = dict(n_blocks=3, hidden_units=16, n_bins=K, seed=3)
    jax_flow = jax_make_aldp_flow(dim, circ, **kw)
    with jax.enable_x64():
        params = to_np(jax_flow.init(jax.random.key(1), jnp.float64))
    params = jax.tree.map(lambda a: a + 0.2 * rng.standard_normal(a.shape), params)
    flow = make_aldp_flow(dim, circ, dtype=DT, device="cpu", **kw)
    flow.load_state_dict(from_jax_params(params))
    monkeypatch.setattr(splines, "CIRCULAR_BOUND", F32_PI)  # fab_tpu's float32 pi
    x = rng.standard_normal((20, dim))
    x[:, list(circ)] = rng.uniform(-np.pi, np.pi, (20, len(circ)))
    with jax.enable_x64():
        lp_j = np.asarray(jax.jit(jax_flow.log_prob)(params, jnp.asarray(x)))
        key = jax.random.key(2)
        xs_j, lqs_j = to_np(jax.jit(jax_flow.sample_and_log_prob, static_argnums=2)(
            params, key, 8))
        key_g, key_u = jax.random.split(key)
        noise = {"normal": [np.asarray(jax.random.normal(key_g, (8, dim)))],
                 "uniform": [np.asarray(jax.random.uniform(key_u, (8, dim)))]}
    assert_close(flow.log_prob(torch.tensor(x)), lp_j, 1e-10, "log_prob")
    replay = NoiseReplay(monkeypatch, noise)
    xs, lqs = flow.sample_and_log_prob(8, None)
    replay.assert_consumed()
    assert_close(xs, xs_j, 1e-10, "sample")
    assert_close(lqs, lqs_j, 1e-9, "sample log_q")
    back = to_jax_params(flow.state_dict(), len(flow.bijectors))
    assert len(back["layers"]) == len(params["layers"]) and back["base"] == {}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
