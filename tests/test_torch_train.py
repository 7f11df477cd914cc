"""Parity of the port's target, buffer, guarded update and one full
prioritised-buffer train step with fab_tpu, on shared inputs and shared noise.

Tolerances: float64 1e-10 for single functions, 1e-8 for the whole step (AIS with
HMC, a buffer draw and two Adam steps compound summation-order differences);
float32 1e-5 (relative) for the target.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.buffer import PrioritisedReplayBuffer as JaxBuffer
from fab_tpu.targets import LogGaussianCoxProcess as JaxLGCP
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu.train import guarded_update as jax_guarded_update
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.flows import make_realnvp as port_make_realnvp
from fab_tpu_torch.flows.fused import FusedPass, FusedRealNVPFlow
from fab_tpu_torch.flows import LargeFusedCoupling
from fab_tpu_torch.targets import LogGaussianCoxProcess, ManyWellEnergy
from fab_tpu_torch.train import guarded_update, make_optimizer
from torch_parity_utils import (
    NoiseReplay,
    assert_buffer,
    assert_close,
    check_train_step,
    make_flow_pair,
    random_buffer_inputs,
    to_np,
)

DT = torch.float64


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_many_well_log_prob_and_grad(dtype):
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    x = np.random.default_rng(5).standard_normal((128, 32)) * 2.0
    x = x.astype(np.float64 if dtype == torch.float64 else np.float32)
    with jax.enable_x64(dtype == torch.float64):
        target_j = JaxManyWell(32)
        lp_j, g_j = jax.vmap(jax.value_and_grad(lambda xi: target_j.log_prob(xi)))(x)
        modes_j = np.asarray(target_j.modes_test_set())
    target = ManyWellEnergy(32, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    lp = target.log_prob(xt)
    (g,) = torch.autograd.grad(lp.sum(), xt)
    np.testing.assert_allclose(lp.detach().numpy(), lp_j, rtol=tol, atol=tol)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=tol, atol=tol)
    assert target.log_z == pytest.approx(target_j.log_z, rel=1e-12)
    np.testing.assert_array_equal(target.modes_test_set().numpy(), modes_j)


def test_buffer_add_sample_adjust_match_fab_tpu(monkeypatch):
    """Ring add (with wrap-around), shared-Gumbel top-k draw, and adjust."""
    rng = np.random.default_rng(6)
    dim, size = 3, 96
    with jax.enable_x64():
        buf_j = JaxBuffer(dim=dim, max_length=size, min_sample_length=32)
        state_j = buf_j.init(jnp.float64)
        adds = [random_buffer_inputs(rng, 40, dim) for _ in range(3)]  # wraps
        for x, lw, lq, m in adds:
            state_j = buf_j.add(state_j, x, lw, lq, m)
        key = jax.random.key(3)
        gumbel = np.asarray(jax.random.gumbel(key, (size,), jnp.float64))
        xs_j, lws_j, lqs_j, idx_j = buf_j.sample_n_batches(state_j, key, 16, 6)
        adj = rng.standard_normal(16)
        adj[2] = np.nan  # killed row
        lq_new = rng.standard_normal(16)
        adjusted_j = buf_j.adjust(state_j, adj, lq_new, idx_j[0])

    buf = PrioritisedReplayBuffer(dim=dim, max_length=size, min_sample_length=32)
    state = buf.init(DT, "cpu")
    for x, lw, lq, m in adds:
        state = buf.add(state, *(torch.tensor(a) for a in (x, lw, lq, m)))
    assert_buffer(state, to_np(state_j), 0)

    NoiseReplay(monkeypatch, {"gumbel": [gumbel]})
    xs, lws, lqs, idx = buf.sample_n_batches(state, None, 16, 6)
    # Only the finite rows are ordered; ties among -inf rows may break differently.
    n_finite = int(np.isfinite(np.asarray(state_j.log_w)).sum())
    flat, flat_j = idx.reshape(-1).numpy(), np.asarray(idx_j).reshape(-1)
    assert 0 < n_finite < 96  # the draw reaches into the -inf rows
    np.testing.assert_array_equal(flat[:n_finite], flat_j[:n_finite])
    for a, b in ((xs, xs_j), (lws, lws_j), (lqs, lqs_j)):
        np.testing.assert_array_equal(
            a.reshape(96, -1)[:n_finite].numpy(), np.asarray(b).reshape(96, -1)[:n_finite]
        )
    adjusted = buf.adjust(state, torch.tensor(adj), torch.tensor(lq_new), idx[0])
    assert_buffer(adjusted, to_np(adjusted_j), 1e-12)
    assert_buffer(state, to_np(state_j), 0)  # adjust returned a new state


def test_guarded_update_matches_jax_optimizer():
    """Clipped Adam with NaN guard on shared grads: a clipped step, a skipped NaN
    step (state and count unchanged), then an unclipped step."""
    rng = np.random.default_rng(8)
    shapes = [(3, 4), (4,), (2,)]
    params0 = [rng.standard_normal(s) for s in shapes]
    grads_seq = [
        [50.0 * rng.standard_normal(s) for s in shapes],  # above max norm: clipped
        [np.full(s, np.nan) for s in shapes],  # skipped
        [0.1 * rng.standard_normal(s) for s in shapes],
    ]
    with jax.enable_x64():
        opt_j = jax_make_optimizer(1e-2, 5.0)
        p_j = [jnp.asarray(p) for p in params0]
        s_j = opt_j.init(p_j)
        applied_j = []
        for grads in grads_seq:
            p_j, s_j, gn_j, ok_j = jax_guarded_update(
                opt_j, [jnp.asarray(g) for g in grads], s_j, p_j, jnp.asarray(1.0)
            )
            applied_j.append(bool(ok_j))
        adam_j = s_j[1][0]

    opt = make_optimizer(1e-2, 5.0)
    params = [torch.tensor(p) for p in params0]
    state = opt.init(params)
    applied = []
    for grads in grads_seq:
        state, gn, ok = guarded_update(
            opt, [torch.tensor(g) for g in grads], state, params, torch.tensor(1.0)
        )
        applied.append(bool(ok))
    assert applied == applied_j == [True, False, True]
    assert int(state.count) == int(adam_j.count) == 2
    for a, b in zip(params, p_j):
        assert_close(a, b, 1e-12)
    for a, b in zip(state.mu + state.nu, list(adam_j.mu) + list(adam_j.nu)):
        assert_close(a, b, 1e-12)


def test_prioritised_buffer_train_step_matches_fab_tpu(monkeypatch):
    """One full PrioritisedBufferTrainer step in float64 on shared noise: flow
    params, optimizer state, HMC state and buffer state agree to 1e-8."""
    _check_train_step(monkeypatch, fused=False)


def test_fused_prioritised_buffer_train_step_matches_fab_tpu(monkeypatch):
    """The same step with the port's FusedRealNVPFlow (the main path's route: K1
    passes, recomputed backward, stacked-parameter gradients) against fab_tpu's
    plain flow, which computes the same function."""
    _check_train_step(monkeypatch, fused=True)


def test_lgcp_fused_coupling_train_step_matches_fab_tpu(monkeypatch):
    """The same step on a small LGCP (grid 8, 2 layers of width 128, scale cap 5,
    2 distributions, batch 32) with the fused_coupling flow. In f64 both packages
    take LargeFusedCoupling's plain path over the padded last layer."""
    dim, batch, n_dists = 64, 32, 2
    hmc_kw = dict(n_ais_intermediate_distributions=n_dists, n_leapfrog=3, epsilon=0.1)
    with jax.enable_x64():
        flow_pair = make_flow_pair(dim, 2, 2, DT, seed=4, scale_cap=5.0,
                                   fused_coupling=True)
        target_j = JaxLGCP(grid_size=8, dtype=jnp.float64)
    assert isinstance(flow_pair[2].bijectors[0], LargeFusedCoupling)
    assert flow_pair[2].bijectors[0].mlp[-1].w.shape == (128, 128)
    check_train_step(
        monkeypatch, flow_pair,
        (target_j, LogGaussianCoxProcess(grid_size=8, dtype=DT, device="cpu")),
        dim, batch, n_dists, n_batches=2, hmc_kw=hmc_kw,
    )


def test_lgcp_consecutive_train_steps_match_fab_tpu(monkeypatch):
    """Five consecutive steps of the same grid-8 LGCP trainer (plain couplings),
    each on its own shared noise, at lgcp.yaml's HMC step size 0.2 and lr 1e-3:
    n_valid equal after every step, the flow parameters and the logged loss,
    gradient norm and AIS ESS to 1e-8 after every step, and the optimizer, HMC and
    buffer states after the last. A one-step check cannot show a divergence that
    grows over steps. Here the valid rows fall over the steps (28 of 32 after the
    first, 18 after the fifth) in both packages alike, as LGCP-1600's do at lr 3e-5
    (at lr 1e-2 every row is masked from the second step on)."""
    dim, batch, n_dists, n_steps = 64, 32, 2, 5
    hmc_kw = dict(n_ais_intermediate_distributions=n_dists, n_leapfrog=3, epsilon=0.2)
    with jax.enable_x64():
        flow_pair = make_flow_pair(dim, 2, 2, DT, seed=6, scale_cap=5.0)
        target_j = JaxLGCP(grid_size=8, dtype=jnp.float64)
    info, new, info_j, new_j = check_train_step(
        monkeypatch, flow_pair,
        (target_j, LogGaussianCoxProcess(grid_size=8, dtype=DT, device="cpu")),
        dim, batch, n_dists, n_batches=2, hmc_kw=hmc_kw, n_steps=n_steps, lr=1e-3,
    )
    assert new.step == n_steps == int(new_j.step)
    assert int(info["n_valid"]) < batch


def _check_train_step(monkeypatch, fused):
    dim, batch, n_dists = 4, 64, 2
    hmc_kw = dict(n_ais_intermediate_distributions=n_dists, n_leapfrog=3, epsilon=0.3)
    with jax.enable_x64():
        jax_flow, params, flow = make_flow_pair(dim, 2, 2, DT, seed=2)
        target_j = JaxManyWell(dim)
    if fused:
        plain, flow = flow, port_make_realnvp(
            dim, n_flow_layers=2, layer_nodes_per_dim=2, fused=True, dtype=DT,
            device="cpu",
        )
        flow.load_state_dict(plain.state_dict())
        assert isinstance(flow, FusedRealNVPFlow)
    recomputes = FusedPass.recomputes
    check_train_step(
        monkeypatch, (jax_flow, params, flow),
        (target_j, ManyWellEnergy(dim, device="cpu")),
        dim, batch, n_dists, n_batches=2, hmc_kw=hmc_kw,
    )
    # HMC's gradients and the replay steps differentiate through FusedPass.
    assert (FusedPass.recomputes > recomputes) == fused
