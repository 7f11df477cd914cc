"""Parity of the port's LARS resampled base and stochastic normalizing flows with
fab_tpu (CPU), on shared parameters and replayed JAX noise.

- ``ResampledGaussianBase``: ``log_prob`` with a perturbed acceptance net (a(z) is
  not 1/2) and its gradients (Z detached in both); ``sample_and_log_prob`` on the
  replayed initial proposal and T-1 (normal, uniform) rounds, never-accepted rows
  keeping the initial proposal; fab_tpu's float64 draw of an f32 base under x64,
  pinned; the density integrating to 1.
- ``MetropolisSamplingLayer`` forward and inverse on replayed noise (the log-det
  is log pi(start) - log pi(end)); one lam = 1 layer telescoping to the AIS
  identity.
- ``StochasticFlow`` / ``make_snf_model``: ``sample_and_log_prob``, keyed
  ``log_prob``, and log q's x- and parameter-gradients through the chain.
- Keys: one key gives the same noise on every call, ``split`` moves its parent, a
  deterministic flow gets no key and draws nothing; a keyless ``log_prob`` and
  ``forward_kl_loss`` raise ``ValueError``.
- ``convert`` round trips of a LARS flow and an SNF.
- Whole f64 steps with the noise held per role: ``PrioritisedBufferTrainer``,
  ``BufferTrainer`` and ``Trainer`` with an SNF (1e-8; a log-q call that drew a key
  of its own fails the keyed replay), and ``Trainer`` with a LARS base; each eager,
  through ``make_train_step`` (against fab_tpu's jitted step) and through
  ``make_scanned_train_step`` (against its ``lax.scan``).

Tolerances: f64 1e-10 per function, 1e-8 per whole step; f32 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.buffer import ReplayBuffer as JaxReplayBuffer
from fab_tpu.flows.factory import make_resampled_realnvp as jax_make_resampled_realnvp
from fab_tpu.flows import make_snf_model as jax_make_snf_model
from fab_tpu.flows.resampled import ResampledGaussianBase as JaxResampledBase
from fab_tpu.flows.snf import MetropolisSamplingLayer as JaxMHLayer
from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.sampling import HamiltonianMonteCarlo as JaxHMC
from fab_tpu.targets import Gaussian as JaxGaussian
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu.train import BufferTrainer as JaxBufferTrainer
from fab_tpu.train import BufferTrainState as JaxBufferTrainState
from fab_tpu.train import Trainer as JaxTrainer
from fab_tpu.train import TrainState as JaxTrainState
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu_torch import random as port_random
from fab_tpu_torch.buffer import ReplayBuffer
from fab_tpu_torch.convert import from_jax_params, to_jax_params, transition_state_from_jax
from fab_tpu_torch.flows import (
    MetropolisSamplingLayer,
    ResampledGaussianBase,
    StochasticFlow,
    flow_log_prob,
    log_q_noise,
    make_realnvp,
    make_resampled_realnvp,
    make_snf_model,
)
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.sampling import HamiltonianMonteCarlo
from fab_tpu_torch.targets import Gaussian, ManyWellEnergy
from fab_tpu_torch.train import (
    BufferTrainer,
    BufferTrainState,
    Trainer,
    TrainState,
    make_optimizer,
)
from torch_parity_utils import (
    JAX_DTYPE,
    NoiseReplay,
    ais_noise,
    assert_close,
    base_sample_noise,
    check_train_step,
    flow_sample_noise,
    mh_layer_noise,
    perturbed_jax_flow_params,
    snf_log_prob_noise,
    to_np,
)

F64 = torch.float64
TOL = {torch.float32: 1e-5, torch.float64: 1e-10}


def _x64(dtype):
    """JAX in float64 for the f64 cases; plain float32 JAX for the f32 ones."""
    return jax.enable_x64(dtype == F64)


def _base_pair(dtype, T=10, bias=0.0, seed=0):
    """(fab_tpu base, its perturbed params as numpy, the port's base with them)."""
    base_j = JaxResampledBase(dim=3, hidden_units=8, T=T, n_z_points=64)
    rng = np.random.default_rng(seed)
    params = to_np(base_j.init(JAX_DTYPE[dtype]))
    params = jax.tree.map(lambda p: p + 0.4 * rng.standard_normal(p.shape).astype(p.dtype),
                          params)
    params["accept_net"][-1]["b"] = params["accept_net"][-1]["b"] + np.asarray(
        bias, params["accept_net"][-1]["b"].dtype)
    base = ResampledGaussianBase(3, hidden_units=8, T=T, n_z_points=64, dtype=dtype,
                                 device="cpu")
    state = from_jax_params({"base": params, "layers": ()})
    base.load_state_dict({k.removeprefix("base."): v for k, v in state.items()})
    return base_j, params, base


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_resampled_log_prob_matches_fab_tpu(dtype):
    z = np.random.default_rng(1).standard_normal((50, 3)) * 1.5
    with _x64(dtype):
        base_j, params, base = _base_pair(dtype)
        expected = base_j.log_prob(params, jnp.asarray(z, JAX_DTYPE[dtype]))
        a_j = base_j._accept_prob(params, jnp.asarray(z, JAX_DTYPE[dtype]))
    z_t = torch.tensor(z, dtype=dtype)
    a = base.accept_prob(z_t).detach()
    assert float((a - 0.5).abs().mean()) > 0.05  # the net is perturbed: a(z) != 1/2
    assert_close(a, a_j, TOL[dtype], "a(z)")
    assert_close(base.log_prob(z_t), expected, TOL[dtype], "log_prob")


def test_resampled_gradients_match_fab_tpu():
    """Parameter- and z-gradients of sum(log p); Z is detached in both, so the
    proposal points get none."""
    z = np.random.default_rng(2).standard_normal((40, 3))
    with jax.enable_x64():
        base_j, params, base = _base_pair(F64)
        loss = lambda p, zz: jnp.sum(base_j.log_prob(p, zz))
        g_params, g_z = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(z))
        g_params = to_np(g_params)
    assert not np.any(g_params["z_points"])
    z_t = torch.tensor(z, requires_grad=True)
    grads = torch.autograd.grad(base.log_prob(z_t).sum(), [z_t, *base.parameters()])
    assert_close(grads[0], g_z, 1e-10, "dlogp/dz")
    expected = from_jax_params({"base": g_params, "layers": ()})
    for (name, _), g in zip(base.named_parameters(), grads[1:]):
        assert_close(g, expected["base." + name], 1e-10, name)
    assert [n for n, _ in base.named_buffers()] == ["z_points"]


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_resampled_sample_matches_fab_tpu(dtype, monkeypatch):
    """T = 5 with a low acceptance (bias -3): some rows accept a later proposal, the
    others keep the initial one."""
    n, key = 200, jax.random.key(3)
    with _x64(dtype):
        base_j, params, base = _base_pair(dtype, T=5, bias=-3.0)
        z_j, lp_j = to_np(base_j.sample_and_log_prob(params, key, n))
        noise = base_sample_noise(base_j, key, n, 3, JAX_DTYPE[dtype])
    assert z_j.dtype == np.dtype(JAX_DTYPE[dtype])
    replay = NoiseReplay(monkeypatch, noise)
    z, lp = base.sample_and_log_prob(n, None)
    replay.assert_consumed()
    assert z.dtype == dtype and not z.requires_grad
    assert_close(z, z_j, TOL[dtype], "z")
    assert_close(lp, lp_j, TOL[dtype], "log_prob")
    kept = (z.numpy() == noise["normal"][0].astype(z.numpy().dtype)).all(-1)
    assert 0 < kept.sum() < n


def test_resampled_f32_draw_under_x64_is_pinned(monkeypatch):
    """fab_tpu draws the initial proposal in JAX's default float, so under x64 an
    f32 base returns float64 samples; the port keeps the base's dtype. On the same
    (float64) draws the two agree to f32 rounding."""
    n, key = 100, jax.random.key(4)
    with jax.enable_x64():
        base_j, params, base = _base_pair(torch.float32, T=5, bias=-1.0)
        z_j, lp_j = to_np(base_j.sample_and_log_prob(params, key, n))
        noise = base_sample_noise(base_j, key, n, 3, jnp.float32)
    assert z_j.dtype == np.float64 and noise["normal"][1].dtype == np.float64
    replay = NoiseReplay(monkeypatch, noise)
    z, lp = base.sample_and_log_prob(n, None)
    replay.assert_consumed()
    assert z.dtype == torch.float32
    assert_close(z, z_j, 1e-6, "z")
    assert_close(lp, lp_j, 1e-5, "log_prob")


def test_resampled_density_integrates_to_one():
    base = ResampledGaussianBase(2, hidden_units=8, T=50, n_z_points=4096, dtype=F64,
                                 device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in base.parameters():
            p.add_(0.5 * torch.randn(p.shape, generator=gen, dtype=F64))
        z = torch.randn((100_000, 2), generator=gen, dtype=F64)
        log_phi = -0.5 * (z**2).sum(-1) - np.log(2 * np.pi)
        integral = torch.exp(base.log_prob(z) - log_phi).mean()
    assert abs(float(integral) - 1.0) < 0.05


def test_resampled_base_initialises_from_its_own_seed():
    """z_points and the acceptance net come from the base's z_seed: a flow's
    generator does not move them, and reset gives them back."""
    flow = make_resampled_realnvp(2, n_flow_layers=1, layer_nodes_per_dim=2,
                                  a_hidden_units=8, T=10, dtype=F64, device="cpu")
    points = flow.base.z_points.clone()
    first = flow.base.accept_net[0].w.clone()
    flow.reset_parameters(torch.Generator().manual_seed(123))
    assert torch.equal(flow.base.z_points, points)
    assert torch.equal(flow.base.accept_net[0].w, first)
    assert torch.all(flow.base.accept_net[-1].w == 0)
    other = ResampledGaussianBase(2, hidden_units=8, T=10, z_seed=1, dtype=F64, device="cpu")
    assert not torch.equal(other.z_points, points[: other.z_points.shape[0]])


# -------------------------------------------------------------------- SNF


def _gaussians():
    loc, scale = np.full(3, 1.0), np.full(3, 1.5)
    with jax.enable_x64():
        target_j = JaxGaussian(jnp.asarray(loc), jnp.asarray(scale))
    return target_j, Gaussian(torch.tensor(loc), torch.tensor(scale))


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_mh_layer_matches_fab_tpu(direction, monkeypatch):
    target_j, target = _gaussians()
    x = np.random.default_rng(5).standard_normal((64, 3)) * 2
    key = jax.random.key(6)
    with jax.enable_x64():
        layer_j = JaxMHLayer(target_j.log_prob, lam=0.5, n_steps=4, proposal_scale=0.8)
        fn = getattr(layer_j, f"{direction}_and_log_det")
        y_j, ld_j = to_np(fn({}, key, jnp.asarray(x)))
        noise = mh_layer_noise(key, 4, (64, 3), jnp.float64)
        log_pi_j = to_np(layer_j._log_pi(jnp.asarray(x)) - layer_j._log_pi(y_j))
    layer = MetropolisSamplingLayer(target.log_prob, lam=0.5, n_steps=4, proposal_scale=0.8)
    replay = NoiseReplay(monkeypatch, noise)
    y, ld = getattr(layer, f"{direction}_and_log_det")(torch.tensor(x), None)
    replay.assert_consumed()
    assert_close(y, y_j, 1e-10, "x")
    assert_close(ld, ld_j, 1e-10, "log_det")
    # The sign: log pi(start) - log pi(end).
    assert_close(ld, log_pi_j, 1e-10, "log pi(start) - log pi(end)")
    assert (y != torch.tensor(x)).any(-1).sum() > 32


def test_snf_single_layer_telescopes_to_ais_identity():
    """One MH layer at lam = 1: log p(x) - log q(x) = log p(z0) - log q0(z0) for every
    row, wherever the chain lands (the log-det's sign); E_q[w] = 1 within four
    standard errors."""
    loc, scale = torch.full((2,), 1.0, dtype=F64), torch.full((2,), 1.5, dtype=F64)
    target = Gaussian(loc, scale)
    flow = StochasticFlow(2, [MetropolisSamplingLayer(target.log_prob, 1.0, 20, 0.8)],
                          make_realnvp(2, 1, 2, dtype=F64, device="cpu").base)
    n = 4096
    with torch.no_grad():
        x, log_q = flow.sample_and_log_prob(n, torch.Generator().manual_seed(0))
        z0, log_q0 = flow.base.sample_and_log_prob(n, torch.Generator().manual_seed(0))
    assert (x != z0).any(-1).float().mean() > 0.5
    log_w = target.log_prob(x) - log_q
    assert_close(log_w, target.log_prob(z0) - log_q0, 1e-10, "telescoped log_w")
    w = torch.exp(log_w)
    assert abs(float(w.mean()) - 1.0) < 4 * float(w.std()) / n**0.5  # 4 standard errors


def _snf_pair(target_j, target, seed=7, dim=3, dtype=F64, **kw):
    kw = dict(dict(n_flow_layers=2, layer_nodes_per_dim=2, it_snf_layer=1, mh_steps=3,
                   mh_prop_scale=0.5), **kw)
    flow_j = jax_make_snf_model(dim, target_j.log_prob, **kw)
    params = to_np(perturbed_jax_flow_params(flow_j, seed, JAX_DTYPE[dtype]))
    flow = make_snf_model(dim, target.log_prob, dtype=dtype, device="cpu", **kw)
    flow.load_state_dict(from_jax_params(params))
    return flow_j, params, flow


def test_snf_layers_sit_at_fab_tpu_indexes():
    target_j, target = _gaussians()
    with jax.enable_x64():
        flow_j, params, flow = _snf_pair(target_j, target, n_flow_layers=4, it_snf_layer=2)
    kinds = [type(b).__name__ for b in flow.bijectors]
    assert kinds == [type(b).__name__ for b in flow_j.layers]
    assert [i for i, k in enumerate(kinds) if k == "MetropolisSamplingLayer"] == [4, 9]
    assert [b.lam for b in flow.bijectors if hasattr(b, "lam")] == [0.5, 1.0]
    assert len(params["layers"]) == len(flow.bijectors) and params["layers"][4] == {}


def test_snf_sample_and_log_prob_match_fab_tpu(monkeypatch):
    target_j, target = _gaussians()
    n, key = 64, jax.random.key(8)
    x_in = np.random.default_rng(9).standard_normal((n, 3)) * 1.5
    with jax.enable_x64():
        flow_j, params, flow = _snf_pair(target_j, target)
        x_j, lq_j = to_np(flow_j.sample_and_log_prob(params, key, n))
        lp_j = to_np(flow_j.log_prob(params, jnp.asarray(x_in), key=key))
        sample_noise = flow_sample_noise(flow_j, key, n, 3, jnp.float64)
        lp_noise = snf_log_prob_noise(flow_j, key, (n, 3), jnp.float64)
    replay = NoiseReplay(monkeypatch, sample_noise, keys=[lp_noise])
    x, lq = flow.sample_and_log_prob(n, None)
    key_t = port_random.split(None)
    lp = flow.log_prob(torch.tensor(x_in), key_t)
    lp_again = flow.log_prob(torch.tensor(x_in), key_t)
    replay.assert_consumed()
    assert_close(x, x_j, 1e-10, "x")
    assert_close(lq, lq_j, 1e-10, "sample log q")
    assert_close(lp, lp_j, 1e-10, "log_prob")
    assert torch.equal(lp, lp_again)


def test_snf_log_q_gradients_through_the_chain_match_fab_tpu(monkeypatch):
    """log q's x-gradient (HMC's) and parameter gradients (the FAB loss's) through
    the MH layers, whose selected positions are not detached."""
    target_j, target = _gaussians()
    key = jax.random.key(10)
    x_in = np.random.default_rng(11).standard_normal((32, 3)) * 1.5
    with jax.enable_x64():
        flow_j, params, flow = _snf_pair(target_j, target)
        loss = lambda p, x: jnp.sum(flow_j.log_prob(p, x, key=key))
        g_params, g_x = to_np(jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x_in)))
        lp_noise = snf_log_prob_noise(flow_j, key, (32, 3), jnp.float64)
    replay = NoiseReplay(monkeypatch, {}, keys=[lp_noise])
    x_t = torch.tensor(x_in, requires_grad=True)
    params_t = [p for p in flow.parameters()]
    grads = torch.autograd.grad(flow.log_prob(x_t, port_random.split(None)).sum(),
                                [x_t, *params_t])
    replay.assert_consumed()
    assert_close(grads[0], g_x, 1e-10, "dlogq/dx")
    assert float(np.abs(g_x - (-(x_in - 1.0) / 2.25)).max()) > 1e-3  # not the target's
    expected = from_jax_params(g_params)
    for (name, _), g in zip(flow.named_parameters(), grads[1:]):
        assert_close(g, expected[name], 1e-10, name)


def test_keys_hold_noise_and_deterministic_flows_draw_none():
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    key = port_random.split(gen)
    assert not torch.equal(gen.get_state(), before)  # the parent moved on
    draw = lambda g: port_random.normal(g, (4,), F64, "cpu")
    assert torch.equal(draw(port_random.restart(key)), draw(port_random.restart(key)))
    assert not torch.equal(draw(port_random.restart(key)),
                           draw(port_random.restart(port_random.split(gen))))
    flow = make_realnvp(2, 1, 2, dtype=F64, device="cpu")
    state = gen.get_state()
    assert log_q_noise(flow, gen) is None and torch.equal(gen.get_state(), state)
    target_j, target = _gaussians()
    snf = make_snf_model(3, target.log_prob, 2, 2, it_snf_layer=1, mh_steps=3, dtype=F64,
                         device="cpu")
    x = torch.randn((16, 3), generator=gen, dtype=F64)
    k1, k2 = log_q_noise(snf, gen), log_q_noise(snf, gen)
    assert torch.equal(flow_log_prob(snf, x, k1), flow_log_prob(snf, x, k1))
    assert not torch.equal(flow_log_prob(snf, x, k1), flow_log_prob(snf, x, k2))


def test_keyless_snf_log_prob_and_forward_kl_raise():
    target_j, target = _gaussians()
    snf = make_snf_model(3, target.log_prob, 2, 2, it_snf_layer=1, mh_steps=3, dtype=F64,
                         device="cpu")
    x = torch.randn((16, 3), generator=torch.Generator().manual_seed(0), dtype=F64)
    with pytest.raises(ValueError, match="requires a generator"):
        snf.log_prob(x)
    with pytest.raises(ValueError, match="requires a generator"):
        flow_log_prob(snf, x)
    model = FABModel.create(snf, target, loss_type="target_forward_kl", use_ais=False)
    with pytest.raises(ValueError, match="requires a generator"):
        model.forward_kl_loss(x)
    assert torch.isfinite(model.forward_kl_loss(x, log_q_noise(snf, torch.Generator())))
    fixed = snf.log_prob(x, allow_fixed_key=True)
    assert torch.equal(fixed, snf.log_prob(x, allow_fixed_key=True))
    assert torch.isfinite(fixed).all()
    # fab_tpu raises the same type deeper down.
    with jax.enable_x64():
        flow_j, params, _ = _snf_pair(*_gaussians())
        with pytest.raises(ValueError):
            flow_j.log_prob(params, jnp.asarray(x.numpy()))


def _tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_convert_round_trips_lars_and_snf():
    with jax.enable_x64():
        flow_j = jax_make_resampled_realnvp(3, n_flow_layers=2, layer_nodes_per_dim=2,
                                            act_norm=False, a_hidden_units=8, T=10)
        params = to_np(perturbed_jax_flow_params(flow_j, 12, jnp.float64))
    flow = make_resampled_realnvp(3, n_flow_layers=2, layer_nodes_per_dim=2,
                                  a_hidden_units=8, T=10, dtype=F64, device="cpu")
    flow.load_state_dict(from_jax_params(params))
    assert "base.z_points" in flow.state_dict() and "base.accept_net.2.w" in flow.state_dict()
    _tree_equal(to_jax_params(flow.state_dict(), len(flow.bijectors)), params)
    target_j, target = _gaussians()
    with jax.enable_x64():
        flow_j, params, snf = _snf_pair(target_j, target)
    assert params["layers"][2] == {} and params["layers"][5] == {}
    _tree_equal(to_jax_params(snf.state_dict(), len(snf.bijectors)), params)


# ------------------------------------------------------- whole f64 steps

STEP_HMC = dict(n_ais_intermediate_distributions=2, n_leapfrog=2, epsilon=0.3)


def _many_well_snf():
    dim = 4
    with jax.enable_x64():
        target_j = JaxManyWell(dim)
        flow_j = jax_make_snf_model(dim, target_j.log_prob, n_flow_layers=2,
                                    layer_nodes_per_dim=2, it_snf_layer=1, mh_steps=2,
                                    mh_prop_scale=0.3)
        params = to_np(perturbed_jax_flow_params(flow_j, 13, jnp.float64))
    target = ManyWellEnergy(dim, device="cpu")
    flow = make_snf_model(dim, target.log_prob, n_flow_layers=2, layer_nodes_per_dim=2,
                          it_snf_layer=1, mh_steps=2, mh_prop_scale=0.3, dtype=F64,
                          device="cpu")
    flow.load_state_dict(from_jax_params(params))
    return (flow_j, params, flow), (target_j, target)


# Each whole-step test runs eagerly and compiled: through ``make_train_step`` against
# fab_tpu's jitted step, and through ``make_scanned_train_step`` against its scan.
COMPILED = pytest.mark.parametrize("compiled", [None, "step", "scanned"],
                                   ids=["eager", "step", "scanned"])


@COMPILED
@pytest.mark.parametrize("adjust_after", [False, True], ids=["on_the_fly", "adjust_after"])
def test_prioritised_trainer_step_with_snf_matches_fab_tpu(adjust_after, monkeypatch,
                                                            compiled):
    """ManyWell-4, 2 couplings and 2 MH layers of 2 steps, batch 8: one key per AIS
    pass and one per replay batch (probe, loss and adjustment) replayed; every buffer
    field, parameter and Adam moment to 1e-8."""
    flow_pair, targets = _many_well_snf()
    check_train_step(monkeypatch, flow_pair, targets, 4, 8, 2, n_batches=2,
                     hmc_kw=STEP_HMC, compiled=compiled,
                     trainer_kw=dict(w_adjust_in_buffer_after_update=adjust_after))


def _jax_step(trainer_j, state_j, batch, key, compiled):
    """fab_tpu's step from ``state_j`` on ``key``: jitted, or (``compiled`` "scanned")
    its ``lax.scan`` of one step; (its new state and info, the step's own key)."""
    if compiled == "scanned":
        out = trainer_j.make_scanned_train_step(batch, 1)(state_j, key)
        return to_np(out), jax.random.split(key, 1)[0]
    return to_np(jax.jit(trainer_j._train_step_fn(batch))(state_j, key)), key


def _port_step(trainer, state, batch, compiled):
    """The port's step on replayed noise: eager, or through the compiled step."""
    if compiled == "step":
        return trainer.make_train_step(batch)(state, None)
    if compiled == "scanned":
        return trainer.make_scanned_train_step(batch, 1)(state, None)
    return trainer.train_step(state, None, batch)


def _trainer_step(monkeypatch, flow_pair, targets, dim, batch, keys_fn, compiled, tol=1e-8):
    """One f64 ``Trainer`` step (fab_alpha_div, HMC AIS) against fab_tpu's on
    replayed noise (``_jax_step``, ``_port_step``); ``keys_fn(key)`` gives the
    replayed log-q keys."""
    flow_j, params, flow = flow_pair
    target_j, target = targets
    with jax.enable_x64():
        model_j = JaxFABModel.create(flow_j, target_j, JaxHMC(**STEP_HMC), 2)
        trainer_j = JaxTrainer(model_j, jax_make_optimizer(1e-2, 100.0), dtype=jnp.float64)
        trans_j = to_np(model_j.ais.transition_operator.init_state(dim, jnp.float64))
        state_j = JaxTrainState({"flow": params, "transition": trans_j},
                                trainer_j.optimizer.init(params), jnp.zeros((), jnp.int32))
        (new_j, info_j), key = _jax_step(trainer_j, state_j, batch, jax.random.key(14),
                                         compiled)
        noise = ais_noise(key, 2, 1, batch, dim, jnp.float64, flow=flow_j)
        keys = keys_fn(key)
    model = FABModel.create(flow, target, HamiltonianMonteCarlo(**STEP_HMC), 2)
    trainer = Trainer(model, make_optimizer(1e-2, 100.0), dtype=F64, device="cpu")
    state = TrainState(transition_state_from_jax(trans_j),
                       trainer.optimizer.init(trainer.params), 0)
    replay = NoiseReplay(monkeypatch, noise, keys)
    new, info = _port_step(trainer, state, batch, compiled)
    replay.assert_consumed()
    expected = from_jax_params(new_j.params["flow"])
    for name, value in flow.state_dict().items():
        assert_close(value, expected[name], tol, name)
    adam_j = new_j.opt_state[1][0]
    mu_j, nu_j = from_jax_params(adam_j.mu), from_jax_params(adam_j.nu)
    names = [n for n, p in flow.named_parameters() if p.requires_grad]
    for name, mu, nu in zip(names, new.opt_state.mu, new.opt_state.nu):
        assert_close(mu, mu_j[name], tol, "mu " + name)
        assert_close(nu, nu_j[name], tol, "nu " + name)
    for k in ("epsilons", "common_epsilon", "mass"):
        assert_close(new.transition_state[k], new_j.params["transition"][k], tol, k)
    for k in ("loss", "grad_norm", "ess_ais", "ess_base", "n_valid", "log_Z"):
        assert_close(info[k], info_j[k], tol, k)
    assert bool(info["update_applied"]) and float(info["loss"]) != 0.0


@COMPILED
def test_trainer_step_with_snf_matches_fab_tpu(monkeypatch, compiled):
    """The AIS pass's key (fold_in 0x10C9) and the loss re-evaluation's (0x11A7)."""
    flow_pair, targets = _many_well_snf()
    flow_j = flow_pair[0]
    _trainer_step(monkeypatch, flow_pair, targets, 4, 8, lambda key: [
        snf_log_prob_noise(flow_j, jax.random.fold_in(key, 0x10C9), (8, 4), jnp.float64),
        snf_log_prob_noise(flow_j, jax.random.fold_in(key, 0x11A7), (8, 4), jnp.float64),
    ], compiled)


@COMPILED
def test_trainer_step_with_a_lars_base_matches_fab_tpu(monkeypatch, compiled):
    """A RealNVP over the LARS base (acceptance net perturbed, T = 10): the base's
    rejection rounds in the flow draw, a(z) in every log q."""
    dim = 4
    with jax.enable_x64():
        target_j = JaxManyWell(dim)
        flow_j = jax_make_resampled_realnvp(dim, n_flow_layers=2, layer_nodes_per_dim=2,
                                            act_norm=False, a_hidden_units=8, T=10)
        params = to_np(perturbed_jax_flow_params(flow_j, 15, jnp.float64, scale=0.2))
    flow = make_resampled_realnvp(dim, n_flow_layers=2, layer_nodes_per_dim=2,
                                  a_hidden_units=8, T=10, dtype=F64, device="cpu")
    flow.load_state_dict(from_jax_params(params))
    _trainer_step(monkeypatch, (flow_j, params, flow),
                  (target_j, ManyWellEnergy(dim, device="cpu")), dim, 16,
                  lambda key: [], compiled)


@COMPILED
def test_buffer_trainer_step_with_snf_matches_fab_tpu(monkeypatch, compiled):
    """``BufferTrainer``: one key for the AIS pass, one for the AIS batch's update
    and one per replay batch (its probe and its loss)."""
    (flow_j, params, flow), (target_j, target) = _many_well_snf()
    dim, batch, n_batches = 4, 8, 2
    rng = np.random.default_rng(16)
    with jax.enable_x64():
        buf_j = JaxReplayBuffer(dim, 64, 16, 1.0)
        buffer_j = buf_j.init(jnp.float64)
        for _ in range(3):
            x, log_w = rng.standard_normal((batch, dim)), rng.standard_normal(batch)
            buffer_j = buf_j.add(buffer_j, jnp.asarray(x), jnp.asarray(log_w),
                                 jnp.asarray(rng.random(batch) > 0.2))
        model_j = JaxFABModel.create(flow_j, target_j, JaxHMC(**STEP_HMC), 2)
        trainer_j = JaxBufferTrainer(model_j, jax_make_optimizer(1e-2, 100.0), buf_j,
                                     n_batches_buffer_sampling=n_batches,
                                     dtype=jnp.float64)
        trans_j = to_np(model_j.ais.transition_operator.init_state(dim, jnp.float64))
        state_j = JaxBufferTrainState({"flow": params, "transition": trans_j},
                                      trainer_j.optimizer.init(params), buffer_j,
                                      jnp.zeros((), jnp.int32))
        (new_j, info_j), key = _jax_step(trainer_j, state_j, batch, jax.random.key(17),
                                         compiled)
        key_ais, key_sample = jax.random.split(key)
        noise = ais_noise(key_ais, 2, 1, batch, dim, jnp.float64, flow=flow_j)
        replay_keys = jax.random.split(key_sample, n_batches)
        noise["gumbel"] = [np.asarray(jax.random.gumbel(k, (batch, 64), jnp.float32))
                           for k in replay_keys]
        lq = lambda k: snf_log_prob_noise(flow_j, k, (batch, dim), jnp.float64)
        keys = [lq(jax.random.fold_in(key_ais, 0x10C9)), lq(jax.random.fold_in(key, 0x11A7))]
        keys += [lq(jax.random.fold_in(k, 0x11A7)) for k in replay_keys]
        buffer_np = to_np(buffer_j)
    model = FABModel.create(flow, target, HamiltonianMonteCarlo(**STEP_HMC), 2)
    trainer = BufferTrainer(model, make_optimizer(1e-2, 100.0), ReplayBuffer(dim, 64, 16, 1.0),
                            n_batches_buffer_sampling=n_batches, dtype=F64, device="cpu")
    state = BufferTrainState(
        transition_state_from_jax(trans_j), trainer.optimizer.init(trainer.params),
        type(trainer.buffer.init(F64))(*[torch.tensor(np.asarray(v)) for v in buffer_np]), 0)
    replay = NoiseReplay(monkeypatch, noise, keys)
    new, info = _port_step(trainer, state, batch, compiled)
    replay.assert_consumed()
    expected = from_jax_params(new_j.params["flow"])
    for name, value in flow.state_dict().items():
        assert_close(value, expected[name], 1e-8, name)
    adam_j = new_j.opt_state[1][0]
    mu_j = from_jax_params(adam_j.mu)
    names = [n for n, p in flow.named_parameters() if p.requires_grad]
    for name, mu in zip(names, new.opt_state.mu):
        assert_close(mu, mu_j[name], 1e-8, "mu " + name)
    for name, a, b in zip(new.buffer_state._fields, new.buffer_state, new_j.buffer_state):
        assert_close(a, b, 1e-8, name)
    for k in ("loss", "grad_norm", "replay_loss", "ess_ais", "n_valid"):
        assert_close(info[k], info_j[k], 1e-8, k)
