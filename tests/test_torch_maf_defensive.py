"""Parity of the port's masked affine autoregressive flow (MAF), permutation and
defensive mixture with fab_tpu (CPU), on shared parameters and replayed JAX noise.

- ``made_masks`` equal to fab_tpu's; the conditioner's autoregressive property
  (its Jacobian is strictly lower-triangular).
- ``MaskedAffineAutoregressive`` both directions and log-dets, with the scale cap
  reached; ``Permutation``; ``make_masked_affine_maf`` ``log_prob`` and a replayed
  ``sample_and_log_prob``; gradients through the sequential direction.
- ``DefensiveMixture``: ``log_prob``, a replayed ``sample_and_log_prob`` (choice,
  flow, Gaussian), its initial logit, and a wrapped SNF that raises ``ValueError``.
- ``convert`` round trips of a MAF and a mixture.

Tolerances: f64 1e-10; f32 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.flows import DefensiveMixture as JaxDefensiveMixture
from fab_tpu.flows import MaskedAffineAutoregressive as JaxMAF
from fab_tpu.flows import Permutation as JaxPermutation
from fab_tpu.flows import make_masked_affine_maf as jax_make_maf
from fab_tpu.flows import make_realnvp as jax_make_realnvp
from fab_tpu.flows import make_snf_model as jax_make_snf_model
from fab_tpu.flows.autoregressive import _made_masks as jax_made_masks
from fab_tpu.targets import Gaussian as JaxGaussian
from fab_tpu_torch.convert import from_jax_params, to_jax_params
from fab_tpu_torch.flows import (
    DefensiveMixture,
    MaskedAffineAutoregressive,
    Permutation,
    make_masked_affine_maf,
    make_realnvp,
    make_snf_model,
)
from fab_tpu_torch.flows.autoregressive import made_masks
from fab_tpu_torch.targets import Gaussian
from torch_parity_utils import (
    JAX_DTYPE,
    NoiseReplay,
    assert_close,
    assert_close_to_scale,
    flow_sample_noise,
    perturbed_jax_flow_params,
    to_np,
)

F64 = torch.float64
TOL = {torch.float32: 1e-5, torch.float64: 1e-10}


@pytest.mark.parametrize("dim,hidden,seed", [(1, [4], 0), (5, [16, 16], 3), (7, [8, 3, 9], 11)])
def test_made_masks_equal_fab_tpu(dim, hidden, seed):
    ours, theirs = made_masks(dim, hidden, seed), jax_made_masks(dim, hidden, seed)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _maf_pair(dim, dtype, seed=0, scale=0.3, **kw):
    """(fab_tpu bijector, perturbed params as numpy, port bijector with them)."""
    bij_j = JaxMAF(hidden_units=16, **kw)
    rng = np.random.default_rng(seed)
    params = to_np(bij_j.init(jax.random.key(seed), dim, JAX_DTYPE[dtype]))
    params = jax.tree.map(
        lambda p: p + scale * rng.standard_normal(p.shape).astype(p.dtype), params)
    bij = MaskedAffineAutoregressive(dim, 16, dtype=dtype, device="cpu", **kw)
    state = from_jax_params({"base": {}, "layers": (params,)})
    bij.load_state_dict({k.removeprefix("bijectors.0."): v for k, v in state.items()})
    return bij_j, params, bij


def test_conditioner_is_autoregressive():
    dim = 5
    with jax.enable_x64():
        _, _, bij = _maf_pair(dim, F64, seed=1, mask_seed=4)
    x = torch.tensor(np.random.default_rng(2).standard_normal(dim))
    jac = torch.autograd.functional.jacobian(lambda v: bij._conditioner(v[None])[0][0], x)
    assert torch.count_nonzero(torch.triu(jac)) == 0
    assert torch.count_nonzero(torch.tril(jac, -1)) > 0


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("scale_cap", [3.0, 0.0])
def test_maf_both_directions_match_fab_tpu(dtype, scale_cap):
    """Large weights (scale 2) so that the cap's tanh bends the log-scales."""
    dim = 4
    x = np.random.default_rng(3).standard_normal((32, dim))
    with jax.enable_x64(dtype == F64):
        bij_j, params, bij = _maf_pair(dim, dtype, seed=5, scale=2.0 if scale_cap else 0.3,
                                       scale_cap=scale_cap, mask_seed=2)
        xj = jnp.asarray(x, JAX_DTYPE[dtype])
        z_j, ld_inv_j = to_np(bij_j.inverse_and_log_det(params, xj))
        y_j, ld_fwd_j = to_np(bij_j.forward_and_log_det(params, xj))
        _, raw = to_np(JaxMAF(hidden_units=16, scale_cap=0.0, mask_seed=2)._conditioner(
            params, xj, dim))
    if scale_cap:
        assert np.abs(raw).max() > scale_cap  # the cap is reached
    x_t = torch.tensor(x, dtype=dtype)
    z, ld_inv = bij.inverse_and_log_det(x_t)
    y, ld_fwd = bij.forward_and_log_det(x_t)
    # f32 values reach ~2e4 here (exp of capped log-scales): f32 is held to its
    # tolerance relative to the largest value (``assert_close_to_scale``).
    close = assert_close if dtype == F64 else assert_close_to_scale
    close(z, z_j, TOL[dtype], "inverse")
    close(ld_inv, ld_inv_j, TOL[dtype], "inverse log-det")
    close(y, y_j, TOL[dtype], "forward")
    close(ld_fwd, ld_fwd_j, TOL[dtype], "forward log-det")
    if dtype == F64:
        z_back, ld_back = bij.inverse_and_log_det(y)
        assert_close(z_back, x, 1e-8, "round trip")
        assert_close(ld_back, -ld_fwd.detach(), 1e-8, "log-dets")


def test_maf_forward_gradient_matches_fab_tpu():
    """The sequential (sampling) direction differentiates through every column."""
    dim = 4
    z = np.random.default_rng(6).standard_normal((16, dim))
    with jax.enable_x64():
        bij_j, params, bij = _maf_pair(dim, F64, seed=7)
        loss = lambda p, zz: jnp.sum(bij_j.forward_and_log_det(p, zz)[0] ** 2
                                     + bij_j.forward_and_log_det(p, zz)[1][:, None])
        g_params, g_z = to_np(jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(z)))
    z_t = torch.tensor(z, requires_grad=True)
    y, ld = bij.forward_and_log_det(z_t)
    grads = torch.autograd.grad((y**2 + ld[:, None]).sum(), [z_t, *bij.parameters()])
    assert_close(grads[0], g_z, 1e-10, "dz")
    expected = from_jax_params({"base": {}, "layers": (g_params,)})
    for (name, _), g in zip(bij.named_parameters(), grads[1:]):
        assert_close(g, expected["bijectors.0." + name], 1e-10, name)


def test_permutation_matches_fab_tpu():
    x = np.random.default_rng(8).standard_normal((8, 6))
    with jax.enable_x64():
        y_j, _ = JaxPermutation(seed=1003).forward_and_log_det({}, jnp.asarray(x))
        z_j, _ = JaxPermutation(seed=1003).inverse_and_log_det({}, jnp.asarray(x))
    perm = Permutation(6, seed=1003, device="cpu")
    y, ld = perm.forward_and_log_det(torch.tensor(x))
    z, _ = perm.inverse_and_log_det(torch.tensor(x))
    assert_close(y, y_j, 0.0, "forward")
    assert_close(z, z_j, 0.0, "inverse")
    assert_close(perm.inverse_and_log_det(y)[0], x, 0.0, "round trip")
    assert torch.all(ld == 0)


def _maf_flow_pair(dim, seed=9):
    flow_j = jax_make_maf(dim, n_layers=2, hidden_units=16)
    params = to_np(perturbed_jax_flow_params(flow_j, seed, jnp.float64, scale=0.2))
    flow = make_masked_affine_maf(dim, n_layers=2, hidden_units=16, dtype=F64, device="cpu")
    flow.load_state_dict(from_jax_params(params))
    return flow_j, params, flow


def test_make_masked_affine_maf_matches_fab_tpu(monkeypatch):
    dim, n, key = 4, 64, jax.random.key(10)
    x = np.random.default_rng(11).standard_normal((n, dim))
    with jax.enable_x64():
        flow_j, params, flow = _maf_flow_pair(dim)
        lp_j = to_np(flow_j.log_prob(params, jnp.asarray(x)))
        xs_j, lq_j = to_np(flow_j.sample_and_log_prob(params, key, n))
        noise = flow_sample_noise(flow_j, key, n, dim, jnp.float64)
    assert [type(b).__name__ for b in flow.bijectors] == [
        "MaskedAffineAutoregressive", "Permutation"] * 2
    assert_close(flow.log_prob(torch.tensor(x)), lp_j, 1e-10, "log_prob")
    replay = NoiseReplay(monkeypatch, noise)
    xs, lq = flow.sample_and_log_prob(n, None)
    replay.assert_consumed()
    assert_close(xs, xs_j, 1e-10, "sample")
    assert_close(lq, lq_j, 1e-10, "sample log q")
    assert_close(flow.log_prob(xs), lq.detach(), 1e-8, "log_prob of its samples")


def test_maf_initialises_he_normal_with_a_zero_last_layer():
    flow = make_masked_affine_maf(3, n_layers=1, hidden_units=512, dtype=F64, device="cpu")
    mlp = flow.bijectors[0].mlp
    assert torch.all(mlp[-1].w == 0) and all(torch.all(layer.b == 0) for layer in mlp)
    assert abs(float(mlp[1].w.detach().std()) / (2.0 / 512) ** 0.5 - 1) < 0.02
    x = torch.randn((5, 3), dtype=F64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(flow.bijectors[0].inverse_and_log_det(x)[0], x)  # identity at init


# -------------------------------------------------------------- defensive mixture


def _mixture_pair(seed=12):
    dim = 3
    with jax.enable_x64():
        mix_j = JaxDefensiveMixture(jax_make_realnvp(dim, n_flow_layers=2,
                                                     layer_nodes_per_dim=2, act_norm=False))
        rng = np.random.default_rng(seed)
        params = to_np(mix_j.init(jax.random.key(seed), jnp.float64))
        params = jax.tree_util.tree_map_with_path(
            lambda path, p: p if any(getattr(k, "key", None) == "sign_s" for k in path)
            else p + 0.2 * rng.standard_normal(np.shape(p)), params)
    mix = DefensiveMixture(make_realnvp(dim, n_flow_layers=2, layer_nodes_per_dim=2,
                                       dtype=F64, device="cpu"))
    mix.load_state_dict(from_jax_params(params))
    return mix_j, params, mix


def test_defensive_mixture_log_prob_matches_fab_tpu():
    x = np.random.default_rng(13).standard_normal((64, 3)) * 3
    with jax.enable_x64():
        mix_j, params, mix = _mixture_pair()
        lp_j = to_np(mix_j.log_prob(params, jnp.asarray(x)))
        g_j = to_np(jax.grad(lambda p: jnp.sum(mix_j.log_prob(p, jnp.asarray(x))))(params))
    lp = mix.log_prob(torch.tensor(x))
    assert_close(lp, lp_j, 1e-10, "log_prob")
    grads = torch.autograd.grad(lp.sum(), list(mix.parameters()))
    expected = from_jax_params(g_j)
    for (name, _), g in zip(mix.named_parameters(), grads):
        assert_close(g, expected[name], 1e-10, name)


def test_defensive_mixture_sample_matches_fab_tpu(monkeypatch):
    """The draws in fab_tpu's order: the choice (a uniform below the flow's weight),
    the flow's, the Gaussian's; the mixed draw is detached."""
    n, key = 256, jax.random.key(14)
    with jax.enable_x64():
        mix_j, params, mix = _mixture_pair()
        x_j, lp_j = to_np(mix_j.sample_and_log_prob(params, key, n))
        k_choice, k_flow, k_def = jax.random.split(key, 3)
        noise = {"uniform": [np.asarray(jax.random.uniform(k_choice, (n,), jnp.float64))],
                 "normal": [np.asarray(jax.random.normal(k_flow, (n, 3), jnp.float64)),
                            np.asarray(jax.random.normal(k_def, (n, 3), jnp.float64))]}
    replay = NoiseReplay(monkeypatch, noise)
    x, lp = mix.sample_and_log_prob(n, None)
    replay.assert_consumed()
    assert not x.requires_grad
    assert_close(x, x_j, 1e-10, "x")
    assert_close(lp, lp_j, 1e-10, "log_prob")
    w = float(torch.sigmoid(mix.mixture_logit))
    from_flow = (noise["uniform"][0] < w).sum()
    assert 0 < from_flow < n


def test_defensive_mixture_initial_logit_and_reset():
    mix = DefensiveMixture(make_realnvp(2, 1, 2, dtype=F64, device="cpu"))
    with jax.enable_x64():
        params = JaxDefensiveMixture(jax_make_realnvp(2, 1, 2)).init(jax.random.key(0),
                                                                    jnp.float64)
    assert float(mix.mixture_logit) == float(params["mixture_logit"]) == 2.2
    with torch.no_grad():
        mix.mixture_logit.fill_(0.0)
        mix.defensive.loc.fill_(1.0)
    mix.reset_parameters(torch.Generator().manual_seed(0))
    assert float(mix.mixture_logit) == 2.2 and torch.all(mix.defensive.loc == 0)


def test_defensive_mixture_over_an_snf_raises():
    """The mixture calls its flow's log q without noise: a wrapped SNF raises
    ValueError in both packages, with no fixed-key fallback."""
    loc, scale = np.zeros(2), np.ones(2)
    x = np.random.default_rng(15).standard_normal((8, 2))
    with jax.enable_x64():
        target_j = JaxGaussian(jnp.asarray(loc), jnp.asarray(scale))
        mix_j = JaxDefensiveMixture(jax_make_snf_model(2, target_j.log_prob, 2, 2,
                                                       it_snf_layer=1, mh_steps=2))
        params = mix_j.init(jax.random.key(0), jnp.float64)
        with pytest.raises(ValueError):
            mix_j.log_prob(params, jnp.asarray(x))
        with pytest.raises(ValueError):
            mix_j.sample_and_log_prob(params, jax.random.key(1), 8)
    target = Gaussian(torch.tensor(loc), torch.tensor(scale))
    mix = DefensiveMixture(make_snf_model(2, target.log_prob, 2, 2, it_snf_layer=1,
                                          mh_steps=2, dtype=F64, device="cpu"))
    with pytest.raises(ValueError, match="requires a generator"):
        mix.log_prob(torch.tensor(x))
    with pytest.raises(ValueError, match="requires a generator"):
        mix.sample_and_log_prob(8, torch.Generator().manual_seed(0))


def _tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_convert_round_trips_maf_and_mixture():
    with jax.enable_x64():
        _, params, flow = _maf_flow_pair(4)
        _, mix_params, mix = _mixture_pair()
    assert params["layers"][1] == {} and "bijectors.0.mlp.2.w" in flow.state_dict()
    _tree_equal(to_jax_params(flow.state_dict(), len(flow.bijectors)), params)
    assert {"mixture_logit", "defensive.loc", "flow.base.loc"} <= set(mix.state_dict())
    _tree_equal(to_jax_params(mix.state_dict(), len(mix.flow.bijectors)), mix_params)
