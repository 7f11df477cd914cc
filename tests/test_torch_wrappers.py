"""The port's wrappers (``fab_tpu_torch/wrappers/``) against ``fab_tpu/wrappers/`` on
shared inputs, on the CPU.

- ``WrappedTorchDist`` against ``fab_tpu``'s host-callback bridge: log-prob and its
  x-gradient (``fab_tpu`` casts both to float32, ``fab_tpu/wrappers/torch_dist.py:
  60-70``: pinned, its values are the port's rounded to float32), samples under one
  shared integer seed (exactly, after that cast), the global generator left as it
  was, the 1-D event-shape refusal, and ``from_callables`` against ``fab_tpu``'s
  ``WrappedJaxDist.from_callables`` on replayed noise.
- ``WrappedModuleFlow`` around an ``nn.Module`` against ``WrappedFlaxFlow`` (a
  flax.linen module) and ``WrappedHaikuFlow`` (a haiku multi-transform) with the
  same math and weights: ``FABModel``'s loss (flow_reverse_kl on ManyWell-2) and its
  parameter gradients on shared noise, f64 to 1e-10; the module's parameters train
  through ``Trainer``; under a data mesh it keeps its rank's rows of the global draw.
"""
import math

import flax.linen as flax_nn
import haiku as hk
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu.wrappers import WrappedFlaxFlow, WrappedHaikuFlow, WrappedJaxDist
from fab_tpu.wrappers import WrappedTorchDist as JaxWrappedTorchDist
from fab_tpu_torch import random as port_random
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.targets import ManyWellEnergy
from fab_tpu_torch.train import Trainer, make_optimizer
from fab_tpu_torch.wrappers import WrappedModuleFlow, WrappedTorchDist
from torch_parity_utils import NoiseReplay

DIM = 2


def _mixture(dtype=torch.float64):
    """A 2-D Gaussian mixture of 5 components, GMM-style."""
    g = torch.Generator().manual_seed(0)
    mix = torch.distributions.Categorical(logits=torch.randn(5, generator=g, dtype=dtype))
    comp = torch.distributions.Independent(torch.distributions.Normal(
        torch.randn(5, DIM, generator=g, dtype=dtype) * 3,
        torch.rand(5, DIM, generator=g, dtype=dtype) + 0.5), 1)
    return torch.distributions.MixtureSameFamily(mix, comp)


# ------------------------------------------------------------ WrappedTorchDist


def test_torch_dist_log_prob_and_gradient_match_fab_tpus_bridge():
    """fab_tpu's bridge returns float32 values (its cast, pinned here): they are the
    port's float64 values rounded to float32, exactly; the x-gradient through its
    custom VJP likewise."""
    dist = _mixture()
    x = np.random.default_rng(1).standard_normal((32, DIM)) * 3
    with jax.enable_x64():
        bridge = JaxWrappedTorchDist.wrap(dist)
        lp_j = np.asarray(bridge._host_log_prob(x))
        grad_j = np.asarray(jax.grad(lambda v: bridge.log_prob({}, v).sum())(jnp.asarray(x)))
        assert lp_j.dtype == np.float32
    port = WrappedTorchDist.wrap(dist)
    xt = torch.tensor(x, requires_grad=True)
    lp = port.log_prob(xt)
    (grad,) = torch.autograd.grad(lp.sum(), xt)
    assert lp.dtype == torch.float64
    np.testing.assert_array_equal(lp.detach().numpy().astype(np.float32), lp_j)
    np.testing.assert_array_equal(grad.numpy().astype(np.float32), grad_j.astype(np.float32))
    np.testing.assert_allclose(lp.detach().numpy(), lp_j, rtol=2 ** -23)


def test_torch_dist_samples_under_a_shared_seed():
    """One integer seed: fab_tpu's host sample and the port's sample_seeded are the
    same draws (fab_tpu's rounded to float32); the global generator is untouched,
    and sample draws its seed from the caller's generator."""
    dist = _mixture()
    before = torch.random.get_rng_state()
    port = WrappedTorchDist.wrap(dist)
    mine = port.sample_seeded(1234, 64)
    theirs = JaxWrappedTorchDist.wrap(dist)._host_sample(np.int32(1234), 64)
    np.testing.assert_array_equal(mine.numpy().astype(np.float32), theirs)
    assert torch.equal(torch.random.get_rng_state(), before)
    a = port.sample(64, torch.Generator().manual_seed(3))
    b = port.sample(64, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (64, DIM)
    x, log_q = port.sample_and_log_prob(16, torch.Generator().manual_seed(4))
    assert torch.equal(log_q, dist.log_prob(x))


def test_torch_dist_needs_a_one_dimensional_event():
    normal = torch.distributions.Normal(torch.zeros(3), torch.ones(3))
    with pytest.raises(ValueError, match="1-D event shape"):
        WrappedTorchDist.wrap(normal)
    with pytest.raises(ValueError, match="1-D event shape"):
        JaxWrappedTorchDist.wrap(normal)


def test_from_callables_matches_fab_tpus_jax_dist(monkeypatch):
    """The same Gaussian as callables in both packages: samples and log-probs on the
    same normal draws, f64 to 1e-12."""
    loc, scale = 1.5, 2.0
    key = jax.random.key(7)
    with jax.enable_x64():
        jax_dist = WrappedJaxDist.from_callables(
            lambda k, n: loc + scale * jax.random.normal(k, (n, DIM), jnp.float64),
            lambda x: jnp.sum(-0.5 * ((x - loc) / scale) ** 2 - jnp.log(scale)
                              - 0.5 * jnp.log(2 * jnp.pi), axis=-1), DIM)
        x_j, lq_j = jax_dist.sample_and_log_prob({}, key, 16)
        noise = np.asarray(jax.random.normal(key, (16, DIM), jnp.float64))
    NoiseReplay(monkeypatch, {"normal": [noise]})
    port = WrappedTorchDist.from_callables(
        lambda g, n: loc + scale * port_random.normal(g, (n, DIM), torch.float64, "cpu"),
        lambda x: (-0.5 * ((x - loc) / scale) ** 2 - math.log(scale)
                   - 0.5 * math.log(2 * math.pi)).sum(-1), DIM)
    x, log_q = port.sample_and_log_prob(16, torch.Generator())
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(log_q.numpy(), np.asarray(lq_j), rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------- WrappedModuleFlow

LOC = np.array([0.3, -0.7])
LOG_SCALE = np.array([0.2, -0.1])
SHEAR = 0.4  # x_1 += shear * x_0 / (1 + x_0^2): a triangular map, log-det 0


def _bump(v):
    # Rational, so both packages compute it with the same IEEE operations (XLA's
    # float64 tanh differs from torch's by more than 1e-10 after the target's
    # gradient scales it).
    return v / (1 + v * v)


class TorchFlow(torch.nn.Module):
    """x = shear(loc + exp(log_scale) * eps), eps ~ N(0, I), with shear(y) = (y_0,
    y_1 + SHEAR * _bump(y_0))."""

    def __init__(self):
        super().__init__()
        self.loc = torch.nn.Parameter(torch.tensor(LOC))
        self.log_scale = torch.nn.Parameter(torch.tensor(LOG_SCALE))
        self.shear = torch.nn.Parameter(torch.tensor(SHEAR, dtype=torch.float64))

    def _base_log_prob(self, eps):
        return (-0.5 * eps ** 2 - 0.5 * math.log(2 * math.pi)).sum(-1) - self.log_scale.sum()

    def sample_and_log_prob(self, generator, n):
        eps = port_random.normal(generator, (n, DIM), self.loc.dtype, self.loc.device)
        y = self.loc + torch.exp(self.log_scale) * eps
        x = torch.stack([y[:, 0], y[:, 1] + self.shear * _bump(y[:, 0])], -1)
        return x, self._base_log_prob(eps)

    def log_prob(self, x):
        y = torch.stack([x[:, 0], x[:, 1] - self.shear * _bump(x[:, 0])], -1)
        return self._base_log_prob((y - self.loc) * torch.exp(-self.log_scale))


def _jax_math(loc, log_scale, shear):
    def base_log_prob(eps):
        return jnp.sum(-0.5 * eps ** 2 - 0.5 * jnp.log(2 * jnp.pi), -1) - log_scale.sum()

    def sample_and_log_prob(key, n):
        eps = jax.random.normal(key, (n, DIM), loc.dtype)
        y = loc + jnp.exp(log_scale) * eps
        x = jnp.stack([y[:, 0], y[:, 1] + shear * _bump(y[:, 0])], -1)
        return x, base_log_prob(eps)

    def log_prob(x):
        y = jnp.stack([x[:, 0], x[:, 1] - shear * _bump(x[:, 0])], -1)
        return base_log_prob((y - loc) * jnp.exp(-log_scale))

    return sample_and_log_prob, log_prob


class FlaxFlow(flax_nn.Module):
    def setup(self):
        init = lambda value: (lambda key: jnp.asarray(value, jnp.float64))
        self.loc = self.param("loc", init(LOC))
        self.log_scale = self.param("log_scale", init(LOG_SCALE))
        self.shear = self.param("shear", init(SHEAR))

    def sample_and_log_prob(self, key, n):
        return _jax_math(self.loc, self.log_scale, self.shear)[0](key, n)

    def log_prob(self, x):
        return _jax_math(self.loc, self.log_scale, self.shear)[1](x)


def _haiku_flow():
    def params():
        get = lambda name, value: hk.get_parameter(
            name, np.shape(value), jnp.float64, init=lambda s, d: jnp.asarray(value, d))
        return get("loc", LOC), get("log_scale", LOG_SCALE), get("shear", SHEAR)

    def sample_and_log_prob(key, n):
        return _jax_math(*params())[0](key, n)

    def log_prob(x):
        return _jax_math(*params())[1](x)

    transformed = hk.multi_transform(lambda: (
        sample_and_log_prob, {"sample_and_log_prob": sample_and_log_prob,
                              "log_prob": log_prob}))
    return WrappedHaikuFlow(transformed, DIM)


def _fab_tpu_loss(flow, key, n):
    """fab_tpu's FABModel loss (flow_reverse_kl) and its gradient in the flow's
    parameters, as {name: array}."""
    model = JaxFABModel.create(flow, JaxManyWell(DIM), loss_type="flow_reverse_kl",
                               use_ais=False)
    params = {"flow": flow.init(jax.random.key(0)), "transition": {}}
    (loss, _), grads = jax.value_and_grad(
        lambda p: model.loss_and_info(p, key, n), has_aux=True)(params)
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(grads["flow"])[0]}
    return float(loss), {name.split("/")[-1]: v for name, v in leaves.items()}


@pytest.mark.parametrize("package", ["flax", "haiku"])
def test_module_flow_loss_matches_fab_tpus_wrapper(monkeypatch, package):
    key, n = jax.random.key(11), 64
    with jax.enable_x64():
        flow = WrappedFlaxFlow(FlaxFlow(), DIM) if package == "flax" else _haiku_flow()
        loss_j, grads_j = _fab_tpu_loss(flow, key, n)
        noise = np.asarray(jax.random.normal(key, (n, DIM), jnp.float64))
    NoiseReplay(monkeypatch, {"normal": [noise]})
    flow = WrappedModuleFlow(TorchFlow(), DIM)
    model = FABModel.create(flow, ManyWellEnergy(DIM, device="cpu"),
                            loss_type="flow_reverse_kl", use_ais=False)
    loss, _, _ = model.loss_and_info({}, torch.Generator(), n)
    grads = dict(zip([name.split(".")[-1] for name, _ in flow.named_parameters()],
                     torch.autograd.grad(loss, list(flow.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-10)
    assert sorted(grads) == sorted(grads_j)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads_j[name], rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_module_flow_trains_through_the_trainer():
    """The module's parameters are the trainer's: three guarded Adam steps move
    them, with finite losses."""
    flow = WrappedModuleFlow(TorchFlow(), DIM)
    model = FABModel.create(flow, ManyWellEnergy(DIM, device="cpu"),
                            loss_type="flow_reverse_kl", use_ais=False)
    trainer = Trainer(model, make_optimizer(1e-2), dtype=torch.float64, device="cpu")
    assert [p for p in trainer.params] == list(flow.module.parameters())
    state = trainer.init_state(torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in trainer.params]
    for _ in range(3):
        state, info = trainer.train_step(state, torch.Generator().manual_seed(1), 32)
        assert math.isfinite(float(info["loss"])) and bool(info["update_applied"])
    assert all(not torch.equal(a, b) for a, b in zip(before, trainer.params))


def test_module_flow_keeps_its_ranks_rows_of_the_global_draw():
    """Under a data mesh (data index 1 of 2; no collective needed) the module draws
    the global batch and the wrapper keeps rows [n / 2, n)."""
    flow = WrappedModuleFlow(TorchFlow(), DIM)
    whole_x, whole_lq = flow.sample_and_log_prob(8, torch.Generator().manual_seed(2))
    with mesh.use_mesh(mesh.Mesh(n_data=2, rank=1)):
        x, log_q = flow.sample_and_log_prob(8, torch.Generator().manual_seed(2))
    assert torch.equal(x, whole_x[4:]) and torch.equal(log_q, whole_lq[4:])
