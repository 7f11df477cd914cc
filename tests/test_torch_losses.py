"""Parity of the port's FAB losses and the model's loss dispatch with fab_tpu (CPU,
float64).

- Each of the eight losses on the same inputs (with and without a mask), value and
  gradient in log q, to 1e-10.
- ``FABModel.loss_and_info`` runs AIS for exactly the loss types fab_tpu runs it for.
- The flow-sample and target-sample losses through the model, on replayed draws:
  value and flow gradient to 1e-8 (a reparametrised draw through the flow), and the
  model's sample filter on the AIS and flow-sample branches.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu import losses as jax_losses
from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.sampling import AnnealedImportanceSampler as JaxAIS
from fab_tpu.sampling import Metropolis as JaxMetropolis
from fab_tpu.targets import GMM as JaxGMM
from fab_tpu_torch import losses
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.sampling import AnnealedImportanceSampler, Metropolis
from fab_tpu_torch.targets import GMM
from torch_parity_utils import (
    NoiseReplay,
    assert_close,
    make_flow_pair,
    metropolis_ais_noise,
    to_np,
)

DT = torch.float64
N = 40


def _inputs(masked):
    rng = np.random.default_rng(0)
    log_q, log_p, log_w = (rng.standard_normal(N) for _ in range(3))
    mask = rng.random(N) > 0.25 if masked else None
    return log_q, log_p, log_w, mask


CASES = {
    "fab_alpha_div": (lambda f, q, p, w, m: f(q, w, 2.0, m)),
    "fab_alpha_div_neg_alpha": (lambda f, q, p, w, m: f(q, w, -1.0, m)),
    "flow_reverse_kl": (lambda f, q, p, w, m: f(q, p, m)),
    "forward_kl": (lambda f, q, p, w, m: f(q)),
    "flow_alpha_2_div_nis": (lambda f, q, p, w, m: f(q, p, m)),
    "flow_alpha_2_div": (lambda f, q, p, w, m: f(q, p, m)),
    "flow_alpha_2_div_unbiased": (lambda f, q, p, w, m: f(q, p, m)),
    "fab_ub_alpha_2_div": (lambda f, q, p, w, m: f(q, p, w, m)),
}


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "masked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_value_and_gradient_match_fab_tpu(case, masked):
    name = case.removesuffix("_neg_alpha")
    call = CASES[case]
    log_q, log_p, log_w, mask = _inputs(masked)
    with jax.enable_x64():
        fn_j = getattr(jax_losses, name)
        jm = None if mask is None else jnp.asarray(mask)
        value_j, grad_j = jax.value_and_grad(
            lambda q: call(fn_j, q, jnp.asarray(log_p), jnp.asarray(log_w), jm)
        )(jnp.asarray(log_q))
    q = torch.tensor(log_q, requires_grad=True)
    value = call(getattr(losses, name), q, torch.tensor(log_p), torch.tensor(log_w),
                 None if mask is None else torch.tensor(mask))
    (grad,) = torch.autograd.grad(value, q)
    assert_close(value, np.asarray(value_j), 1e-10, "value")
    assert_close(grad, np.asarray(grad_j), 1e-10, "gradient")


@functools.lru_cache(maxsize=None)
def _gmm_pair():
    with jax.enable_x64():
        target_j = JaxGMM(n_mixes=8, loc_scaling=5.0, dtype=jnp.float64,
                          true_expectation_estimation_n_samples=1000)
    return target_j, GMM(n_mixes=8, loc_scaling=5.0, dtype=DT, device="cpu",
                         true_expectation_estimation_n_samples=1000)


@pytest.mark.parametrize("loss_type", losses.LOSS_TYPES)
@pytest.mark.parametrize("use_ais", [True, False], ids=["use_ais", "no_ais"])
def test_loss_dispatch_runs_ais_where_fab_tpu_does(loss_type, use_ais, monkeypatch):
    """Both models are built the same way; each package's AIS is replaced by a
    function that raises, so the branch that samples stops at once. forward_kl has
    no branch in either (it takes target data: ``forward_kl_loss``)."""

    class Ran(Exception):
        pass

    def stop(*args, **kwargs):
        raise Ran

    monkeypatch.setattr(JaxAIS, "sample_and_log_weights", stop)
    monkeypatch.setattr(AnnealedImportanceSampler, "sample_and_log_weights", stop)
    target_j, target = _gmm_pair()
    runs = []
    with jax.enable_x64():
        jax_flow, params, flow = make_flow_pair(2, 2, 4, DT)
        model_j = JaxFABModel.create(jax_flow, target_j, JaxMetropolis(1), 1,
                                     loss_type=loss_type, use_ais=use_ais)
        model = FABModel.create(flow, target, Metropolis(1), 1, loss_type=loss_type,
                                use_ais=use_ais)
        for call in (
            lambda: model_j.loss_and_info(
                {"flow": params, "transition": {"noise_scalings": jnp.ones((1, 1))}},
                jax.random.key(0), 16),
            lambda: model.loss_and_info({"noise_scalings": torch.ones((1, 1), dtype=DT)},
                                        torch.Generator(), 16),
        ):
            try:
                call()
                runs.append("no AIS")
            except Ran:
                runs.append("AIS")
            except NotImplementedError:  # forward_kl needs data: forward_kl_loss
                runs.append("refused")
    assert runs[0] == runs[1]
    assert (model.ais is None) == (model_j.ais is None)


def _flow_grads(flow):
    return {n: p.grad.clone() for n, p in flow.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("loss_type", ["flow_reverse_kl", "flow_alpha_2_div_nis",
                                       "target_forward_kl"])
def test_flow_and_target_sample_losses_match_fab_tpu(loss_type, monkeypatch):
    target_j, target = _gmm_pair()
    key = jax.random.key(1)
    with jax.enable_x64():
        jax_flow, params, flow = make_flow_pair(2, 3, 4, DT, seed=2)
        model_j = JaxFABModel.create(jax_flow, target_j, loss_type=loss_type, use_ais=False)
        (loss_j, _), grads_j = jax.value_and_grad(
            lambda p: model_j.loss_and_info({"flow": p}, key, 32), has_aux=True)(params)
        grads_j = from_jax_params(to_np(grads_j))
        if loss_type == "target_forward_kl":
            key_comp, key_eps = jax.random.split(key)
            noise = {"randint": [np.asarray(jax.random.randint(key_comp, (32,), 0, 8))],
                     "normal": [np.asarray(jax.random.normal(key_eps, (32, 2), jnp.float64))]}
        else:
            noise = {"normal": [np.asarray(jax.random.normal(key, (32, 2), jnp.float64))]}
    model = FABModel.create(flow, target, loss_type=loss_type, use_ais=False)
    replay = NoiseReplay(monkeypatch, noise)
    loss, state, info = model.loss_and_info({}, None, 32)
    replay.assert_consumed()
    loss.backward()
    assert_close(loss, np.asarray(loss_j), 1e-8, "loss")
    grads = _flow_grads(flow)
    assert grads
    for name, g in grads.items():
        assert_close(g, grads_j[name], 1e-8, name)
    assert state == {} and info == {}


@pytest.mark.parametrize("loss_type", ["fab_alpha_div", "flow_reverse_kl"])
def test_sample_filter_masks_rows_as_fab_tpu_does(loss_type, monkeypatch):
    """A train-time filter (x_0 > 0 dropped) on the AIS batch and on a flow draw:
    loss and flow gradient equal fab_tpu's with the same filter, on replayed draws."""
    target_j, target = _gmm_pair()
    key = jax.random.key(3)
    with jax.enable_x64():
        jax_flow, params, flow = make_flow_pair(2, 2, 4, DT, seed=4)
        model_j = dataclasses.replace(
            JaxFABModel.create(jax_flow, target_j, JaxMetropolis(1), 1, loss_type=loss_type),
            sample_filter=lambda x, mask: mask & (x[:, 0] <= 0))
        state_j = {"noise_scalings": jnp.full((1, 1), 5.0)}
        (loss_j, _), grads_j = jax.value_and_grad(
            lambda p: model_j.loss_and_info({"flow": p, "transition": state_j}, key, 32),
            has_aux=True)(jax.tree.map(jnp.asarray, params))
        grads_j = from_jax_params(to_np(grads_j))
        if loss_type == "fab_alpha_div":
            noise = metropolis_ais_noise(key, 1, 1, 32, 2, jnp.float64)
        else:
            noise = {"normal": [np.asarray(jax.random.normal(key, (32, 2), jnp.float64))]}
    model = dataclasses.replace(
        FABModel.create(flow, target, Metropolis(1), 1, loss_type=loss_type),
        sample_filter=lambda x, mask: mask & (x[:, 0] <= 0))
    replay = NoiseReplay(monkeypatch, noise)
    loss, _, _ = model.loss_and_info({"noise_scalings": torch.full((1, 1), 5.0, dtype=DT)},
                                     None, 32)
    replay.assert_consumed()
    loss.backward()
    assert_close(loss, np.asarray(loss_j), 1e-8, "loss")
    for name, g in _flow_grads(flow).items():
        assert_close(g, grads_j[name], 1e-8, name)
