"""Parity of the port's flows and of K1's plain version with fab_tpu (CPU). K1
itself is held against its plain version on the card in test_torch_gpu.py.

Tolerances: float64 1e-10 (same arithmetic, summation order only); float32 1e-5
(the same, at float32 rounding over 3 layers).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import fab_tpu.ops.realnvp_kernel as jax_rk
from fab_tpu.flows.fused import _stack_params as jax_stack_params
from fab_tpu_torch.flows.fused import FusedRealNVPFlow, _stack_params
from fab_tpu_torch.ops import realnvp_kernel as rk
from torch_parity_utils import assert_close, make_flow_pair

DIM, N_LAYERS, NODES = 8, 3, 4  # width 32
TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "wlin", "lu_ld")


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_flow_matches_fab_tpu(dtype, fused):
    tol = TOL[dtype]
    with jax.enable_x64(dtype == torch.float64):
        jax_flow, params, flow = make_flow_pair(DIM, N_LAYERS, NODES, dtype, fused=fused)
        assert isinstance(flow, FusedRealNVPFlow) == fused
        x = np.random.default_rng(1).standard_normal((64, DIM)).astype(
            np.float64 if dtype == torch.float64 else np.float32
        )
        @jax.jit
        def reference(params, x):
            log_q = lambda xi: jax_flow.log_prob(params, xi[None])[0]
            return (
                jax_flow.forward_and_log_det(params, x),
                jax_flow.inverse_and_log_det(params, x),
                jax.vmap(jax.value_and_grad(log_q))(x),
            )

        (y_j, ld_j), (z_j, ldi_j), (lq_j, g_j) = reference(params, x)

    xt = torch.tensor(x)
    y, ld = flow.forward_and_log_det(xt)
    z, ldi = flow.inverse_and_log_det(xt)
    assert_close(y, y_j, tol, "forward y")
    assert_close(ld, ld_j, tol, "forward log_det")
    assert_close(z, z_j, tol, "inverse z")
    assert_close(ldi, ldi_j, tol, "inverse log_det")
    xg = xt.clone().requires_grad_(True)
    lq = flow.log_prob(xg)
    (g,) = torch.autograd.grad(lq.sum(), xg)
    assert lq.dtype == dtype
    assert_close(lq, lq_j, tol, "log_prob")
    assert_close(g, g_j, tol, "grad_x log_prob")


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_k1_plain_version_matches_pallas_kernel(inverse, monkeypatch):
    """The port's plain K1 against fab_tpu's Pallas K1 run in interpret mode (f32)."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    _, params, flow = make_flow_pair(DIM, N_LAYERS, NODES, torch.float32, fused=True)
    x = np.random.default_rng(2).standard_normal((64, DIM)).astype(np.float32)
    s_j = jax_stack_params(jax.tree.map(jnp.asarray, params), inverse=inverse)
    y_j, ld_j = jax_rk.fused_realnvp_pass(
        jnp.asarray(x), *(s_j[k] for k in KEYS), inverse=inverse, tile_b=32
    )
    launches = rk.fused_realnvp_pass.launches
    with torch.no_grad():
        s = _stack_params(flow, inverse)
        for k in KEYS:
            assert_close(s[k], s_j[k], 1e-5, f"stacked {k}")
        y, ld = rk.fused_realnvp_pass(torch.tensor(x), *(s[k] for k in KEYS), inverse)
    assert rk.fused_realnvp_pass.launches == launches  # CPU tensors take the plain version
    assert_close(y, y_j, 1e-5, "y")
    assert_close(ld, ld_j, 1e-5, "log_det")


def test_fused_flow_flattens_leading_dims():
    """A [n, B, D] input goes through one fused pass per call and gives the plain
    Flow's values and input gradient (f64, 1e-10)."""
    with jax.enable_x64():
        _, _, fused = make_flow_pair(DIM, N_LAYERS, NODES, torch.float64, fused=True)
        _, _, plain = make_flow_pair(DIM, N_LAYERS, NODES, torch.float64, fused=False)
    x = torch.tensor(np.random.default_rng(4).standard_normal((3, 16, DIM)))
    results = []
    for flow in (fused, plain):
        with torch.no_grad():
            y, ld = flow.forward_and_log_det(x)
            z, ldi = flow.inverse_and_log_det(x)
        xg = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(flow.log_prob(xg).sum(), xg)
        results.append((y, ld, z, ldi, g))
    for a, b in zip(*results):
        assert a.shape == b.shape
        assert_close(a, b, 1e-10)
    assert results[0][1].shape == (3, 16)


def test_fused_gradients_match_plain_autograd():
    """The autograd Function (kernel forward, recomputed backward) gives the same
    input and parameter gradients as the plain Flow (f64, 1e-10)."""
    with jax.enable_x64():
        _, _, fused = make_flow_pair(DIM, N_LAYERS, NODES, torch.float64, fused=True)
        _, _, plain = make_flow_pair(DIM, N_LAYERS, NODES, torch.float64, fused=False)
    x = torch.tensor(np.random.default_rng(3).standard_normal((32, DIM)))
    grads = []
    for flow in (fused, plain):
        xg = x.clone().requires_grad_(True)
        y, ld = flow.forward_and_log_det(xg)
        loss = flow.log_prob(y).sum() + (y**2).sum() + ld.sum()
        grads.append(torch.autograd.grad(loss, [xg, *flow.parameters()]))
    for a, b in zip(*grads):
        assert_close(a, b, 1e-10)

