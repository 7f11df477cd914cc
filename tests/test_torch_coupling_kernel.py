"""Parity of K2's plain version, LargeFusedCoupling and the fused_coupling flow
with fab_tpu (CPU). K2 itself is held against its plain version on the card in
test_torch_gpu.py.

fab_tpu's kernel runs in Pallas interpret mode, as tests/test_ops_kernel.py runs it,
at a scaled-down LGCP shape. Tolerances: float32 y 2e-5 and log_det 2e-4 (a 512-deep
product and a d_trans-term sum, in another order, as tests/test_ops_kernel.py:96-100);
float32 gradients and whole-flow log q 1e-5 of their largest magnitude (batch sums
of values up to ~1e5, in another order); float64 1e-10 (summation order only).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fab_tpu.flows.large_coupling import LargeFusedCoupling as JaxLargeFusedCoupling
from fab_tpu.ops import coupling_kernel as jax_ck
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.flows import LargeFusedCoupling, make_realnvp
from fab_tpu_torch.ops import coupling_kernel as ck
from torch_parity_utils import assert_close, assert_close_to_scale, make_flow_pair, to_np

WIDTH, BATCH, TILE, CAP = 512, 128, 64, 5.0


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _operands(dim, dtype, seed=0, batch=BATCH):
    """Perturbed coupling operands as numpy (the last layer starts at zero, so it
    gets ~0.01 N(0, 1), as tests/test_ops_kernel.py:90-93 does)."""
    rng = np.random.default_rng(seed)
    d_cond = (dim + 1) // 2
    d_trans = dim - d_cond
    pad = jax_ck._round128(2 * d_trans)
    shapes = [(batch, d_cond), (batch, d_trans), (d_cond, WIDTH), (WIDTH,),
              (WIDTH, WIDTH), (WIDTH,), (WIDTH, pad), (pad,)]
    scales = [1.0, 1.0, np.sqrt(2 / d_cond), 0.1, np.sqrt(2 / WIDTH), 0.1, 0.01, 0.01]
    ops = [(s * rng.standard_normal(shape)).astype(dtype) for shape, s in zip(shapes, scales)]
    ops[6][:, 2 * d_trans:] = 0.0  # the pad is zero, as after pad_cols
    ops[7][2 * d_trans:] = 0.0
    return ops


@pytest.mark.parametrize("dim", [256, 200], ids=["d256", "d200_padded"])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_k2_plain_version_matches_pallas_kernel(inverse, dim, interpret_pallas):
    ops = _operands(dim, np.float32)
    y_j, ld_j = jax_ck.fused_coupling_apply(
        *(jnp.asarray(a) for a in ops), CAP, inverse, TILE, True
    )
    launches = ck.fused_coupling_apply.launches
    y, ld = ck.fused_coupling_apply(*(torch.tensor(a) for a in ops), CAP, inverse)
    assert ck.fused_coupling_apply.launches == launches  # CPU tensors: plain version
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), atol=2e-4, rtol=0)


@pytest.mark.parametrize("cap", [CAP, 0.0], ids=["capped", "uncapped"])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_k2_plain_version_matches_jnp_twin_f64(inverse, cap):
    with jax.enable_x64():
        ops = _operands(200, np.float64, seed=1)
        y_j, ld_j = jax_ck._coupling_jnp(
            *(jnp.asarray(a) for a in ops), scale_cap=cap, inverse=inverse
        )
        y_j, ld_j = np.asarray(y_j), np.asarray(ld_j)
    y, ld = ck.fused_coupling_apply_reference(
        *(torch.tensor(a) for a in ops), cap, inverse
    )
    assert y.dtype == torch.float64
    assert_close(y, y_j, 1e-10, "y")
    assert_close(ld, ld_j, 1e-10, "log_det")


@pytest.mark.parametrize("cols", [250, 256, 3200], ids=str)
def test_pad_cols_matches_fab_tpu(cols):
    rng = np.random.default_rng(2)
    w3 = rng.standard_normal((8, cols)).astype(np.float32)
    b3 = rng.standard_normal(cols).astype(np.float32)
    w_j, b_j = jax_ck.pad_cols(jnp.asarray(w3), jnp.asarray(b3))
    w, b = ck.pad_cols(torch.tensor(w3), torch.tensor(b3))
    assert w.shape == w_j.shape and w.shape[-1] % 128 == 0
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_j))
    assert ck._round128(cols) == jax_ck._round128(cols)


def _layer_pair(dim, seed=3):
    """fab_tpu's LargeFusedCoupling (interpret-mode kernel) and the port's, with
    the same perturbed parameters loaded through from_jax_params."""
    layer_j = JaxLargeFusedCoupling(
        hidden_units=WIDTH, scale_cap=CAP, interpret=True, batch_tile=TILE
    )
    params = layer_j.init(jax.random.key(seed), dim)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: p + jnp.asarray(0.01 * rng.standard_normal(p.shape), p.dtype), params
    )
    params = to_np(params)
    layer = LargeFusedCoupling(dim, WIDTH, scale_cap=CAP, device="cpu")
    state = from_jax_params({"base": {"loc": 0, "log_scale": 0}, "layers": (params,)})
    layer.load_state_dict({k[len("bijectors.0."):]: v for k, v in state.items()
                           if k.startswith("bijectors.0.")})
    return layer_j, params, layer


def test_large_fused_coupling_loads_padded_fab_tpu_params():
    _, params, layer = _layer_pair(200)
    assert params["mlp"][-1]["w"].shape == (WIDTH, 256)
    assert layer.mlp[-1].w.shape == (WIDTH, 256) and layer.sizes[-1] == 256


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_large_fused_coupling_matches_fab_tpu_with_gradients(inverse, interpret_pallas):
    """Values, input gradients and parameter gradients of one f32 layer, the port's
    through FusedCoupling (plain version on the CPU, recomputed backward) and
    fab_tpu's through its interpret-mode kernel and custom VJP."""
    dim = 200
    layer_j, params, layer = _layer_pair(dim)
    z = np.random.default_rng(4).standard_normal((BATCH, dim)).astype(np.float32)
    method = "inverse_and_log_det" if inverse else "forward_and_log_det"

    def loss_j(p, zz):
        y, ld = getattr(layer_j, method)(p, zz)
        return jnp.sum(y**2) + jnp.sum(ld), (y, ld)

    (_, (y_j, ld_j)), (gp_j, gz_j) = jax.value_and_grad(loss_j, (0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(z)
    )
    recomputes = ck.FusedCoupling.recomputes
    zt = torch.tensor(z, requires_grad=True)
    y, ld = getattr(layer, method)(zt)
    grads = torch.autograd.grad((y**2).sum() + ld.sum(), [zt, *layer.parameters()])
    assert ck.FusedCoupling.recomputes == recomputes + 1
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ld_j), atol=2e-4, rtol=0)
    assert_close_to_scale(grads[0], gz_j, 1e-5, "grad z")
    expected = [a for d in gp_j["mlp"] for a in (d["w"], d["b"])]
    for g, g_j in zip(grads[1:], expected):
        assert_close_to_scale(g, g_j, 1e-5, "grad param")


def test_padded_columns_get_exactly_zero_gradient():
    """The recompute reads only the first 2 * d_trans columns of the padded last
    layer, so the pad's gradient is exactly zero and the pad stays zero."""
    dim = 200
    _, _, layer = _layer_pair(dim)
    z = torch.tensor(np.random.default_rng(5).standard_normal((64, dim)), dtype=torch.float32)
    y, ld = layer.inverse_and_log_det(z)
    g_w, g_b = torch.autograd.grad((y**2).sum() + ld.sum(), [layer.mlp[-1].w, layer.mlp[-1].b])
    assert torch.count_nonzero(g_w[:, 200:]) == 0 and torch.count_nonzero(g_b[200:]) == 0
    assert torch.count_nonzero(g_w[:, :200]) > 0


def test_large_fused_coupling_flattens_leading_dims():
    """A [n, B, D] input takes one FusedCoupling call and matches the [N, D] call."""
    _, _, layer = _layer_pair(200)
    z = torch.tensor(np.random.default_rng(6).standard_normal((3, 16, 200)), dtype=torch.float32)
    y, ld = layer.forward_and_log_det(z)
    y_flat, ld_flat = layer.forward_and_log_det(z.reshape(48, 200))
    assert y.shape == z.shape and ld.shape == (3, 16)
    assert torch.equal(y.reshape(48, 200), y_flat) and torch.equal(ld.reshape(48), ld_flat)


def test_f64_input_takes_the_plain_path():
    """fab_tpu's dtype gate: an f64 input never reaches FusedCoupling."""
    layer = LargeFusedCoupling(200, WIDTH, scale_cap=CAP, dtype=torch.float64, device="cpu")
    z = torch.zeros((8, 200), dtype=torch.float64, requires_grad=True)
    recomputes = ck.FusedCoupling.recomputes
    y, ld = layer.inverse_and_log_det(z)
    torch.autograd.grad(ld.sum() + y.sum(), z)
    assert ck.FusedCoupling.recomputes == recomputes and y.dtype == torch.float64


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_fused_coupling_flow_matches_fab_tpu(dtype):
    """make_realnvp(fused_coupling=True, scale_cap=5): log q and its x-gradient
    against fab_tpu's flow (f64 1e-10; f32, through FusedCoupling, 1e-5 of scale)."""
    dim = 64
    with jax.enable_x64(dtype == torch.float64):
        jax_flow, params, flow = make_flow_pair(
            dim, 2, 2, dtype, seed=7, scale_cap=CAP, fused_coupling=True
        )
        x = np.random.default_rng(8).standard_normal((32, dim)).astype(
            np.float64 if dtype == torch.float64 else np.float32
        )
        log_q = lambda xi: jax_flow.log_prob(params, xi[None])[0]
        lq_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(log_q)))(x)
    assert all(isinstance(b, LargeFusedCoupling) for b in flow.bijectors[0::2])
    recomputes = ck.FusedCoupling.recomputes
    xg = torch.tensor(x, requires_grad=True)
    lq = flow.log_prob(xg)
    (g,) = torch.autograd.grad(lq.sum(), xg)
    assert (ck.FusedCoupling.recomputes - recomputes) == (2 if dtype == torch.float32 else 0)
    check = assert_close if dtype == torch.float64 else assert_close_to_scale
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    check(lq, lq_j, tol, "log_prob")
    check(g, g_j, tol, "grad_x log_prob")


def test_fused_and_fused_coupling_exclude_each_other():
    """K1's fused chain takes only the plain coupling; LargeFusedCoupling's padded
    last layer is not stacked into it."""
    with pytest.raises(ValueError, match="FusedRealNVPFlow needs"):
        make_realnvp(16, 2, 8, fused=True, fused_coupling=True, device="cpu")
