"""The numerics of K2's 3xTF32 design, on the CPU: TF32 rounding, the three-product
split at LGCP depth, the prepared weight copies and their invalidation.

K2 multiplies on the tensor cores in TF32 with each operand split into hi + lo
planes; ``fab_tpu_torch.ops.coupling_kernel`` keeps a plain-PyTorch emulation of
that arithmetic beside the kernel. Here it is held against float64 products,
against fab_tpu's kernel (Pallas interpret mode) and against the card tolerances
(y atol = rtol = 1e-4, log_det atol 2e-3: a 3200-deep f32 product and an 800-term
sum in another order).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fab_tpu.ops import coupling_kernel as jax_ck
from fab_tpu_torch.flows import LargeFusedCoupling
from fab_tpu_torch.ops import coupling_kernel as ck
from fab_tpu_torch.train import guarded_update, make_optimizer

LOW13 = 0x1FFF


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) & LOW13


def _rna_tf32_numpy(x: np.ndarray) -> np.ndarray:
    """Independent TF32 rounding of normal float32 numbers: keep 11 significant
    bits, round half away from zero, in float64 arithmetic."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    scaled = np.abs(m) * 2.0**11
    return (np.sign(m) * np.floor(scaled + 0.5) * 2.0 ** (e - 11)).astype(np.float32)


@pytest.mark.parametrize(
    "x, expected",
    [
        (1.0, 1.0),
        (1.0 + 2.0**-11, 1.0 + 2.0**-10),  # a tie: away from zero (even would give 1)
        (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
        (1.0 + 2.0**-11 - 2.0**-23, 1.0),  # just below the tie
        (3.0 * 2.0**-20 + 2.0**-31, 3.0 * 2.0**-20),
        (float("inf"), float("inf")),
        (-float("inf"), -float("inf")),
    ],
    ids=["one", "tie", "negative_tie", "below_tie", "small", "inf", "neg_inf"],
)
def test_tf32_round_follows_cvt_rna(x, expected):
    out = ck.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert out.item() == expected
    assert torch.isnan(ck.tf32_round(torch.tensor([float("nan")]))).all()


def test_tf32_round_matches_an_independent_rounding():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000)).astype(np.float32)
    out = ck.tf32_round(torch.tensor(x))
    assert torch.count_nonzero(_low_bits(out)) == 0
    np.testing.assert_array_equal(out.numpy(), _rna_tf32_numpy(x))


@pytest.mark.parametrize(
    "a_scale, b_scale", [(1.0, np.sqrt(2 / 3200)), (1.0, 0.01)], ids=["h2_like", "out_like"]
)
def test_three_tf32_products_hold_f32_accuracy_at_depth_3200(a_scale, b_scale):
    """At LGCP depth the split product stays within the card tolerances of the
    float64 product, with an error at least 100 x smaller than one TF32 pass."""
    rng = np.random.default_rng(1)
    a = torch.tensor(np.maximum(a_scale * rng.standard_normal((16, 3200)), 0.0),
                     dtype=torch.float32)  # post-ReLU activations
    b = torch.tensor(b_scale * rng.standard_normal((3200, 64)), dtype=torch.float32)
    exact = a.double() @ b.double()
    three = ck.matmul_tf32x3(ck.split_tf32(a), ck.split_tf32(b.T.contiguous()))
    one = ck.matmul_tf32(a, b)
    torch.testing.assert_close(three.double(), exact, atol=1e-4, rtol=1e-4)
    err_three = float((three.double() - exact).abs().max())
    err_one = float((one.double() - exact).abs().max())
    assert err_one >= 100 * err_three, (err_one, err_three)


@pytest.mark.parametrize(
    "k, n, n_cols", [(125, 256, 256), (64, 256, 200), (7, 16, 16), (3200, 64, 48)],
    ids=["d_cond_125", "w3p_first_cols", "tiny", "deep"],
)
def test_prepared_weight_layout_and_split(k, n, n_cols):
    """The plain twin of k2_prepare_weight: W^T [n_cols, K], split into TF32 hi and
    lo planes, depth padded with zeros to a multiple of 4; hi + lo = W to 2^-22."""
    w = torch.tensor(np.random.default_rng(2).standard_normal((k, n)), dtype=torch.float32)
    planes = ck.prepare_weight_reference(w, n_cols)
    k_pad = -(-k // 4) * 4
    assert planes.shape == (2, n_cols, k_pad) and planes.is_contiguous()
    assert torch.count_nonzero(planes[:, :, k:]) == 0
    assert torch.count_nonzero(_low_bits(planes)) == 0
    wt = w[:, :n_cols].T
    assert torch.equal(planes[0, :, :k], ck.tf32_round(wt))
    rebuilt = planes[0, :, :k].double() + planes[1, :, :k].double()
    assert float(((rebuilt - wt.double()).abs() / wt.double().abs()).max()) <= 2.0**-22


def test_split_rows_pads_and_reconstructs():
    x = torch.tensor(np.random.default_rng(3).standard_normal((5, 125)), dtype=torch.float32)
    planes = ck.split_rows_reference(x)
    assert planes.shape == (2, 5, 128) and torch.count_nonzero(planes[:, :, 125:]) == 0
    rebuilt = planes[0, :, :125].double() + planes[1, :, :125].double()
    assert float(((rebuilt - x.double()).abs() / x.double().abs()).max()) <= 2.0**-22


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_emulated_kernel_matches_plain_version_at_lgcp_widths(inverse):
    """The kernel's arithmetic at B=8, D=1600, H=3200 against the float64 plain
    version, within the card tolerances."""
    rng = np.random.default_rng(4)
    d, width, batch = 800, 3200, 8
    shapes = [(batch, d), (batch, d), (d, width), (width,), (width, width), (width,),
              (width, 1664), (1664,)]
    scales = [1.0, 1.0, np.sqrt(2 / d), 0.1, np.sqrt(2 / width), 0.1, 0.01, 0.01]
    ops = [torch.tensor(s * rng.standard_normal(shape), dtype=torch.float32)
           for shape, s in zip(shapes, scales)]
    ops[6][:, 2 * d:] = 0.0
    ops[7][2 * d:] = 0.0
    y, ld = ck.fused_coupling_apply_tf32x3_emulated(*ops, 5.0, inverse)
    y64, ld64 = ck.fused_coupling_apply_reference(*(o.double() for o in ops), 5.0, inverse)
    torch.testing.assert_close(y.double(), y64, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld.double(), ld64, atol=2e-3, rtol=0)


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_emulated_kernel_matches_pallas_kernel(inverse, monkeypatch):
    """fab_tpu's kernel in interpret mode and the 3xTF32 emulation, on the same
    inputs (tolerances as test_torch_coupling_kernel.py's for the plain version)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(5)
    d_cond, d_trans, width, batch = 100, 100, 512, 128
    shapes = [(batch, d_cond), (batch, d_trans), (d_cond, width), (width,),
              (width, width), (width,), (width, 256), (256,)]
    scales = [1.0, 1.0, np.sqrt(2 / d_cond), 0.1, np.sqrt(2 / width), 0.1, 0.01, 0.01]
    ops = [(s * rng.standard_normal(shape)).astype(np.float32)
           for shape, s in zip(shapes, scales)]
    ops[6][:, 2 * d_trans:] = 0.0
    ops[7][2 * d_trans:] = 0.0
    y_j, ld_j = jax_ck.fused_coupling_apply(*(jnp.asarray(a) for a in ops), 5.0, inverse, 64, True)
    y, ld = ck.fused_coupling_apply_tf32x3_emulated(*(torch.tensor(a) for a in ops), 5.0, inverse)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), atol=2e-4, rtol=0)


# ------------------------------------------------------ the prepared-copy cache


def _update_w1(layer: LargeFusedCoupling, how: str) -> None:
    """Change the first layer's weight in place, as the port's users do."""
    w = layer.mlp[0].w
    if how == "add_":
        with torch.no_grad():
            w.add_(1e-3)
    elif how == "guarded_update":
        opt = make_optimizer(1e-3, 100.0)
        guarded_update(opt, [torch.ones_like(w)], opt.init([w]), [w], torch.tensor(1.0))
    elif how == "torch_adam":
        w.grad = torch.ones_like(w)
        torch.optim.Adam([w], lr=1e-3).step()
    elif how == "load_state_dict":
        state = layer.mlp[0].state_dict()
        layer.mlp[0].load_state_dict({k: v + 1e-3 for k, v in state.items()})
    else:
        raise ValueError(how)


@pytest.mark.parametrize("how", ["add_", "guarded_update", "torch_adam", "load_state_dict"])
def test_prepared_copy_is_rebuilt_after_an_in_place_update(how):
    """After an update of w1 the next call rebuilds w1's copy from the new values,
    and the untouched w2 keeps its copy."""
    layer = LargeFusedCoupling(16, 128, scale_cap=5.0, device="cpu")
    l1, l2, _ = layer.mlp
    first_w1, first_w2 = ck.prepared_weight(l1.w, 128), ck.prepared_weight(l2.w, 128)
    rebuilds = ck.prepared_weight.rebuilds
    assert ck.prepared_weight(l1.w, 128) is first_w1  # unchanged: no rebuild
    assert ck.prepared_weight.rebuilds == rebuilds
    _update_w1(layer, how)
    new_w1 = ck.prepared_weight(l1.w, 128)
    assert ck.prepared_weight.rebuilds == rebuilds + 1
    assert not torch.equal(new_w1, first_w1)
    assert torch.equal(new_w1, ck.prepare_weight_reference(l1.w.detach(), 128))
    assert ck.prepared_weight(l2.w, 128) is first_w2
    assert ck.prepared_weight.rebuilds == rebuilds + 1


def test_prepared_copy_goes_with_its_weight():
    """A freed weight's entry leaves the cache, so a new tensor can never find it."""
    w = torch.randn(8, 128)
    ck.prepared_weight(w, 128)
    key = id(w)
    assert key in ck._PREPARED
    del w
    assert key not in ck._PREPARED
