"""K1's Hopper design on the CPU: its 3xTF32 arithmetic, its launch planner and the
hash that rebuilds a kernel library when a shared header changes.

K1 (``csrc/realnvp_kernel.cu``) multiplies on the tensor cores in TF32 with each
operand split into hi + lo; ``fused_realnvp_pass_tf32x3_emulated`` repeats that
arithmetic and its order of sums in plain PyTorch. Here it is held against the
float64 plain chain at ManyWell-32 widths within the card tolerances (y atol = rtol
= 1e-4, log_det atol 1e-3: 10 layers of f32 products and sums in another order),
and against fab_tpu's K1 in Pallas interpret mode.
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
from fab_tpu_torch.flows import make_realnvp
from fab_tpu_torch.flows.fused import _stack_params
from fab_tpu_torch.ops import build as build_lib
from fab_tpu_torch.ops import realnvp_kernel as rk
from fab_tpu_torch.ops import tf32x3
from torch_parity_utils import make_flow_pair

KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "wlin", "lu_ld")


def _manywell_operands(inverse, dtype):
    """Stacked operands of a ManyWell-32 flow (D=32, H=320, L=10), every parameter
    perturbed by 0.005 N(0, 1) from numpy (a fresh coupling's last layer is zero)."""
    flow = make_realnvp(32, 10, 10, fused=True, dtype=torch.float64, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(torch.tensor(0.005 * rng.standard_normal(tuple(p.shape))))
        s = _stack_params(flow, inverse)
    return [s[k].to(dtype) for k in KEYS]


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_emulated_kernel_matches_float64_chain_at_manywell_widths(inverse):
    x = torch.tensor(np.random.default_rng(8).standard_normal((64, 32)))
    ops64 = _manywell_operands(inverse, torch.float64)
    y64, ld64 = rk.fused_realnvp_pass_reference(x, *ops64, inverse)
    ops32 = [t.float() for t in ops64]
    y, ld = rk.fused_realnvp_pass_tf32x3_emulated(x.float(), *ops32, inverse)
    assert y.dtype == ld.dtype == torch.float32
    assert torch.isfinite(y64).all() and float(y64.abs().max()) > 1.0
    torch.testing.assert_close(y.double(), y64, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld.double(), ld64, atol=1e-3, rtol=0)
    # As close as the plain chain in float32 is, within a small factor.
    y32, _ = rk.fused_realnvp_pass_reference(x.float(), *ops32, inverse)
    err, err_plain = (float((t.double() - y64).abs().max()) for t in (y, y32))
    assert err <= 4 * err_plain + 1e-6, (err, err_plain)


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_emulated_kernel_matches_pallas_kernel(inverse, monkeypatch):
    """fab_tpu's K1 in interpret mode and the 3xTF32 emulation on the same inputs
    (D=8, H=32, L=3; tolerance: f32 over 3 layers, the emulation's splits ~2^-22)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    _, params, flow = make_flow_pair(8, 3, 4, torch.float32, fused=True)
    x = np.random.default_rng(9).standard_normal((64, 8)).astype(np.float32)
    s_j = jax_stack_params(jax.tree.map(jnp.asarray, params), inverse=inverse)
    y_j, ld_j = jax_rk.fused_realnvp_pass(
        jnp.asarray(x), *(s_j[k] for k in KEYS), inverse=inverse, tile_b=32
    )
    with torch.no_grad():
        s = _stack_params(flow, inverse)
        y, ld = rk.fused_realnvp_pass_tf32x3_emulated(torch.tensor(x), *(s[k] for k in KEYS),
                                                      inverse)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), atol=2e-5, rtol=0)


def _wide_operands(D, d_cond, H, L, rng):
    """Random float64 operands of a chain of any split: He-initialised hidden layers,
    a small last layer (log-scales ~0.1), orthogonal LU mixes."""
    n3 = 2 * (D - d_cond)
    normal = lambda *shape: rng.standard_normal(shape)
    wlin = np.stack([np.linalg.qr(normal(D, D))[0] for _ in range(L)])
    ops = [normal(L, d_cond, H) * np.sqrt(2 / d_cond), 0.1 * normal(L, H),
           normal(L, H, H) * np.sqrt(2 / H), 0.1 * normal(L, H),
           normal(L, H, n3) * 0.1 / np.sqrt(H), 0.05 * normal(L, n3), wlin,
           0.1 * normal(L, 1)]
    return [torch.tensor(a) for a in ops]


@pytest.mark.parametrize("shape", [(32, 16, 640), (64, 32, 640), (32, 8, 320)],
                         ids=["d32_h640", "d64_h640", "d32_dcond8"])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_emulated_kernel_matches_float64_chain_at_wide_widths(shape, inverse):
    """The wide chains the kernel now takes, in its stage order (two column groups of
    H and two 320-deep chunks of W3 at H=640; two 32-column boxes of z and Wlin at
    D=64; two column groups of W3 at d_cond=8), within the card tolerances of the
    float64 chain (10 layers)."""
    D, d_cond, H = shape
    rng = np.random.default_rng(14)
    ops64 = _wide_operands(D, d_cond, H, 10, rng)
    x = torch.tensor(rng.standard_normal((48, D)))
    y64, ld64 = rk.fused_realnvp_pass_reference(x, *ops64, inverse)
    y, ld = rk.fused_realnvp_pass_tf32x3_emulated(x.float(), *(t.float() for t in ops64),
                                                  inverse)
    assert torch.isfinite(y64).all() and float(y64.abs().max()) > 1.0
    torch.testing.assert_close(y.double(), y64, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld.double(), ld64, atol=1e-3, rtol=0)
    y32, _ = rk.fused_realnvp_pass_reference(x.float(), *(t.float() for t in ops64), inverse)
    err, err_plain = (float((t.double() - y64).abs().max()) for t in (y, y32))
    assert err <= 4 * err_plain + 1e-6, (err, err_plain)


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_wide_emulation_matches_pallas_kernel(inverse, monkeypatch):
    """fab_tpu's K1 in interpret mode against the kernel's arithmetic at a small
    shape with every split of the wide layout: D=72 (three 32-column boxes of z and
    Wlin), d_cond=40 (two 32-deep W1 stages), 2 d_trans = 64 (two W3 column groups),
    H=352 (two column groups, two W3 depth chunks)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(15)
    ops = [t.float() for t in _wide_operands(72, 40, 352, 2, rng)]
    x = rng.standard_normal((64, 72)).astype(np.float32)
    y_j, ld_j = jax_rk.fused_realnvp_pass(
        jnp.asarray(x), *(jnp.asarray(t.numpy()) for t in ops), inverse=inverse, tile_b=32
    )
    plan = rk.plan_launch(64, 72, 40, 352, 2)
    assert plan.groups == 2 and len(plan.stages) == 31
    y, ld = rk.fused_realnvp_pass_tf32x3_emulated(torch.tensor(x), *ops, inverse)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), atol=2e-5, rtol=0)


def test_per_stage_sums_beat_one_truncating_accumulator_at_depth_320():
    """Why W2's 32-deep stages are summed apart: in the model of the tensor cores'
    truncating accumulation, one accumulator over K1's depth of 320 errs several
    times more than the staged order, which stays at the plain f32 grade."""
    rng = np.random.default_rng(10)
    a = torch.tensor(np.maximum(rng.standard_normal((16, 320)), 0.0))  # post-ReLU h1
    b = torch.tensor(np.sqrt(2 / 320) * rng.standard_normal((320, 320)))  # He init W2
    exact = a @ b
    err = {stage: float((tf32x3.truncating_chain(a, b, 8, stage).double() - exact).abs().max())
           for stage in (32, 320)}
    plain = float(((a.float() @ b.float()).double() - exact).abs().max())
    assert err[320] >= 5 * err[32], err
    assert err[32] <= 2 * plain, (err, plain)


def test_staged_product_sums_stages_in_order():
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.standard_normal((16, 96)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((96, 24)), dtype=torch.float32)
    staged = tf32x3.matmul_tf32x3_staged(a, b, 32)
    by_hand = sum(
        tf32x3.matmul_tf32x3(tf32x3.split_tf32(a[:, k:k + 32]),
                             tf32x3.split_tf32(b[k:k + 32].T.contiguous()))
        for k in (0, 32, 64)
    )
    assert torch.equal(staged, by_hand)
    torch.testing.assert_close(staged.double(), a.double() @ b.double(), atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------- launch planner


def test_plan_at_the_main_path_shape():
    plan = rk.plan_launch(2048, 32, 16, 320, 10)
    assert (plan.D, plan.d_cond, plan.H) == (32, 16, 320)  # nothing to pad
    assert rk.CLUSTER == 2
    assert (plan.blocks, plan.clusters, plan.padded_rows) == (128, 64, 0)
    assert (plan.h_pad, plan.d_cond_pad, plan.n3_pad) == (320, 16, 32)
    assert (plan.slots, plan.slot_bytes, plan.stages_per_layer) == (4, 40960, 13)
    assert plan.smem_bytes == 212032 <= rk.MAX_SMEM
    assert plan.clusters * rk.CLUSTER * rk.ROWS == 2048
    # One weight stream: 10 layers of W1 (16 x 320), W2 (320 x 320), W3 (320 x 32)
    # and Wlin (32 x 32), as loaded.
    assert plan.tma_bytes_per_pass == 10 * 4 * (16 * 320 + 320 * 320 + 320 * 32 + 32 * 32)
    # L2 reads, reckoned: from one stream per block to one per cluster (plus biases).
    assert round(plan.l2_read_bytes_unshared / 1e6) == 612
    assert round(plan.l2_read_bytes / 1e6) == 308


@pytest.mark.parametrize(
    "batch, blocks, padded", [(1, 2, 31), (100, 8, 28), (2047, 128, 1), (2049, 130, 31)]
)
def test_plan_pads_ragged_batches_to_whole_clusters(batch, blocks, padded):
    plan = rk.plan_launch(batch, 32, 16, 320, 10)
    assert (plan.blocks, plan.clusters, plan.padded_rows) == (blocks, blocks // 2, padded)
    assert plan.blocks * rk.ROWS == batch + plan.padded_rows


def test_plan_pads_the_small_test_shape():
    """D=8, H=32, L=3: W1's depth 4 padded to one 8-deep step, 2 * d_trans = 8
    columns of W3 in one tile, H to one 32-column box; the ring's slots shrink."""
    plan = rk.plan_launch(100, 8, 4, 32, 3)
    assert (plan.h_pad, plan.d_cond_pad, plan.n3_pad, plan.stages_per_layer) == (32, 8, 8, 4)
    assert (plan.slot_bytes, plan.slots) == (4096, 4)
    assert plan.smem_bytes < 32 * 1024


@pytest.mark.parametrize(
    "shape, kernel_shape",
    [((100, 6, 3, 24, 2), (8, 4, 24)), ((100, 2, 1, 20, 2), (4, 2, 20)),
     ((100, 8, 3, 32, 2), (12, 4, 32)), ((100, 30, 15, 318, 2), (32, 16, 320)),
     ((100, 10, 4, 40, 2), (12, 4, 40))],
    ids=["d6", "d2", "odd_split", "ragged_h", "d10"],
)
def test_plan_pads_shapes_tma_cannot_address(shape, kernel_shape):
    """TMA's 16-byte strides: d_trans even, D and H multiples of 4. A shape that
    misses only that runs zero-padded (many_well_fast's D=6 and gmm's D=2 among
    them)."""
    plan = rk.plan_launch(*shape)
    assert (plan.D, plan.d_cond, plan.H) == kernel_shape
    assert plan.D % 4 == 0 and (plan.D - plan.d_cond) % 2 == 0 and plan.H % 4 == 0


@pytest.mark.parametrize(
    "shape, words",
    [((100, 32, 16, 2048, 2), "shared memory"), ((100, 32, 16, 1280, 2), "shared memory"),
     ((100, 256, 128, 64, 2), "shared memory"), ((100, 8, 8, 32, 2), "d_cond"),
     ((0, 8, 4, 32, 2), "B=0")],
    ids=["deep_h", "wide_h", "wide_d", "no_trans", "no_rows"],
)
def test_plan_refuses_shapes_the_kernel_cannot_take(shape, words):
    """Only a shape whose 16 rows of activations and a 2-slot ring miss the 227 KB of
    shared memory (or that has no rows or no transformed half) is refused."""
    with pytest.raises(ValueError, match=words):
        rk.plan_launch(*shape)


@pytest.mark.parametrize(
    "shape",
    [(100, 36, 18, 320, 2), (100, 32, 15, 320, 2), (100, 32, 8, 320, 2),
     (100, 32, 16, 324, 2), (100, 32, 16, 640, 2)],
    ids=["wide", "wide_after_pad", "wide_trans", "ragged_h", "deep_h"],
)
def test_plan_takes_shapes_the_earlier_hopper_kernel_refused(shape):
    """D > 32, 2 d_trans > 32 and H > 320 (after padding) run, with at least a
    2-slot ring and within shared memory."""
    plan = rk.plan_launch(*shape)
    assert plan.slots >= 2 and plan.smem_bytes <= rk.MAX_SMEM


@pytest.mark.parametrize(
    "shape, layout",
    [((2048, 32, 16, 640, 10), dict(groups=2, z_stride=40, slots=3, smem=212016,
                                     stages=[("w1", 10, 16)] * 2 + [("w2", 10, 32)] * 40
                                     + [("w3", 10, 32)] * 2 + [("wlin", 1, 32)])),
     ((2048, 64, 32, 640, 10), dict(groups=2, z_stride=72, slots=3, smem=216112,
                                     stages=[("w1", 10, 32)] * 2 + [("w2", 10, 32)] * 40
                                     + [("w3", 10, 32)] * 4 + [("wlin", 2, 64)])),
     ((2048, 32, 8, 320, 10), dict(groups=1, z_stride=40, slots=4, smem=215616,
                                    stages=[("w1", 10, 8), *[("w2", 10, 32)] * 10,
                                            ("w3", 10, 32), ("w3", 10, 32), ("wlin", 1, 32)])),
     ((64, 72, 40, 352, 2), dict(groups=2, z_stride=104, slots=3, smem=None,
                                 stages=[("w1", 10, 32), ("w1", 10, 32), ("w1", 1, 32),
                                         ("w1", 1, 32)] + [("w2", 10, 32)] * 11
                                 + [("w2", 1, 32)] * 11 + [("w3", 10, 32), ("w3", 1, 32)] * 2
                                 + [("wlin", 3, 72)]))],
    ids=["d32_h640", "d64_h640", "d32_dcond8", "small_wide"],
)
def test_plan_splits_wide_chains_into_bounded_stages(shape, layout):
    """Every ring stage is at most 32 deep and 320 wide: W1 and W2 per 320-column
    group of H (W1 in 32-deep stages), W3 per 32-column group and 320-deep chunk,
    Wlin over D's 32-column boxes; the slot is the largest stage."""
    B, D, d_cond, H, L = shape
    plan = rk.plan_launch(*shape)
    assert (plan.D, plan.d_cond, plan.H) == (D, d_cond, H)
    assert (plan.groups, plan.z_stride, plan.slots) == (
        layout["groups"], layout["z_stride"], layout["slots"])
    assert list(plan.stages) == layout["stages"]
    if layout["smem"] is not None:
        assert plan.smem_bytes == layout["smem"]
    assert plan.smem_bytes <= rk.MAX_SMEM
    assert all(n <= rk.GROUP // 32 for kind, n, rows in plan.stages if kind != "wlin")
    assert all(rows <= 32 for kind, n, rows in plan.stages if kind != "wlin")
    assert plan.slot_bytes == max(n * rows * 128 for _, n, rows in plan.stages)
    assert plan.tma_bytes_per_pass == L * sum(n * rows * 128 for _, n, rows in plan.stages)


def test_w3_slices_cover_each_chunk_once():
    """W3's depth at H=640: two 320-deep chunks, each split over the 8 warps; every
    8-deep step is summed by exactly one warp, inside one chunk."""
    ranges = rk._w3_step_ranges(640)
    steps = sorted(k for mine in ranges for s0, s1 in mine for k in range(s0, s1))
    assert steps == list(range(80))
    for mine in ranges:
        assert len(mine) == 2
        assert all(s1 <= 40 for s0, s1 in mine[:1]) and all(s0 >= 40 for s0, s1 in mine[1:])
    assert rk._w3_step_ranges(320) == [[(5 * w, 5 * w + 5)] for w in range(8)]


def _random_operands(dim, layers, nodes, rng, dtype=torch.float64):
    flow = make_realnvp(dim, layers, nodes, fused=True, dtype=dtype, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(torch.tensor(0.05 * rng.standard_normal(tuple(p.shape)), dtype=dtype))
        return {inverse: [t.clone() for t in (_stack_params(flow, inverse)[k] for k in KEYS)]
                for inverse in (False, True)}


@pytest.mark.parametrize("shape", [(6, 3, 4), (2, 3, 10), (10, 2, 4), (30, 2, 10)],
                         ids=["d6", "d2", "d10", "d30"])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_zero_padding_is_exact(shape, inverse):
    """The chain on the padded operands gives the caller's y and log-det (float64,
    to rounding), and every padded column of y is exactly zero."""
    dim, layers, nodes = shape
    rng = np.random.default_rng(12)
    ops = _random_operands(dim, layers, nodes, rng)[inverse]
    x = torch.tensor(rng.standard_normal((37, dim)))
    plan = rk.plan_launch(37, dim, ops[0].shape[1], ops[0].shape[2], layers)
    assert (plan.D, plan.H) != (dim, dim * nodes)
    padded, keep = rk._embed(plan, x, *ops)
    y_pad, ld_pad = rk.fused_realnvp_pass_reference(*padded, inverse)
    y, ld = rk.fused_realnvp_pass_reference(x, *ops, inverse)
    torch.testing.assert_close(y_pad[:, keep], y, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(ld_pad, ld, atol=1e-12, rtol=1e-12)
    others = torch.ones(plan.D, dtype=torch.bool)
    others[keep] = False
    assert int(others.sum()) == plan.D - dim and torch.all(y_pad[:, others] == 0)


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_padded_emulation_matches_pallas_kernel_at_d6(inverse, monkeypatch):
    """fab_tpu's K1 test width (D=6, d_cond=3: odd) in interpret mode against the
    kernel's arithmetic on the operands the wrapper pads for the card (D=8,
    d_cond=4)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    _, params, flow = make_flow_pair(6, 3, 4, torch.float32, fused=True)
    x = np.random.default_rng(13).standard_normal((64, 6)).astype(np.float32)
    s_j = jax_stack_params(jax.tree.map(jnp.asarray, params), inverse=inverse)
    y_j, ld_j = jax_rk.fused_realnvp_pass(
        jnp.asarray(x), *(s_j[k] for k in KEYS), inverse=inverse, tile_b=32
    )
    with torch.no_grad():
        s = _stack_params(flow, inverse)
        ops = [s[k] for k in KEYS]
        plan = rk.plan_launch(64, 6, ops[0].shape[1], ops[0].shape[2], 3)
        padded, keep = rk._embed(plan, torch.tensor(x), *ops)
        y, ld = rk.fused_realnvp_pass_tf32x3_emulated(*padded, inverse)
    assert (plan.D, plan.d_cond) == (8, 4)
    np.testing.assert_allclose(y[:, keep].numpy(), np.asarray(y_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), atol=2e-5, rtol=0)


# ------------------------------------------------------------ the library hash


def test_library_hash_follows_local_headers(tmp_path):
    """Editing a header that a source includes, directly or through another header,
    changes the library's name; K1 and K2 both include the shared header."""
    (tmp_path / "inner.cuh").write_text("#define X 1\n")
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n#include <cstdint>\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "outer.cuh"\n#include "inner.cuh"\nint f() { return X; }\n')
    assert [p.name for p in build_lib.local_files(src)] == ["k.cu", "outer.cuh", "inner.cuh"]
    first = build_lib.source_digest(src)
    assert build_lib.source_digest(src) == first
    (tmp_path / "inner.cuh").write_text("#define X 2\n")
    assert build_lib.source_digest(src) != first
    for name in ("realnvp_kernel.cu", "coupling_kernel.cu"):
        files = [p.name for p in build_lib.local_files(build_lib.CSRC / name)]
        assert files == [name, "hopper_common.cuh"]
