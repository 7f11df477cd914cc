"""K2: one affine-coupling layer at large event dim, fused.

Replaces the Pallas TPU kernel ``fab_tpu/ops/coupling_kernel.py:fused_coupling_apply``
(launcher ``_coupling_pallas``, ``pallas_call`` at line 167). The CUDA source is
``csrc/coupling_kernel.cu``; its header says what bounds the kernel on an H100
(tensor-core operations: 3 x 18.35 GFLOP of TF32 per call at the LGCP-1600 shapes
B=512, D=1600, H=3200, 0.111 ms at 495 TFLOP/s) and the design: three ``wgmma``
GEMMs in 3xTF32 (f32 accuracy from hi/lo TF32 splits), fed by TMA, with fused
epilogues.

- ``fused_coupling_apply`` launches the kernel for CUDA tensors (f32 only) and
  takes the plain PyTorch version, ``fused_coupling_apply_reference``, only for CPU
  tensors. ``fused_coupling_apply.launches`` counts calls that launched the kernel
  (one per coupling layer, although one call is five device launches).
- ``prepared_weight`` holds each weight's prepared copy (W^T as TF32 hi/lo planes,
  the only layout TF32 ``wgmma`` reads) and rebuilds it when the weight changes:
  the cache is keyed on the tensor's ``(data_ptr, _version)``, which every in-place
  update bumps (an optimizer step, ``load_state_dict``, ``p.add_``; a write through
  ``p.data`` does not, and the port makes none). ``prepared_weight.rebuilds`` counts
  the rebuilds.
- ``FusedCoupling`` is the autograd Function: kernel forward, backward by
  recomputing the plain version under autograd, as ``_bwd`` does in JAX (there is
  no backward kernel on the TPU either). ``FusedCoupling.recomputes`` counts them.
- ``pad_cols`` pads the conditioner's last layer to a multiple of 128 columns;
  only the first 2 * d_trans columns are ever read, so the pad gets zero gradient.
- ``fused_coupling_apply_tf32x3_emulated`` repeats the kernel's arithmetic in plain
  PyTorch for the CPU tests, with ``tf32_round``, ``split_tf32`` and
  ``matmul_tf32x3`` from ``tf32x3.py`` (shared with K1, re-exported here); the main
  path never calls them.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import weakref
from typing import Tuple

import torch
import torch.nn.functional as F

from fab_tpu_torch.ops import build as build_lib
from fab_tpu_torch.ops.tf32x3 import (  # noqa: F401  (re-exported for the tests)
    matmul_tf32,
    matmul_tf32x3,
    split_tf32,
    tf32_round,
)

SRC = build_lib.CSRC / "coupling_kernel.cu"


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _pad4(n: int) -> int:
    """Depth padded to a multiple of 4 floats: TMA wants 16-byte row strides."""
    return -(-n // 4) * 4


def build() -> pathlib.Path:
    """Compile the kernel library (if its source changed) and return its path."""
    return build_lib.build(SRC)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_coupling_apply_f32.argtypes = (
        [ptr] * 14 + [i32] * 4 + [ctypes.c_float, i32, ptr]
    )
    lib.fused_coupling_apply_f32.restype = i32
    lib.coupling_prepare_weight_f32.argtypes = [ptr, i32, i32, i32, ptr, ptr]
    lib.coupling_prepare_weight_f32.restype = i32
    lib.coupling_set_encoder.argtypes = [ptr]
    lib.coupling_set_encoder.restype = None
    # The tensor maps are encoded by libcuda's cuTensorMapEncodeTiled; libcuda is
    # already loaded by PyTorch's CUDA runtime.
    libcuda = ctypes.CDLL("libcuda.so.1")
    lib.coupling_set_encoder(ctypes.cast(libcuda.cuTensorMapEncodeTiled, ctypes.c_void_p))
    lib.coupling_partial_tiles.argtypes = [i32]
    lib.coupling_partial_tiles.restype = i32
    lib.coupling_error_string.argtypes = [i32]
    lib.coupling_error_string.restype = ctypes.c_char_p
    return lib


def _coupling_out(out, z_trans, scale_cap, inverse):
    """The affine step and log-det from the conditioner's first 2 * d_trans outputs."""
    d_trans = z_trans.shape[-1]
    shift, log_scale = out[..., :d_trans], out[..., d_trans:]
    if scale_cap > 0.0:
        log_scale = scale_cap * torch.tanh(log_scale / scale_cap)
    if inverse:
        return (z_trans - shift) * torch.exp(-log_scale), -log_scale.sum(-1)
    return z_trans * torch.exp(log_scale) + shift, log_scale.sum(-1)


def fused_coupling_apply_reference(
    z_cond: torch.Tensor,
    z_trans: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    w3p: torch.Tensor,
    b3p: torch.Tensor,
    scale_cap: float,
    inverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (``coupling_kernel.py:_coupling_jnp``).

    Reads only the first 2 * d_trans columns of the padded last layer.
    """
    d_trans = z_trans.shape[-1]
    h = torch.relu(z_cond @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    out = h @ w3p[:, : 2 * d_trans] + b3p[: 2 * d_trans]
    return _coupling_out(out, z_trans, scale_cap, inverse)


def split_rows_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``k2_split_rows``: x [M, K] as planes [2, M, pad4(K)], the
    pad zero."""
    return split_tf32(F.pad(x, (0, _pad4(x.shape[-1]) - x.shape[-1])))


def prepare_weight_reference(w: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Plain version of ``k2_prepare_weight``: the first ``n_cols`` columns of
    w [K, N] transposed and split, planes [2, n_cols, pad4(K)], the pad zero."""
    wt = w[:, :n_cols].t()
    return split_tf32(F.pad(wt, (0, _pad4(w.shape[0]) - w.shape[0]))).contiguous()


def fused_coupling_apply_tf32x3_emulated(
    z_cond, z_trans, w1, b1, w2, b2, w3p, b3p, scale_cap, inverse
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch (float32): split operands, three
    TF32 products per GEMM, h1 and h2 split again after bias + ReLU."""
    d_trans, H = z_trans.shape[-1], w1.shape[-1]
    h = matmul_tf32x3(split_rows_reference(z_cond), prepare_weight_reference(w1, H))
    h = torch.relu(h + b1)
    h = torch.relu(matmul_tf32x3(split_tf32(h), prepare_weight_reference(w2, H)) + b2)
    out = matmul_tf32x3(split_tf32(h), prepare_weight_reference(w3p, 2 * d_trans))
    return _coupling_out(out + b3p[: 2 * d_trans], z_trans, scale_cap, inverse)


def prepare_weight_on_card(w: torch.Tensor, n_cols: int) -> torch.Tensor:
    """``k2_prepare_weight`` on a CUDA weight w [K, N] (f32, contiguous): planes
    [2, n_cols, pad4(K)]."""
    if w.device.type != "cuda" or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("prepare_weight_on_card: w must be a contiguous float32 CUDA tensor")
    if w.dim() != 2 or not 0 < n_cols <= w.shape[1]:
        raise ValueError(f"prepare_weight_on_card: {n_cols} columns of a {tuple(w.shape)} weight")
    k = w.shape[0]
    planes = torch.empty((2, n_cols, _pad4(k)), dtype=torch.float32, device=w.device)
    lib = _library()
    err = lib.coupling_prepare_weight_f32(
        w.data_ptr(), k, n_cols, w.shape[1], planes.data_ptr(),
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "k2_prepare_weight launch failed: " + lib.coupling_error_string(err).decode()
        )
    return planes


_PREPARED = {}  # id(weight) -> (weak reference to it, key, planes)


def prepared_weight(w: torch.Tensor, n_cols: int) -> torch.Tensor:
    """The prepared copy of the first ``n_cols`` columns of w [K, N]: W^T as TF32
    hi/lo planes [2, n_cols, pad4(K)]. Built again only when ``w`` has changed
    since: its key is ``(data_ptr, _version)``. A CUDA weight goes through
    ``k2_prepare_weight``, a CPU weight through its plain version."""
    key = (w.data_ptr(), w._version, tuple(w.shape), w.device, n_cols)
    entry = _PREPARED.get(id(w))
    if entry is not None and entry[0]() is w and entry[1] == key:
        return entry[2]
    if w.device.type == "cpu":
        planes = prepare_weight_reference(w, n_cols)
    else:
        planes = prepare_weight_on_card(w, n_cols)
    # The entry goes with the weight, before its id can be reused.
    ref = weakref.ref(w, lambda _, i=id(w): _PREPARED.pop(i, None))
    _PREPARED[id(w)] = (ref, key, planes)
    prepared_weight.rebuilds += 1
    return planes


prepared_weight.rebuilds = 0


def forget_prepared() -> None:
    """Empty the prepared-weight cache, so the next pass rebuilds every copy. A
    replayed CUDA graph updates the weights without moving their ``_version``
    (``graph.py`` calls this around a capture and after each replay)."""
    _PREPARED.clear()


def fused_coupling_apply(
    z_cond: torch.Tensor,  # [B, d_cond]
    z_trans: torch.Tensor,  # [B, d_trans]
    w1: torch.Tensor,  # [d_cond, H]
    b1: torch.Tensor,  # [H]
    w2: torch.Tensor,  # [H, H]
    b2: torch.Tensor,  # [H]
    w3p: torch.Tensor,  # [H, P], P >= 2 * d_trans
    b3p: torch.Tensor,  # [P]
    scale_cap: float,
    inverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_trans [B, d_trans], log_det [B]) of one affine-coupling layer."""
    if z_cond.device.type == "cpu":
        return fused_coupling_apply_reference(
            z_cond, z_trans, w1, b1, w2, b2, w3p, b3p, scale_cap, inverse
        )
    if z_cond.device.type != "cuda":
        raise ValueError(f"fused_coupling_apply: unsupported device {z_cond.device}")
    operands = {"z_cond": z_cond, "z_trans": z_trans, "w1": w1, "b1": b1, "w2": w2,
                "b2": b2, "w3p": w3p, "b3p": b3p}
    for name, t in operands.items():
        if t.device != z_cond.device:
            raise ValueError("fused_coupling_apply: all operands must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_coupling_apply: {name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"fused_coupling_apply: {name} must be contiguous")
    if z_cond.dim() != 2 or z_trans.dim() != 2 or z_trans.shape[0] != z_cond.shape[0]:
        raise ValueError(
            "fused_coupling_apply: z_cond and z_trans must be [B, d_cond] and "
            f"[B, d_trans], got {tuple(z_cond.shape)} and {tuple(z_trans.shape)}"
        )
    B, d_cond = z_cond.shape
    d_trans = z_trans.shape[1]
    H = w1.shape[-1]
    P = w3p.shape[-1]
    expected = {"w1": (d_cond, H), "b1": (H,), "w2": (H, H), "b2": (H,),
                "w3p": (H, P), "b3p": (P,)}
    for name, shape in expected.items():
        if tuple(operands[name].shape) != shape:
            raise ValueError(
                f"fused_coupling_apply: {name} has shape {tuple(operands[name].shape)}, "
                f"expected {shape}"
            )
    if P < 2 * d_trans:
        raise ValueError(
            f"fused_coupling_apply: w3p has {P} columns, needs at least {2 * d_trans}"
        )
    if H % 4:
        raise ValueError(f"fused_coupling_apply: the kernel takes H a multiple of 4, got {H}")
    if B == 0:
        return torch.empty_like(z_trans), z_trans.new_empty((0,))
    lib = _library()
    empty = functools.partial(torch.empty, dtype=torch.float32, device=z_cond.device)
    y, log_det = empty((B, d_trans)), empty((B,))
    # Workspaces: zc and h1, h2 as TF32 hi/lo planes; zc's depth padded to a
    # multiple of 4 (a d_cond of 125 has a 500-byte row stride, which TMA refuses).
    zc_planes = empty((2, B, _pad4(d_cond)))
    h1, h2 = empty((2, B, H)), empty((2, B, H))
    partial = empty((B, lib.coupling_partial_tiles(d_trans)))
    with torch.cuda.device(z_cond.device):
        prepared = (prepared_weight(w1, H), prepared_weight(w2, H),
                    prepared_weight(w3p, 2 * d_trans))
        err = lib.fused_coupling_apply_f32(
            z_cond.data_ptr(), z_trans.data_ptr(),
            prepared[0].data_ptr(), b1.data_ptr(), prepared[1].data_ptr(), b2.data_ptr(),
            prepared[2].data_ptr(), b3p.data_ptr(),
            y.data_ptr(), log_det.data_ptr(), zc_planes.data_ptr(), h1.data_ptr(),
            h2.data_ptr(), partial.data_ptr(),
            B, d_cond, d_trans, H, float(scale_cap), int(inverse),
            torch.cuda.current_stream(z_cond.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "fused_coupling_apply launch failed: " + lib.coupling_error_string(err).decode()
        )
    fused_coupling_apply.launches += 1
    return y, log_det


fused_coupling_apply.launches = 0


class FusedCoupling(torch.autograd.Function):
    """K2 forward; backward by recomputing the plain version under autograd.

    ``gather`` (optional, last): a ``parallel.tensor.GatheredWeights`` for weights
    split over a model axis. The kernel and the recompute then take the whole
    weights, and the weights' gradients go back as this rank's slices."""

    recomputes = 0

    @staticmethod
    def forward(ctx, scale_cap, inverse, z_cond, z_trans, w1, b1, w2, b2, w3p, b3p,
                gather=None):
        ctx.scale_cap, ctx.inverse, ctx.gather = scale_cap, inverse, gather
        weights = (w1, b1, w2, b2, w3p, b3p)
        if gather is not None:
            weights = gather.whole(weights)
        ctx.save_for_backward(z_cond, z_trans, *weights)
        return fused_coupling_apply(z_cond, z_trans, *weights, scale_cap, inverse)

    @staticmethod
    def backward(ctx, grad_y, grad_ld):
        FusedCoupling.recomputes += 1
        needs = ctx.needs_input_grad[2:10]
        with torch.enable_grad():
            inputs = [
                t.detach().requires_grad_(need)
                for t, need in zip(ctx.saved_tensors, needs)
            ]
            y, ld = fused_coupling_apply_reference(*inputs, ctx.scale_cap, ctx.inverse)
            wanted = [t for t, need in zip(inputs, needs) if need]
            grads = iter(
                torch.autograd.grad((y, ld), wanted, (grad_y, grad_ld), allow_unused=True)
            )
        grads = [next(grads) if need else None for need in needs]
        if ctx.gather is not None:
            grads = grads[:2] + ctx.gather.own(grads[2:])
        return (None, None, *grads) + ((None,) if ctx.gather is not None else ())


def pad_cols(w3: torch.Tensor, b3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the conditioner's output projection to a multiple of 128 columns."""
    pad = _round128(w3.shape[-1]) - w3.shape[-1]
    if pad == 0:
        return w3, b3
    return F.pad(w3, (0, pad)), F.pad(b3, (0, pad))
