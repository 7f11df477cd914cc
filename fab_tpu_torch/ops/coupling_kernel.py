"""K2: one affine-coupling layer at large event dim, fused.

Replaces the Pallas TPU kernel ``fab_tpu/ops/coupling_kernel.py:fused_coupling_apply``
(launcher ``_coupling_pallas``, ``pallas_call`` at line 167). The CUDA source is
``csrc/coupling_kernel.cu``; its header says what bounds the kernel on an H100 (the
f32 FMA rate: 18.4 GFLOP per call at the LGCP-1600 shapes B=512, D=1600, H=3200,
against ~77 MB of memory traffic), why the TPU's VMEM-resident activations do not
fit a block's shared memory, and the three-GEMM design used instead.

- ``fused_coupling_apply`` launches the kernel for CUDA tensors (f32 only) and
  takes the plain PyTorch version, ``fused_coupling_apply_reference``, only for CPU
  tensors. ``fused_coupling_apply.launches`` counts calls that launched the kernel
  (one per coupling layer, although the kernel runs as four device launches).
- ``FusedCoupling`` is the autograd Function: kernel forward, backward by
  recomputing the plain version under autograd, as ``_bwd`` does in JAX (there is
  no backward kernel on the TPU either). ``FusedCoupling.recomputes`` counts them.
- ``pad_cols`` pads the conditioner's last layer to a multiple of 128 columns;
  only the first 2 * d_trans columns are ever read, so the pad gets zero gradient.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Tuple

import torch
import torch.nn.functional as F

from fab_tpu_torch.ops import build as build_lib

SRC = build_lib.CSRC / "coupling_kernel.cu"


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def build() -> pathlib.Path:
    """Compile the kernel library (if its source changed) and return its path."""
    return build_lib.build(SRC)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_coupling_apply_f32.argtypes = (
        [ptr] * 13 + [i32] * 5 + [ctypes.c_float, i32, ptr]
    )
    lib.fused_coupling_apply_f32.restype = i32
    lib.coupling_partial_tiles.argtypes = [i32]
    lib.coupling_partial_tiles.restype = i32
    lib.coupling_error_string.argtypes = [i32]
    lib.coupling_error_string.restype = ctypes.c_char_p
    return lib


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
    shift, log_scale = out[..., :d_trans], out[..., d_trans:]
    if scale_cap > 0.0:
        log_scale = scale_cap * torch.tanh(log_scale / scale_cap)
    if inverse:
        return (z_trans - shift) * torch.exp(-log_scale), -log_scale.sum(-1)
    return z_trans * torch.exp(log_scale) + shift, log_scale.sum(-1)


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
    if B == 0:
        return torch.empty_like(z_trans), z_trans.new_empty((0,))
    lib = _library()
    empty = functools.partial(torch.empty, dtype=torch.float32, device=z_cond.device)
    y, log_det = empty((B, d_trans)), empty((B,))
    h1, h2 = empty((B, H)), empty((B, H))
    partial = empty((B, lib.coupling_partial_tiles(d_trans)))
    stream = torch.cuda.current_stream(z_cond.device).cuda_stream
    with torch.cuda.device(z_cond.device):
        err = lib.fused_coupling_apply_f32(
            *(t.data_ptr() for t in operands.values()),
            y.data_ptr(), log_det.data_ptr(), h1.data_ptr(), h2.data_ptr(),
            partial.data_ptr(),
            B, d_cond, d_trans, H, P, float(scale_cap), int(inverse), stream,
        )
    if err != 0:
        raise RuntimeError(
            "fused_coupling_apply launch failed: " + lib.coupling_error_string(err).decode()
        )
    fused_coupling_apply.launches += 1
    return y, log_det


fused_coupling_apply.launches = 0


class FusedCoupling(torch.autograd.Function):
    """K2 forward; backward by recomputing the plain version under autograd."""

    recomputes = 0

    @staticmethod
    def forward(ctx, scale_cap, inverse, z_cond, z_trans, w1, b1, w2, b2, w3p, b3p):
        ctx.scale_cap, ctx.inverse = scale_cap, inverse
        ctx.save_for_backward(z_cond, z_trans, w1, b1, w2, b2, w3p, b3p)
        return fused_coupling_apply(
            z_cond, z_trans, w1, b1, w2, b2, w3p, b3p, scale_cap, inverse
        )

    @staticmethod
    def backward(ctx, grad_y, grad_ld):
        FusedCoupling.recomputes += 1
        needs = ctx.needs_input_grad[2:]
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
        return (None, None, *(next(grads) if need else None for need in needs))


def pad_cols(w3: torch.Tensor, b3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the conditioner's output projection to a multiple of 128 columns."""
    pad = _round128(w3.shape[-1]) - w3.shape[-1]
    if pad == 0:
        return w3, b3
    return F.pad(w3, (0, pad)), F.pad(b3, (0, pad))
