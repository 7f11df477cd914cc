"""K1: the fused RealNVP chain (forward or inverse) with its log-det.

Replaces the Pallas TPU kernel ``fab_tpu/ops/realnvp_kernel.py:fused_realnvp_pass``
(``pallas_call`` at line 134, body ``_kernel``). The CUDA source is
``csrc/realnvp_kernel.cu``; its header says what bounds the kernel on an H100 (the
f32 FMA rate: ~4.9 GFLOP per pass at B=2048, D=32, H=320, L=10, against ~5 MB of
memory traffic) and how the design keeps activations in shared memory and weights
in L2.

``fused_realnvp_pass`` launches the kernel for CUDA tensors and takes the plain
PyTorch version, ``fused_realnvp_pass_reference``, only for CPU tensors. The kernel
computes in f32 and casts back, as the TPU kernel does; the plain version computes
in the input dtype. ``fused_realnvp_pass.launches`` counts kernel launches.

The library is built with ``nvcc`` at first use into ``_build/`` (gitignored, see
``build.py``) and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Tuple

import torch

from fab_tpu_torch.ops import build as build_lib

SRC = build_lib.CSRC / "realnvp_kernel.cu"


def build() -> pathlib.Path:
    """Compile the kernel library (if its source changed) and return its path."""
    return build_lib.build(SRC)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_realnvp_pass_f32.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
    lib.fused_realnvp_pass_f32.restype = i32
    lib.realnvp_error_string.argtypes = [i32]
    lib.realnvp_error_string.restype = ctypes.c_char_p
    return lib


def fused_realnvp_pass_reference(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    w3: torch.Tensor,
    b3: torch.Tensor,
    wlin: torch.Tensor,
    lu_ld: torch.Tensor,
    inverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (``fab_tpu/flows/fused.py:_reference_pass``)."""
    L, d_cond, _ = w1.shape
    d_trans = x.shape[-1] - d_cond
    z = x
    ld = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def coupling(z, l, ld):
        zc, zt = z[:, :d_cond], z[:, d_cond:]
        h = torch.relu(zc @ w1[l] + b1[l])
        h = torch.relu(h @ w2[l] + b2[l])
        o = h @ w3[l] + b3[l]
        shift, log_scale = o[:, :d_trans], o[:, d_trans:]
        if inverse:
            zt = (zt - shift) * torch.exp(-log_scale)
            ld = ld - log_scale.sum(-1)
        else:
            zt = zt * torch.exp(log_scale) + shift
            ld = ld + log_scale.sum(-1)
        return torch.cat([zc, zt], -1), ld

    if inverse:
        for l in range(L - 1, -1, -1):
            z = z @ wlin[l].T
            ld = ld - lu_ld[l, 0]
            z, ld = coupling(z, l, ld)
    else:
        for l in range(L):
            z, ld = coupling(z, l, ld)
            z = z @ wlin[l].T
            ld = ld + lu_ld[l, 0]
    return z, ld


def _threads_for(hidden: int, n_last: int) -> int:
    want = max(hidden, n_last, 32)
    return min(1024, (want + 31) // 32 * 32)


def fused_realnvp_pass(
    x: torch.Tensor,
    w1: torch.Tensor,  # [L, d_cond, H]
    b1: torch.Tensor,  # [L, H]
    w2: torch.Tensor,  # [L, H, H]
    b2: torch.Tensor,  # [L, H]
    w3: torch.Tensor,  # [L, H, 2*d_trans]
    b3: torch.Tensor,  # [L, 2*d_trans]
    wlin: torch.Tensor,  # [L, D, D]: W forward, W^-1 inverse
    lu_ld: torch.Tensor,  # [L, 1]: per-layer LU log-det
    inverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass through the whole chain. Returns (y [B, D], log_det [B])."""
    if x.device.type == "cpu":
        return fused_realnvp_pass_reference(
            x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, inverse
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_realnvp_pass: unsupported device {x.device}")
    operands = (x, w1, b1, w2, b2, w3, b3, wlin, lu_ld)
    if any(t.device != x.device for t in operands):
        raise ValueError("fused_realnvp_pass: all operands must be on one device")
    if any(not t.is_floating_point() for t in operands):
        raise TypeError("fused_realnvp_pass: operands must be floating point")
    if x.dim() != 2:
        raise ValueError(f"fused_realnvp_pass: x must be [B, D], got {tuple(x.shape)}")
    B, D = x.shape
    L, d_cond, H = w1.shape
    n_last = 2 * (D - d_cond)
    expected = {
        "b1": (L, H), "w2": (L, H, H), "b2": (L, H), "w3": (L, H, n_last),
        "b3": (L, n_last), "wlin": (L, D, D), "lu_ld": (L, 1),
    }
    given = {"b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3, "wlin": wlin,
             "lu_ld": lu_ld}
    for name, shape in expected.items():
        if tuple(given[name].shape) != shape:
            raise ValueError(
                f"fused_realnvp_pass: {name} has shape {tuple(given[name].shape)}, "
                f"expected {shape}"
            )
    if not 0 < d_cond < D:
        raise ValueError(f"fused_realnvp_pass: d_cond={d_cond} must lie in (0, {D})")
    if B == 0:
        return torch.empty_like(x), x.new_empty((0,))
    # The kernel computes in f32 and casts back (realnvp_kernel.py:115,147).
    f32 = [t.to(torch.float32).contiguous() for t in operands]
    y = torch.empty((B, D), dtype=torch.float32, device=x.device)
    ld = torch.empty((B,), dtype=torch.float32, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_realnvp_pass_f32(
            *(t.data_ptr() for t in f32),
            y.data_ptr(),
            ld.data_ptr(),
            B, D, d_cond, H, L, int(inverse), _threads_for(H, n_last),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            "fused_realnvp_pass launch failed: "
            + lib.realnvp_error_string(err).decode()
        )
    fused_realnvp_pass.launches += 1
    return y.to(x.dtype), ld.to(x.dtype)


fused_realnvp_pass.launches = 0
