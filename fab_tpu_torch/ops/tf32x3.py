"""The 3xTF32 arithmetic that K1 and K2 run on the tensor cores, in plain PyTorch.

Each f32 operand is split into two TF32 numbers, hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna.tf32.f32``), and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi, the small
terms first; the dropped a_lo b_lo is ~2^-22 relative. The kernels' CPU twins use
these functions to repeat that arithmetic; the main path never calls them.
"""
from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32: 10 explicit mantissa bits, rounded to
    nearest with ties away from zero, the low 13 bits cleared; inf and nan pass."""
    bits = x.view(torch.int32)
    sign = bits & torch.iinfo(torch.int32).min
    rounded = (((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF) | sign
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def split_tf32(x: torch.Tensor) -> torch.Tensor:
    """Planes [2, ...]: hi = tf32(x), lo = tf32(x - hi); hi + lo = x to ~2^-22."""
    hi = tf32_round(x)
    return torch.stack((hi, tf32_round(x - hi)))


def matmul_tf32x3(a_planes: torch.Tensor, b_planes: torch.Tensor) -> torch.Tensor:
    """The kernels' product from planes a [2, M, K] and b [2, N, K]:
    a_lo b_hi^T + a_hi b_lo^T + a_hi b_hi^T, the small terms first."""
    (a_hi, a_lo), (b_hi, b_lo) = a_planes, b_planes
    return (a_lo @ b_hi.T + a_hi @ b_lo.T) + a_hi @ b_hi.T


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass, a [M, K] @ b [K, N]: what 3xTF32 improves on."""
    return tf32_round(a) @ tf32_round(b)


def matmul_tf32x3_staged(a: torch.Tensor, b: torch.Tensor, stage: int) -> torch.Tensor:
    """a [M, K] @ b [K, N] in 3xTF32 with each ``stage``-deep slice of K summed on
    its own and the slices added in order, in f32: the order K1's tensor-core
    products take (``csrc/realnvp_kernel.cu``)."""
    a_planes, b_planes = split_tf32(a), split_tf32(b.T.contiguous())
    out = None
    for k0 in range(0, a.shape[-1], stage):
        part = matmul_tf32x3(a_planes[..., k0:k0 + stage], b_planes[..., k0:k0 + stage])
        out = part if out is None else out + part
    return out


def truncating_chain(a: torch.Tensor, b: torch.Tensor, step: int, stage: int) -> torch.Tensor:
    """A model of the tensor cores' accumulation, for choosing an order of sums:
    a [M, K] @ b [K, N] in 3xTF32 where each ``step``-deep product term is added to
    its running sum rounded toward zero (as the tensor cores are found to add, see
    ``csrc/coupling_kernel.cu``), a new running sum is started every ``stage`` of
    depth (``stage >= K``: one accumulator), and the stage sums are added in f32,
    rounded to nearest. Float64 in, float32 out."""
    a_planes = split_tf32(a.float()).double()
    b_planes = split_tf32(b.float().T.contiguous()).double()
    (a_hi, a_lo), (b_hi, b_lo) = a_planes, b_planes
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for s0 in range(0, a.shape[-1], stage):
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
        for k0 in range(s0, min(s0 + stage, a.shape[-1]), step):
            sl = slice(k0, k0 + step)
            for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                acc = _round_toward_zero(acc + x[:, sl] @ y[:, sl].T)
        out = out + acc.float()
    return out


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 next to it toward zero, held as float64."""
    f = x.float()
    too_far = f.double().abs() > x.abs()
    f = torch.where(too_far, torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()
