"""Invertible LU-parametrised linear bijector and ActNorm (``fab_tpu/flows/linear.py``).

W = L (U + diag(sign * exp(log_s))) with L unit-lower-triangular, initialised from
the LU factors of a random rotation. ``sign_s`` is a fixed +-1 pattern (a buffer,
never trained). The inverse materialises W^-1 = U^-1 L^-1 with two D x D triangular
solves, then applies it as one matmul (``linear.py:75-86``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg
import torch
from torch import nn

from fab_tpu_torch.flows.base import Bijector


def lu_pieces(lu: "LULinear") -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, U) with unit diagonal on L and sign * exp(log_s) on U's diagonal."""
    eye = torch.eye(lu.dim, dtype=lu.lower.dtype, device=lu.lower.device)
    l_mat = torch.tril(lu.lower, diagonal=-1) + eye
    u_mat = torch.triu(lu.upper, diagonal=1) + torch.diag(
        lu.sign_s * torch.exp(lu.log_s)
    )
    return l_mat, u_mat


def lu_weight(lu: "LULinear", inverse: bool) -> torch.Tensor:
    """W (forward) or W^-1 via two triangular solves (inverse)."""
    l_mat, u_mat = lu_pieces(lu)
    if not inverse:
        return l_mat @ u_mat
    eye = torch.eye(lu.dim, dtype=l_mat.dtype, device=l_mat.device)
    l_inv = torch.linalg.solve_triangular(l_mat, eye, upper=False)
    return torch.linalg.solve_triangular(u_mat, l_inv, upper=True)


class LULinear(Bijector):
    """y = x @ W^T with W = L (U + diag(s))."""

    def __init__(self, dim: int, identity_init: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim = dim
        self.identity_init = identity_init
        zeros = lambda: torch.zeros((dim, dim), dtype=dtype, device=device)
        self.lower = nn.Parameter(zeros())
        self.upper = nn.Parameter(zeros())
        self.log_s = nn.Parameter(torch.zeros((dim,), dtype=dtype, device=device))
        self.register_buffer("sign_s", torch.ones((dim,), dtype=dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.identity_init:
            l0 = np.eye(self.dim)
            u0 = np.eye(self.dim)
        else:
            # Random rotation via QR, seeded from the generator; w0 = P L U, and
            # W = L U = P^T w0 is still orthogonal.
            seed = int(
                torch.randint(
                    0, 2**31 - 1, (1,), generator=generator, device=generator.device
                ).item()
            )
            rng = np.random.RandomState(seed)
            w0, _ = np.linalg.qr(rng.randn(self.dim, self.dim))
            _, l0, u0 = scipy.linalg.lu(w0)
        s = np.diag(u0).copy()
        as_t = lambda a: torch.as_tensor(a, dtype=self.lower.dtype, device=self.lower.device)
        with torch.no_grad():
            self.lower.copy_(as_t(np.tril(l0, k=-1)))
            self.upper.copy_(as_t(np.triu(u0, k=1)))
            self.log_s.copy_(as_t(np.log(np.abs(s))))
            self.sign_s.copy_(as_t(np.sign(s)))

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = z @ lu_weight(self, inverse=False).T
        return y, self.log_s.sum().expand(z.shape[:-1])

    def inverse_and_log_det(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = x @ lu_weight(self, inverse=True).T
        return z, (-self.log_s.sum()).expand(x.shape[:-1])


class ActNorm(Bijector):
    """Per-dimension affine y = x * exp(log_scale) + shift, zero at reset;
    ``flows/factory.py:data_dependent_init`` standardises its outputs on a warm-up
    batch."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.shift = nn.Parameter(torch.zeros((dim,), dtype=dtype, device=device))
        self.log_scale = nn.Parameter(torch.zeros((dim,), dtype=dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.shift.zero_()
            self.log_scale.zero_()

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = z * torch.exp(self.log_scale) + self.shift
        return y, self.log_scale.sum().expand(z.shape[:-1])

    def inverse_and_log_det(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = (x - self.shift) * torch.exp(-self.log_scale)
        return z, (-self.log_scale.sum()).expand(x.shape[:-1])
