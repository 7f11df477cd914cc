"""Masked affine autoregressive flow (MAF) and a fixed permutation
(``fab_tpu/flows/autoregressive.py``).

The conditioner is a MADE-masked MLP. The density direction (data -> base) is one
parallel pass; the sampling direction solves one dimension after another.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows.base import Bijector, DiagGaussianBase, Flow
from fab_tpu_torch.flows.mlp import Dense, mlp_init, shard_mlp


def made_masks(dim: int, hidden: List[int], mask_seed: int) -> List[np.ndarray]:
    """MADE degree masks [d_in, d_out] for an MLP [dim, *hidden, 2*dim]: hidden
    degrees from ``RandomState(mask_seed)``; output i (shift and log-scale) sees
    inputs < i only."""
    rng = np.random.RandomState(mask_seed)
    degrees = [np.arange(1, dim + 1)]
    for h in hidden:
        degrees.append(rng.randint(1, dim, size=h) if dim > 1 else np.ones(h, int))
    masks = [(d_out[:, None] >= d_in[None, :]).T.astype(np.float32)
             for d_in, d_out in zip(degrees[:-1], degrees[1:])]
    out_deg = np.tile(np.arange(1, dim + 1), 2)
    masks.append((out_deg[:, None] > degrees[-1][None, :]).T.astype(np.float32))
    return masks


class MaskedAffineAutoregressive(Bijector):
    """z_i = (x_i - shift_i(x_<i)) * exp(-log_scale_i(x_<i)) in the density
    direction; log_scale is bounded by ``scale_cap * tanh(. / scale_cap)``."""

    def __init__(
        self,
        dim: int,
        hidden_units: int = 64,
        n_hidden_layers: int = 2,
        mask_seed: int = 0,
        scale_cap: float = 3.0,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.dim = dim
        self.scale_cap = scale_cap
        self.sizes = [dim] + [hidden_units] * n_hidden_layers + [2 * dim]
        self.mlp = nn.ModuleList(
            Dense(i, o, dtype, device) for i, o in zip(self.sizes[:-1], self.sizes[1:])
        )
        for j, mask in enumerate(made_masks(dim, self.sizes[1:-1], mask_seed)):
            self.register_buffer(f"mask{j}", torch.tensor(mask, dtype=dtype, device=device),
                                 persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal weights, zero biases, a zero last layer."""
        ref = self.mlp[0].w
        values = mlp_init(self.sizes, generator, zero_init_last=True, dtype=ref.dtype,
                          device=ref.device)
        for layer, (w, b) in zip(self.mlp, values):
            layer.assign(w, b)

    def shard_model_axis(self, mesh, name: str = "MADE") -> None:
        """``fab_tpu/flows/autoregressive.py:103-107``: the MLP's column / row split;
        each mask is cut as its weight is (a column layer's by columns, a row layer's
        by rows)."""
        if self.mlp[0].split is not None:
            return
        shard_mlp(self.mlp, self.sizes, mesh, name)
        for j, layer in enumerate(self.mlp):
            mask = getattr(self, f"mask{j}")
            self.register_buffer(f"mask{j}", layer._cut("w", mask).clone(), persistent=False)

    def _conditioner(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for j, layer in enumerate(self.mlp):
            h = layer.affine(h, getattr(self, f"mask{j}"))
            if j < len(self.mlp) - 1:
                h = torch.relu(h)
        shift, log_scale = h[..., : self.dim], h[..., self.dim :]
        if self.scale_cap > 0:
            log_scale = self.scale_cap * torch.tanh(log_scale / self.scale_cap)
        return shift, log_scale

    def inverse_and_log_det(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        shift, log_scale = self._conditioner(x)
        return (x - shift) * torch.exp(-log_scale), -log_scale.sum(-1)

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x_i = z_i * exp(s_i(x_<i)) + t_i(x_<i), one dimension per conditioner
        pass; the columns not yet solved are zero, as in ``fab_tpu``'s scan. The
        solved columns are gathered in a list, so autograd sees no in-place write."""
        cols, log_scales = [], []
        for i in range(self.dim):
            x = torch.stack(cols + [torch.zeros_like(z[..., 0])] * (self.dim - i), -1)
            shift, log_scale = self._conditioner(x)
            cols.append(z[..., i] * torch.exp(log_scale[..., i]) + shift[..., i])
            log_scales.append(log_scale[..., i])
        return torch.stack(cols, -1), torch.stack(log_scales).sum(0)


class Permutation(Bijector):
    """A fixed permutation of the dims, ``RandomState(seed).permutation(dim)``."""

    def __init__(self, dim: int, seed: int = 0, device=None):
        super().__init__()
        perm = np.random.RandomState(seed).permutation(dim)
        self.register_buffer("perm", torch.tensor(perm, device=device), persistent=False)
        self.register_buffer("inv", torch.tensor(np.argsort(perm), device=device),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass

    def forward_and_log_det(self, z: torch.Tensor):
        return z[..., self.perm], z.new_zeros(z.shape[:-1])

    def inverse_and_log_det(self, x: torch.Tensor):
        return x[..., self.inv], x.new_zeros(x.shape[:-1])


def make_masked_affine_maf(
    dim: int,
    n_layers: int = 5,
    hidden_units: int = 64,
    generator: torch.Generator = None,
    dtype=torch.float32,
    device="cuda",
) -> Flow:
    """n_layers x [MaskedAffineAutoregressive (mask seed i), Permutation (seed
    1000 + i)] over a diagonal Gaussian. Parameters come from ``generator`` (a
    seed-0 generator on the device if none is given)."""
    device = resolve_device(device)
    bijectors = []
    for i in range(n_layers):
        bijectors.append(MaskedAffineAutoregressive(dim, hidden_units, mask_seed=i,
                                                    dtype=dtype, device=device))
        bijectors.append(Permutation(dim, seed=1000 + i, device=device))
    flow = Flow(dim, bijectors, DiagGaussianBase(dim, dtype=dtype, device=device))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    flow.reset_parameters(generator)
    return flow
