"""Affine coupling bijector with an MLP conditioner (``fab_tpu/flows/coupling.py``).

Split x = (x1[:d], x2[d:]) with d = ceil(dim/2); the MLP [d_cond, width x n_hidden,
2*d_trans] (zero-initialised last layer) gives (shift, log_scale) and
y2 = x2 * exp(log_scale) + shift. ``swap`` transforms the first block instead;
``scale_cap`` tanh-bounds log_scale.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fab_tpu_torch.flows.base import Bijector
from fab_tpu_torch.flows.mlp import Dense, mlp_apply, mlp_init, shard_mlp


class AffineCoupling(Bijector):
    """y1 = x1; y2 = x2 * exp(s(x1)) + t(x1)."""

    def __init__(
        self,
        dim: int,
        hidden_units: int,
        n_hidden_layers: int = 2,
        swap: bool = False,
        scale_cap: float = 0.0,
        init_mode: str = "he_normal",
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.dim = dim
        self.hidden_units = hidden_units
        self.n_hidden_layers = n_hidden_layers
        self.swap = swap
        self.scale_cap = scale_cap
        self.init_mode = init_mode
        d = (dim + 1) // 2
        self.d_cond, self.d_trans = (dim - d, d) if swap else (d, dim - d)
        self.sizes = [self.d_cond] + [hidden_units] * n_hidden_layers + [self._out_width()]
        self.mlp = nn.ModuleList(
            Dense(i, o, dtype, device) for i, o in zip(self.sizes[:-1], self.sizes[1:])
        )

    def _out_width(self) -> int:
        """Columns of the conditioner's last layer: (shift, log_scale)."""
        return 2 * self.d_trans

    def reset_parameters(self, generator: torch.Generator) -> None:
        ref = self.mlp[0].w
        values = mlp_init(
            self.sizes, generator, zero_init_last=True, dtype=ref.dtype,
            device=ref.device, init_mode=self.init_mode,
        )
        for layer, (w, b) in zip(self.mlp, values):
            layer.assign(w, b)

    def shard_model_axis(self, mesh, name: str = "coupling") -> None:
        """``fab_tpu/flows/coupling.py:92-97``: the MLP's column / row split."""
        shard_mlp(self.mlp, self.sizes, mesh, name)

    def _split(self, x: torch.Tensor):
        d = (self.dim + 1) // 2
        if self.swap:
            return x[..., d:], x[..., :d]
        return x[..., :d], x[..., d:]

    def _merge(self, x_cond: torch.Tensor, y_trans: torch.Tensor) -> torch.Tensor:
        if self.swap:
            return torch.cat([y_trans, x_cond], -1)
        return torch.cat([x_cond, y_trans], -1)

    def _shift_and_log_scale(self, x_cond: torch.Tensor):
        h = mlp_apply(self.mlp, x_cond)
        shift, log_scale = h[..., : self.d_trans], h[..., self.d_trans : 2 * self.d_trans]
        if self.scale_cap > 0.0:
            log_scale = self.scale_cap * torch.tanh(log_scale / self.scale_cap)
        return shift, log_scale

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z_cond, z_trans = self._split(z)
        shift, log_scale = self._shift_and_log_scale(z_cond)
        y_trans = z_trans * torch.exp(log_scale) + shift
        return self._merge(z_cond, y_trans), log_scale.sum(-1)

    def inverse_and_log_det(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x_cond, x_trans = self._split(x)
        shift, log_scale = self._shift_and_log_scale(x_cond)
        z_trans = (x_trans - shift) * torch.exp(-log_scale)
        return self._merge(x_cond, z_trans), -log_scale.sum(-1)
