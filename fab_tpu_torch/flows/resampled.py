"""Resampled (LARS) Gaussian base distribution (``fab_tpu/flows/resampled.py``).

A standard normal proposal phi(z) reshaped by a learned acceptance network a(z) in
(0, 1) with T-truncated rejection sampling:

    p(z) = phi(z) * [ a(z) * (1 - (1-Z)^(T-1)) / Z + (1-Z)^(T-1) ]

where Z = E_phi[a(z)] is estimated on a fixed set of proposal points drawn at
initialisation (``z_points``, a buffer: its gradient would be 0 anyway, since Z is
detached as in ``fab_tpu``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from fab_tpu_torch import random
from fab_tpu_torch.flows.mlp import Dense, mlp_apply, mlp_init
from fab_tpu_torch.parallel.mesh import constrain_batch


class ResampledGaussianBase(nn.Module):
    """Base distribution for ``Flow`` (``reset_parameters``, ``sample_and_log_prob``,
    ``log_prob``). Its parameters come from its own ``z_seed`` generator, not from
    the flow's, as ``fab_tpu``'s base initialises from ``key(z_seed)``."""

    def __init__(
        self,
        dim: int,
        hidden_units: int = 256,
        n_hidden_layers: int = 2,
        T: int = 100,
        n_z_points: int = 1024,
        z_seed: int = 0,
        init_mode: str = "he_normal",
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.dim = dim
        self.T = T
        self.z_seed = z_seed
        self.init_mode = init_mode
        self.sizes = [dim] + [hidden_units] * n_hidden_layers + [1]
        self.accept_net = nn.ModuleList(
            Dense(i, o, dtype, device) for i, o in zip(self.sizes[:-1], self.sizes[1:])
        )
        self.register_buffer(
            "z_points", torch.zeros((n_z_points, dim), dtype=dtype, device=device)
        )
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The acceptance net (last layer zero, so a(z) = 1/2 and p = phi at init)
        and the proposal points, from a seed-``z_seed`` generator."""
        ref = self.z_points
        generator = torch.Generator(device=ref.device).manual_seed(self.z_seed)
        values = mlp_init(self.sizes, generator, zero_init_last=True, dtype=ref.dtype,
                          device=ref.device, init_mode=self.init_mode)
        with torch.no_grad():
            for layer, (w, b) in zip(self.accept_net, values):
                layer.w.copy_(w)
                layer.b.copy_(b)
            self.z_points.normal_(generator=generator)

    def accept_prob(self, z: torch.Tensor) -> torch.Tensor:
        """a(z) = sigmoid of the acceptance net's output."""
        return torch.sigmoid(mlp_apply(self.accept_net, z)[..., 0])

    def z_estimate(self) -> torch.Tensor:
        """Z = mean of a over the fixed proposal points, detached."""
        with torch.no_grad():
            return self.accept_prob(self.z_points).mean()

    def _log_phi(self, z: torch.Tensor) -> torch.Tensor:
        return -0.5 * (z**2).sum(-1) - 0.5 * self.dim * math.log(2 * math.pi)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        a = self.accept_prob(z)
        big_z = self.z_estimate()
        tail = (1 - big_z) ** (self.T - 1)
        density_ratio = a * (1 - tail) / big_z + tail
        return self._log_phi(z) + torch.log(density_ratio + 1e-12)

    def sample_and_log_prob(
        self, n: int, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """T-truncated rejection sampling over the whole batch: an initial proposal
        z0, then T-1 rounds of (proposal, uniform); a row takes the first proposal
        it accepts and keeps z0 if it accepts none. Every round runs (no early exit:
        it would need a host read), and the draw is detached. Under a data mesh every
        draw is made for the global batch ``n`` and cut to this rank's rows."""
        ref = self.z_points
        with torch.no_grad():
            z = constrain_batch(random.normal(generator, (n, self.dim), ref.dtype, ref.device))
            accepted = torch.zeros((z.shape[0],), dtype=torch.bool, device=ref.device)
            for _ in range(self.T - 1):
                z_prop = constrain_batch(
                    random.normal(generator, (n, self.dim), ref.dtype, ref.device))
                a = self.accept_prob(z_prop)
                u = constrain_batch(random.uniform(generator, (n,), a.dtype, a.device))
                take = ~accepted & (u < a)
                z = torch.where(take[:, None], z_prop, z)
                accepted = accepted | take
        return z, self.log_prob(z)
