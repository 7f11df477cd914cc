"""2-D double-well energy (``fab_tpu/targets/double_well.py``).

E(x) = a*x1 + b*x1^2 + c*x1^4 + 0.5*x2^2. For the canonical (a, b, c) = (-0.5, -6,
1), dimension 1 is sampled exactly by rejection under a two-component Gaussian-mixture
envelope (k = 3 Z, Z = 11784.50927), dimension 2 is standard normal.
"""
from __future__ import annotations

import math

import torch

from fab_tpu_torch import random
from fab_tpu_torch.sampling.rejection import rejection_sampling
from fab_tpu_torch.targets.base import TargetDistribution

# Normalising constant of exp(-E) along dim 1 for (a, b, c) = (-0.5, -6, 1).
DW_Z_DIM1 = 11784.50927


class DoubleWellEnergy(TargetDistribution):
    def __init__(self, a: float = -0.5, b: float = -6.0, c: float = 1.0):
        self.dim = 2
        self._a = a
        self._b = b
        self._c = c
        self._canonical = a == -0.5 and b == -6.0 and c == 1.0

    def energy_dim_1(self, x1: torch.Tensor) -> torch.Tensor:
        return self._a * x1 + self._b * x1**2 + self._c * x1**4

    def energy_dim_2(self, x2: torch.Tensor) -> torch.Tensor:
        return 0.5 * x2**2

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        return self.energy_dim_1(x[..., 0]) + self.energy_dim_2(x[..., 1])

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return -self.energy(x)

    @property
    def log_z_2d(self) -> float:
        """Analytic log Z of the canonical double well."""
        assert self._canonical
        return float(math.log(DW_Z_DIM1) + 0.5 * math.log(2 * math.pi))

    def _proposal_log_prob(self, x1: torch.Tensor) -> torch.Tensor:
        """The envelope's mixture: 0.2 N(-1.7, 0.5^2) + 0.8 N(1.7, 0.5^2)."""
        log_comp = torch.stack(
            [
                math.log(0.2) - 0.5 * ((x1 + 1.7) / 0.5) ** 2,
                math.log(0.8) - 0.5 * ((x1 - 1.7) / 0.5) ** 2,
            ],
            -1,
        ) - (0.5 * math.log(2 * math.pi) + math.log(0.5))
        return torch.logsumexp(log_comp, -1)

    def _proposal_sample(self, generator: torch.Generator, n: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
        comp = random.bernoulli(generator, 0.8, (n,), dtype, device)  # True: mean +1.7
        centre = torch.full((), 1.7, dtype=dtype, device=comp.device)  # 1.7 in dtype
        mean = torch.where(comp, centre, -centre)
        return mean + 0.5 * random.normal(generator, (n,), dtype, device)

    def sample_first_dimension(self, generator: torch.Generator, n: int,
                               dtype=torch.float32, device=None) -> torch.Tensor:
        assert self._canonical

        def target_log_prob(x):  # -E along dimension 1, canonical constants
            return -(x**4) + 6 * x**2 + 0.5 * x

        return rejection_sampling(
            generator, n,
            lambda gen, m: self._proposal_sample(gen, m, dtype, device),
            self._proposal_log_prob, target_log_prob, k=DW_Z_DIM1 * 3,
        )

    def sample(self, generator: torch.Generator, n: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
        """n exact draws [n, 2] on ``device`` (the generator's device by default)."""
        device = generator.device if device is None else device
        x1 = self.sample_first_dimension(generator, n, dtype, device)
        x2 = random.normal(generator, (n,), dtype, device)
        return torch.stack([x1, x2], -1)
