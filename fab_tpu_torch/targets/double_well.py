"""2-D double-well energy (``fab_tpu/targets/double_well.py``).

E(x) = a*x1 + b*x1^2 + c*x1^4 + 0.5*x2^2. Exact sampling by rejection is not ported
yet.
"""
from __future__ import annotations

import math

import torch

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
