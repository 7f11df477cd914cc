"""Many-Well target: D/2 independent 2-D double wells (``fab_tpu/targets/many_well.py``).

Analytic log Z = (D/2) * log Z_2D; the mode test set is the 2^(D/2) grid of well
centres at +-1.7 for D < 40. Exact sampling and ``performance_metrics`` (evaluation)
are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.targets.base import TargetDistribution
from fab_tpu_torch.targets.double_well import DoubleWellEnergy


class ManyWellEnergy(TargetDistribution):
    MAX_DIM_FOR_ALL_MODES = 40

    def __init__(
        self,
        dim: int = 32,
        a: float = -0.5,
        b: float = -6.0,
        c: float = 1.0,
        normalised: bool = False,
        device="cuda",
    ):
        assert dim % 2 == 0
        self.device = resolve_device(device)
        self.dim = dim
        self.n_wells = dim // 2
        self.double_well = DoubleWellEnergy(a, b, c)
        self.centre = 1.7
        self.normalised = normalised
        if dim < self.MAX_DIM_FOR_ALL_MODES:
            # All 2^(D/2) sign combinations of the well centres on even dims, in
            # fab_tpu's order.
            signs = np.array(
                np.meshgrid(*[[-self.centre, self.centre]] * self.n_wells)
            ).T.reshape(-1, self.n_wells)
            test_set = np.zeros((signs.shape[0], dim))
            test_set[:, 0::2] = signs
            self._test_set_modes = torch.tensor(
                test_set, dtype=torch.float32, device=self.device
            )
        else:
            self._test_set_modes = None

    @property
    def log_z(self) -> float:
        return self.double_well.log_z_2d * self.n_wells

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        pairs = x.reshape(x.shape[:-1] + (self.n_wells, 2))
        log_prob = -self.double_well.energy(pairs).sum(-1)
        if self.normalised:
            return log_prob - self.log_z
        return log_prob

    def modes_test_set(self) -> torch.Tensor:
        """Points placed at each mode (the full grid, for D < 40)."""
        if self._test_set_modes is None:
            raise NotImplementedError(
                "random mode test sets (D >= 40) are not ported yet"
            )
        return self._test_set_modes
