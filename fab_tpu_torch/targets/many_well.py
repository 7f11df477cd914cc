"""Many-Well target: D/2 independent 2-D double wells (``fab_tpu/targets/many_well.py``).

Analytic log Z = (D/2) * log Z_2D; the mode test set is the 2^(D/2) grid of well
centres at +-1.7 for D < 40, else random sign draws. Exact samples are the wells'
exact samples side by side; ``performance_metrics`` reports the log Z error over 50
interleaved splits and, given the flow's log q, the test-set log q and forward KL.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fab_tpu_torch import random
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

    def log_prob_2d(self, x: torch.Tensor) -> torch.Tensor:
        """One well's 2-D density (for plots)."""
        return self.double_well.log_prob(x)

    def sample(self, generator: torch.Generator, n: int, dtype=torch.float32) -> torch.Tensor:
        """n exact draws [n, D]: each well's exact sample, well after well; one
        ``random.host_draw`` (the wells' rejection loops read the device)."""
        return random.host_draw(generator, self._sample_wells, n, dtype)

    def _sample_wells(self, generator: torch.Generator, n: int, dtype) -> torch.Tensor:
        wells = [self.double_well.sample(generator, n, dtype, self.device)
                 for _ in range(self.n_wells)]
        return torch.cat(wells, -1)

    def modes_test_set(self, generator: Optional[torch.Generator] = None,
                       n: int = 10_000) -> torch.Tensor:
        """Points placed at each mode: the full grid for D < 40, else n random sign
        draws (which need ``generator``)."""
        if self._test_set_modes is not None:
            return self._test_set_modes
        assert generator is not None
        signs = random.randint(generator, 0, 2, (n, self.n_wells), self.device) * 2 - 1
        test_set = torch.zeros((n, self.dim), device=self.device)
        test_set[:, 0::2] = signs * self.centre
        return test_set

    def performance_metrics(
        self,
        samples: torch.Tensor,
        log_w: torch.Tensor,
        log_q_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        batch_size: Optional[int] = None,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """log Z error over 50 interleaved splits of the weights (estimate i takes
        rows i, i + 50, ...; invalid rows weigh nothing) and, with ``log_q_fn``, the
        mean log q of the mode test set and of ``batch_size`` exact samples (all
        rows by default) and the forward KL on the exact samples."""
        del samples
        n_runs = 50
        if mask is not None:
            log_w = torch.where(mask, log_w, -math.inf)
        n_per_split = log_w.shape[0] // n_runs
        lw = log_w[: n_per_split * n_runs].reshape(n_per_split, n_runs).T
        log_z_estimate = torch.logsumexp(lw, -1) - math.log(n_per_split)
        relative_error = torch.exp(log_z_estimate - self.log_z) - 1
        info = {
            "relative_MSE_Z_estimate": relative_error.abs().mean(),
            "abs_MSE_log_Z_estimate": (log_z_estimate - self.log_z).abs().mean(),
        }
        if log_q_fn is not None:
            assert generator is not None
            n_exact = log_w.shape[0] if batch_size is None else batch_size
            modes = self.modes_test_set(generator).to(log_w.dtype)
            x_exact = self.sample(generator, n_exact, log_w.dtype)
            log_q_exact = log_q_fn(x_exact)
            info.update(
                test_set_modes_mean_log_prob=log_q_fn(modes).mean(),
                test_set_exact_mean_log_prob=log_q_exact.mean(),
                forward_kl=(self.log_prob(x_exact) - self.log_z - log_q_exact).mean(),
            )
        return info
