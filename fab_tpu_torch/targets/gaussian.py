"""A diagonal Gaussian test target (``fab_tpu/targets/gaussian.py``)."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from fab_tpu_torch import random
from fab_tpu_torch.targets.base import TargetDistribution
from fab_tpu_torch.utils.numerical import (
    effective_sample_size_over_p,
    importance_weighted_expectation,
    quadratic_function,
)


class Gaussian(TargetDistribution):
    """N(loc, diag(scale^2)) on the device and in the dtype of ``loc``."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, n_test_set_samples: int = 1000):
        self.loc = torch.as_tensor(loc)
        self.scale = torch.as_tensor(scale, dtype=self.loc.dtype, device=self.loc.device)
        self.dim = self.loc.shape[-1]
        self.n_test_set_samples = n_test_set_samples

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        eps = (x - self.loc) / self.scale
        return (
            -0.5 * (eps**2).sum(-1)
            - torch.log(self.scale).sum()
            - 0.5 * self.dim * math.log(2 * math.pi)
        )

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        eps = random.normal(generator, (n, self.dim), self.loc.dtype, self.loc.device)
        return self.loc + eps * self.scale

    def performance_metrics(
        self,
        samples: torch.Tensor,
        log_w: torch.Tensor,
        log_q_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        batch_size: Optional[int] = None,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The importance-weighted quadratic expectation and, with ``log_q_fn`` and a
        generator, the test set's mean log q, forward KL and ESS over p."""
        del batch_size
        info = {"quadratic_expectation": importance_weighted_expectation(
            quadratic_function, samples, log_w, mask)}
        if log_q_fn is not None and generator is not None:
            test_x = self.sample(generator, self.n_test_set_samples)
            log_q_test = log_q_fn(test_x)
            log_p_test = self.log_prob(test_x)
            info.update(
                test_set_mean_log_prob=log_q_test.mean(),
                kl_forward=(log_p_test - log_q_test).mean(),
                ess_over_p=effective_sample_size_over_p(log_p_test - log_q_test),
            )
        return info
