"""Gaussian-mixture target, the GMM-40 workload (``fab_tpu/targets/gmm.py``).

The component means are the fixed-seed torch draws of ``utils/seeding.py`` scaled by
``loc_scaling`` (the same float64 numbers as ``fab_tpu``'s, cast to the target's
dtype); covariances are diagonal with scale softplus(log_var_scaling). Log-probs
below -1e4 are masked to -inf. The true expectation of the quadratic test function
is a Monte Carlo estimate from exact samples, drawn in chunks on the device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fab_tpu_torch import random
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.targets.base import TargetDistribution
from fab_tpu_torch.utils.numerical import (
    effective_sample_size_over_p,
    importance_weighted_expectation,
    mc_estimate_true_expectation,
    quadratic_function,
)
from fab_tpu_torch.utils.seeding import gmm_mean_draws


class GMM(TargetDistribution):
    def __init__(
        self,
        dim: int = 2,
        n_mixes: int = 40,
        loc_scaling: float = 40.0,
        log_var_scaling: float = 1.0,
        seed: int = 0,
        n_test_set_samples: int = 1000,
        true_expectation_estimation_n_samples: int = int(1e7),
        expectation_generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.dim = dim
        self.n_mixes = n_mixes
        self.seed = seed
        self.n_test_set_samples = n_test_set_samples
        as_t = lambda a: torch.tensor(a, dtype=dtype, device=self.device)
        self.locs = as_t(gmm_mean_draws(n_mixes, dim, seed) * loc_scaling)
        self.scales = as_t(np.log1p(np.exp(log_var_scaling)) * np.ones((n_mixes, dim)))
        if expectation_generator is None:
            expectation_generator = torch.Generator(device=self.device).manual_seed(0)
        self.true_expectation = mc_estimate_true_expectation(
            self.sample, quadratic_function, true_expectation_estimation_n_samples,
            expectation_generator,
        )

    def save_as_numpy(self, path: str) -> None:
        """Write the mixture's parameters to an ``.npz`` (locs, scales, uniform
        weights), as ``fab_tpu``'s ``GMM.save_as_numpy`` does."""
        np.savez(
            path,
            locs=self.locs.cpu().numpy(),
            scales=self.scales.cpu().numpy(),
            weights=np.full((self.n_mixes,), 1.0 / self.n_mixes),
        )

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        diff = x[..., None, :] - self.locs  # [..., K, D]
        log_comp = (
            -0.5 * ((diff / self.scales) ** 2).sum(-1)
            - torch.log(self.scales).sum(-1)
            - 0.5 * self.dim * math.log(2 * math.pi)
        )
        log_prob = torch.logsumexp(log_comp, -1) - math.log(self.n_mixes)
        return torch.where(log_prob < -1e4, -math.inf, log_prob)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        comps = random.randint(generator, 0, self.n_mixes, (n,), self.device)
        eps = random.normal(generator, (n, self.dim), self.dtype, self.device)
        return self.locs[comps] + eps * self.scales[comps]

    def test_set(self, generator: torch.Generator) -> torch.Tensor:
        return self.sample(generator, self.n_test_set_samples)

    def evaluate_expectation(self, samples, log_w, mask=None) -> torch.Tensor:
        """Relative error of the importance-weighted quadratic expectation."""
        expectation = importance_weighted_expectation(quadratic_function, samples, log_w, mask)
        return (expectation - self.true_expectation) / self.true_expectation

    def performance_metrics(
        self,
        samples: torch.Tensor,
        log_w: torch.Tensor,
        log_q_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        batch_size: Optional[int] = None,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Expectation bias with and without the weights and, with ``log_q_fn``, the
        test set's mean log q, forward KL and ESS over p. Test rows whose log q or
        log p is not finite are left out of the means and counted
        (``test_set_n_nonfinite``); with none left, the means are NaN."""
        del batch_size
        info = {
            "bias_normed": self.evaluate_expectation(samples, log_w, mask).abs(),
            "bias_no_correction": self.evaluate_expectation(
                samples, torch.zeros_like(log_w), mask).abs(),
        }
        if log_q_fn is not None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(self.seed)
            test_x = self.test_set(generator)
            log_q_test = log_q_fn(test_x)
            log_p_test = self.log_prob(test_x)
            ok = torch.isfinite(log_q_test) & torch.isfinite(log_p_test)
            n_ok = ok.sum()
            nan = torch.tensor(math.nan, dtype=log_q_test.dtype, device=log_q_test.device)

            def mean_ok(v):
                return torch.where(n_ok == 0, nan,
                                   torch.where(ok, v, 0.0).sum() / n_ok.clamp(min=1))

            info.update(
                test_set_mean_log_prob=mean_ok(log_q_test),
                kl_forward=mean_ok(log_p_test - log_q_test),
                ess_over_p=torch.where(
                    n_ok == 0, nan,
                    effective_sample_size_over_p(
                        torch.where(ok, log_p_test - log_q_test, -math.inf))),
                test_set_n_nonfinite=(~ok).sum(),
            )
        return info
