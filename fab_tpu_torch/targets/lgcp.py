"""Log-Gaussian Cox process target, whitened (``fab_tpu/targets/lgcp.py``).

A latent log-intensity field on an M x M grid over [0, 1]^2 with GP prior
N(mu, K), K_ij = sigma^2 exp(-||s_i - s_j|| inv_beta) (+ a nugget), and a Poisson
count per cell. The sampled variable is the whitened latent e ~ N(0, I) with field
x = mu + L e, L = chol(K):

    log p(e) = -||e||^2 / 2 - (D/2) log 2pi + sum_i [x_i y_i - exp(x_i) / M^2].

The kernel matrix, its f64 Cholesky factor and the synthetic counts are built with
the same numpy calls and seed as ``fab_tpu``, so they are the same numbers in both
packages. L^T is kept on the device once, in the target's dtype.

``in_graph_kernel=True`` follows ``fab_tpu``'s in-graph factor instead
(``_chol``): L is built from the float32 grid coordinates, cast to the latent's
dtype, with the distances, the kernel, the nugget and the Cholesky factorisation
all in that dtype. It differs from the f64 factor above by up to ~9e-7 at grid 40.
L does not depend on the latent, so it is built once per (dtype, device), on first
use, and cached, as XLA computes it once per compiled program; the f64 factor is
then not kept on the device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from fab_tpu_torch import random
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.targets.base import TargetDistribution


class LogGaussianCoxProcess(TargetDistribution):
    def __init__(
        self,
        grid_size: int = 40,
        sigma2: float = 1.91,
        inv_beta: float = 33.0,
        data_seed: int = 0,
        nugget: float = 1e-6,
        in_graph_kernel: bool = False,
        dtype=torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.in_graph_kernel = in_graph_kernel
        m = grid_size
        self.grid_size = m
        self.dim = m * m
        self.cell_area = 1.0 / (m * m)
        self.sigma2 = float(sigma2)
        self.inv_beta = float(inv_beta)
        self.nugget = float(nugget)
        self.mu = float(np.log(126.0) - sigma2 / 2.0)

        idx = np.arange(m)
        xx, yy = np.meshgrid(idx, idx, indexing="ij")
        coords = np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float64) / m
        self._coords = coords.astype(np.float32)
        self._chol_cache: Dict[Tuple[torch.dtype, torch.device], torch.Tensor] = {}
        dists = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
        k = sigma2 * np.exp(-dists * inv_beta) + self.nugget * np.eye(self.dim)
        self.chol_np = np.linalg.cholesky(k)
        as_t = lambda a: torch.tensor(a, dtype=dtype, device=self.device)
        self._chol_t = None if in_graph_kernel else as_t(np.ascontiguousarray(self.chol_np.T))

        # Deterministic synthetic counts from the generative model.
        rng = np.random.RandomState(data_seed)
        x_true = self.mu + self.chol_np @ rng.randn(self.dim)
        self.counts = as_t(rng.poisson(self.cell_area * np.exp(x_true)))
        self._x_true = as_t(x_true)

    def _chol(self, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        """The in-graph chol(K) from the float32 coordinates, computed in ``dtype``
        on ``device`` on first use and cached (``fab_tpu/targets/lgcp.py:95-103``)."""
        key = (dtype, device)
        if key not in self._chol_cache:
            c = torch.as_tensor(self._coords, dtype=dtype, device=device)
            d = torch.linalg.vector_norm(c[:, None, :] - c[None, :, :], dim=-1)
            k = self.sigma2 * torch.exp(-d * self.inv_beta) + self.nugget * torch.eye(
                self.dim, dtype=dtype, device=device)
            self._chol_cache[key] = torch.linalg.cholesky(k)
        return self._chol_cache[key]

    def latent_to_field(self, e: torch.Tensor) -> torch.Tensor:
        """Whitened latent e -> log-intensity field x = mu + L e."""
        if self.in_graph_kernel:
            return self.mu + e @ self._chol(e.dtype, e.device).T
        return self.mu + e @ self._chol_t.to(e.dtype)

    def log_prob(self, e: torch.Tensor) -> torch.Tensor:
        """Unnormalised posterior log-density over the whitened latent."""
        log_prior = -0.5 * (e**2).sum(-1) - 0.5 * self.dim * math.log(2 * math.pi)
        x = self.latent_to_field(e)
        # f32 overflow guard (lgcp.py:117-134): past x = 80 the exp term continues
        # linearly, keeping a large restoring gradient, and the linear overshoot is
        # capped at 1e3 so the term stays finite in f32 for any x.
        exp_term = torch.where(
            x > 80.0,
            math.exp(80.0) * (1.0 + torch.clamp(x - 80.0, max=1e3)),
            torch.exp(torch.clamp(x, max=80.0)),
        )
        log_lik = (x * self.counts - self.cell_area * exp_term).sum(-1)
        return log_prior + log_lik

    def sample_prior(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """The prior over the whitened latent is exactly N(0, I)."""
        return random.normal(generator, (n, self.dim), self.dtype, self.device)

    def performance_metrics(
        self,
        samples: torch.Tensor,
        log_w: torch.Tensor,
        log_q_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        batch_size: Optional[int] = None,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Importance-weighted posterior mean of the FIELD against the known
        generating field; with ``log_q_fn``, also the mean log q of the samples.
        Draws nothing (``batch_size`` and ``generator`` are the metrics interface's)."""
        del batch_size, generator
        if mask is None:
            mask = torch.ones(log_w.shape, dtype=torch.bool, device=log_w.device)
        w_bar = torch.softmax(torch.where(mask, log_w, -math.inf), dim=0)
        x = self.latent_to_field(samples)
        post_mean = (w_bar[:, None] * torch.where(mask[:, None], x, 0.0)).sum(0)
        info = {
            "post_mean_field_rmse": torch.sqrt(((post_mean - self._x_true) ** 2).mean()),
            "post_mean_log_intensity": post_mean.mean(),
        }
        if log_q_fn is not None:
            info["sample_mean_log_q"] = torch.where(mask, log_q_fn(samples), 0.0).mean()
        return info
