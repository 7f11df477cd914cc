"""Random-walk Metropolis transition kernel and the masked mean shared by the
transition kernels (``fab_tpu/sampling/metropolis.py``).

The per-(intermediate distribution, update) proposal scales are an explicit state,
``{"noise_scalings": [n_dists, n_updates]}``, tuned by x1.05 or /1.05 toward
``target_p_accept`` from the masked batch-mean acceptance probability, on the device
(no host sync). Proposals whose acceptance ratio is NaN or infinite are rejected.
Tuning is off when ``tune`` is False (evaluation). Under a data mesh the proposals
and acceptance draws are made at the global batch's shape and cut to this rank's
rows, and the acceptance rate is reduced over every rank, so every rank tunes alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from fab_tpu_torch import random
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.sampling.point import create_point, intermediate_log_prob
from fab_tpu_torch.typing import LogProbFn, Point, select_point


# The mean over the valid rows of the global batch (``parallel/mesh.py``).
masked_mean = mesh.masked_mean


@dataclasses.dataclass(frozen=True)
class Metropolis:
    """Static config; state = {"noise_scalings": [n_dists, n_updates]}."""

    n_ais_intermediate_distributions: int
    n_updates: int = 1
    max_step_size: float = 1.0
    min_step_size: float = 0.1
    adjust_step_size: bool = True
    target_p_accept: float = 0.65

    uses_grad_info: bool = dataclasses.field(default=False, init=False, repr=False)

    def init_state(self, dim: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
        del dim
        row = np.linspace(self.max_step_size, self.min_step_size, self.n_updates)
        row = torch.as_tensor(row, dtype=dtype, device=device)
        return {"noise_scalings": row[None, :].repeat(self.n_ais_intermediate_distributions, 1)}

    def init_info(self, device=None) -> Dict[str, torch.Tensor]:
        """The info a pass reports, zeroed: p_accept per update, avg_distance."""
        return {"p_accept": torch.zeros((self.n_updates,), device=device),
                "avg_distance": torch.zeros((), device=device)}

    def transition(
        self,
        state: Dict[str, torch.Tensor],
        generator: torch.Generator,
        point: Point,
        beta: float,
        dist_idx: int,
        log_q_fn: LogProbFn,
        log_p_fn: LogProbFn,
        ais_alpha: float,
        mask: torch.Tensor,
        tune: bool,
    ) -> Tuple[Point, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """n_updates Gaussian random-walk MH steps targeting pi_beta."""
        x_original = point.x
        scal_row = state["noise_scalings"][dist_idx].clone()
        log_prob_curr = intermediate_log_prob(point, beta, ais_alpha)
        p_accepts = []
        for n in range(self.n_updates):
            noise = mesh.draw_rows(random.normal, generator, point.x.shape, point.x.dtype,
                                   point.x.device)
            x_prop = point.x + scal_row[n] * noise
            point_prop = create_point(x_prop, log_q_fn, log_p_fn, with_grad=False)
            log_prob_prop = intermediate_log_prob(point_prop, beta, ais_alpha)
            accept_prob = torch.nan_to_num(
                torch.exp(log_prob_prop - log_prob_curr), nan=0.0, posinf=0.0, neginf=0.0
            )
            u = mesh.draw_rows(random.uniform, generator, accept_prob.shape,
                               accept_prob.dtype, accept_prob.device)
            accept = accept_prob > u
            point = select_point(accept, point_prop, point)
            log_prob_curr = torch.where(accept, log_prob_prop, log_prob_curr)
            p_accept = masked_mean(accept_prob.clamp(max=1.0), mask)
            if tune and self.adjust_step_size:
                scal_row[n] = torch.where(p_accept > self.target_p_accept,
                                          scal_row[n] * 1.05, scal_row[n] * (1 / 1.05))
            p_accepts.append(p_accept)
        noise_scalings = state["noise_scalings"].clone()
        noise_scalings[dist_idx] = scal_row
        distance = torch.linalg.vector_norm(point.x - x_original, dim=-1)
        info = {"p_accept": torch.stack(p_accepts), "avg_distance": masked_mean(distance, mask)}
        return point, {"noise_scalings": noise_scalings}, info
