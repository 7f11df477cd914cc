"""Hamiltonian Monte Carlo transition kernel (``fab_tpu/sampling/hmc.py``).

Step sizes are per-(intermediate distribution, outer step) plus a shared common
component, carried in an explicit state dict and adapted toward
``target_p_accept`` by x1.05 / x1.02 from the masked batch-mean acceptance
probability. The adaptation stays on the device (``torch.where``, no host sync).
Each leapfrog step re-evaluates the flow and target log-probs with their
x-gradients; gradients are clamped to +-max_grad and then NaN-scrubbed; the MH test
is an exponential race that rejects non-finite acceptance ratios. Under a data mesh
the momenta and the race are drawn at the global batch's shape and cut to this
rank's rows, and the acceptance rate and move distance are reduced over every rank,
so every rank adapts its step sizes alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from fab_tpu_torch import random
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.sampling.metropolis import masked_mean
from fab_tpu_torch.sampling.point import (
    create_point,
    grad_intermediate_log_prob,
    intermediate_log_prob,
)
from fab_tpu_torch.typing import LogProbFn, Point, select_point


@dataclasses.dataclass(frozen=True)
class HamiltonianMonteCarlo:
    """Static config; state = {"epsilons", "common_epsilon", "mass"}."""

    n_ais_intermediate_distributions: int
    n_outer: int = 1
    n_leapfrog: int = 5
    epsilon: float = 1.0
    target_p_accept: float = 0.65
    max_grad: float = 1e3
    common_epsilon_init_weight: float = 0.1
    mass_init: float = 1.0

    uses_grad_info: bool = dataclasses.field(default=True, init=False, repr=False)

    def init_state(self, dim: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
        kw = dict(dtype=dtype, device=device)
        return {
            "epsilons": torch.full(
                (self.n_ais_intermediate_distributions, self.n_outer),
                self.epsilon * (1 - self.common_epsilon_init_weight),
                **kw,
            ),
            "common_epsilon": torch.tensor(
                self.epsilon * self.common_epsilon_init_weight, **kw
            ),
            "mass": torch.full((dim,), self.mass_init, **kw),
        }

    def init_info(self, device=None) -> Dict[str, torch.Tensor]:
        """The info a pass reports, zeroed: p_accept per outer step, avg_distance."""
        return {"p_accept": torch.zeros((self.n_outer,), device=device),
                "avg_distance": torch.zeros((), device=device)}

    @staticmethod
    def _kinetic_energy(p: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
        return (p**2 / mass).sum(-1) / 2

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
        mass = state["mass"]
        eps_row = state["epsilons"][dist_idx].clone()
        common_eps = state["common_epsilon"]
        x_original = point.x

        def u_value(pt: Point) -> torch.Tensor:
            return -intermediate_log_prob(pt, beta, ais_alpha)

        def grad_u(pt: Point) -> torch.Tensor:
            g = -grad_intermediate_log_prob(pt, beta, ais_alpha)
            g = g.clamp(min=-self.max_grad, max=self.max_grad)
            return torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)

        p_accepts = []
        for n in range(self.n_outer):
            epsilon = eps_row[n] + common_eps
            # Momentum refresh p ~ N(0, mass^2), kinetic energy p^2 / (2 mass)
            # (fab_tpu keeps the reference's convention).
            p0 = mesh.draw_rows(random.normal, generator, point.x.shape, point.x.dtype,
                                point.x.device) * mass
            proposal, p, grad = point, p0, grad_u(point)
            for _ in range(self.n_leapfrog):
                p = p - epsilon * grad / 2
                x = proposal.x + epsilon / mass * p
                proposal = create_point(x, log_q_fn, log_p_fn, with_grad=True)
                grad = grad_u(proposal)
                p = p - epsilon * grad / 2
            log_acc = (
                -u_value(proposal)
                - self._kinetic_energy(p, mass)
                + u_value(point)
                + self._kinetic_energy(p0, mass)
            )
            finite = torch.isfinite(log_acc)
            log_acc = torch.where(finite, log_acc, -math.inf)
            race = mesh.draw_rows(
                random.exponential, generator, log_acc.shape, log_acc.dtype, log_acc.device
            )
            accept = (log_acc > -race) & finite
            point = select_point(accept, proposal, point)
            p_accept = masked_mean(torch.exp(log_acc.clamp(max=0.0)), mask)
            if tune:
                too_high = p_accept > self.target_p_accept
                eps_row[n] = torch.where(
                    too_high, eps_row[n] * 1.05, eps_row[n] * (1 / 1.05)
                )
                common_eps = torch.where(
                    too_high, common_eps * 1.02, common_eps * (1 / 1.02)
                )
            p_accepts.append(p_accept)

        epsilons = state["epsilons"].clone()
        epsilons[dist_idx] = eps_row
        new_state = {"epsilons": epsilons, "common_epsilon": common_eps, "mass": mass}
        distance = torch.linalg.vector_norm(point.x - x_original, dim=-1)
        info = {
            "p_accept": torch.stack(p_accepts),
            "avg_distance": masked_mean(distance, mask),
        }
        return point, new_state, info
