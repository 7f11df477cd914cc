"""Annealed importance sampling (``fab_tpu/sampling/ais.py``).

A Python loop over the static beta schedule. Invalid rows are never dropped: a
validity mask is threaded through, invalid rows are zero-filled, excluded from every
reduction and given weight -inf. Train-time AIS targets g = p^alpha q^(1-alpha),
eval-time AIS targets p (``p_target``). The flow's parameters are frozen for the
whole pass, so each log q evaluation differentiates with respect to x only.

Under a data mesh (``parallel/mesh.py``) ``batch_size`` is the global batch: the
pass holds this rank's rows, draws what one process would, and its info (ESS, log
Z, counts, acceptance) is over the global batch. A batch the data axis does not
divide runs whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fab_tpu_torch.flows.base import Flow, flow_log_prob, frozen, log_q_noise
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.sampling.point import create_point, intermediate_log_prob
from fab_tpu_torch.sampling.schedules import beta_schedule
from fab_tpu_torch.typing import LogProbFn, Point
from fab_tpu_torch.utils.numerical import effective_sample_size, log_z_estimate


class AISResult(NamedTuple):
    point: Point
    log_w: torch.Tensor  # [B]
    mask: torch.Tensor  # [B] bool, valid rows
    transition_state: Any
    info: Dict[str, Any]
    # (x, log q) of the flow draw the chain started from, before invalid rows were
    # zero-filled: evaluation weighs these flow samples without drawing again.
    flow_sample: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class AnnealedImportanceSampler:
    """Static AIS config: flow + target + transition operator + beta schedule."""

    flow: Flow
    target_log_prob: LogProbFn
    transition_operator: Any  # HamiltonianMonteCarlo
    n_intermediate_distributions: int = 1
    spacing_type: str = "linear"
    alpha: float = 2.0

    @property
    def betas(self) -> np.ndarray:
        return beta_schedule(self.spacing_type, self.n_intermediate_distributions)

    def sample_and_log_weights(
        self,
        transition_state,
        generator: torch.Generator,
        batch_size: int,
        p_target: bool = False,
        tune: bool = True,
    ) -> AISResult:
        """One AIS pass over ``batch_size`` rows: flow sample -> anneal through the
        beta schedule."""
        if not mesh.divides(batch_size):
            with mesh.use_mesh(None):
                return self._pass(transition_state, generator, batch_size, p_target, tune)
        return self._pass(transition_state, generator, batch_size, p_target, tune)

    def _pass(self, transition_state, generator, batch_size, p_target, tune) -> AISResult:
        ais_alpha = 1.0 if p_target else self.alpha
        betas = [float(b) for b in self.betas]
        trans_op = self.transition_operator
        flow = self.flow

        # A stochastic flow's log q draws its noise from one key per pass, made
        # before the flow sample: every log-q call of the pass sees the same noise.
        # A deterministic flow gets None and the pass's draws are unchanged.
        key_lq = log_q_noise(flow, generator)

        def log_q_fn(x):
            return flow_log_prob(flow, x, key_lq)

        with frozen(flow):
            with torch.no_grad():
                x, log_q_flow = flow.sample_and_log_prob(batch_size, generator)
            flow_sample = (x, log_q_flow)
            row_ok = torch.isfinite(x).all(-1) & torch.isfinite(log_q_flow)
            x = torch.where(row_ok[:, None], x, 0.0)
            point = create_point(
                x,
                log_q_fn,
                self.target_log_prob,
                with_grad=trans_op.uses_grad_info,
                log_q_x=torch.where(row_ok, log_q_flow, 0.0),
            )
            if trans_op.uses_grad_info:
                row_ok = row_ok & torch.isfinite(point.log_q)
            mask = row_ok & torch.isfinite(point.log_p)

            log_w = intermediate_log_prob(point, betas[1], ais_alpha) - point.log_q
            ess_base = effective_sample_size(point.log_p - point.log_q, mask)

            t_infos = []
            for dist_idx in range(self.n_intermediate_distributions):
                beta_j, beta_jp1 = betas[dist_idx + 1], betas[dist_idx + 2]
                point, transition_state, t_info = trans_op.transition(
                    transition_state, generator, point, beta_j, dist_idx, log_q_fn,
                    self.target_log_prob, ais_alpha, mask, tune,
                )
                log_w = log_w + (
                    intermediate_log_prob(point, beta_jp1, ais_alpha)
                    - intermediate_log_prob(point, beta_j, ais_alpha)
                )
                t_infos.append(t_info)

        # Chain-end validity: non-finite rows, and finite rows with |log_w| beyond
        # 1e10 nats (a target/flow overflow guard), are invalid.
        finite_ok = (
            mask
            & torch.isfinite(point.log_q)
            & torch.isfinite(point.log_p)
            & torch.isfinite(log_w)
        )
        bound_ok = log_w.abs() < 1e10
        mask = finite_ok & bound_ok
        log_w = torch.where(mask, log_w, -torch.inf)

        counts = torch.stack([mask.sum(), (finite_ok & ~bound_ok).sum()])
        if mesh.active_mesh() is not None:
            counts = mesh.all_reduce(counts)
        info = {
            "ess_base": ess_base,
            "ess_ais": effective_sample_size(log_w, mask),
            "log_Z": log_z_estimate(log_w, mask),
            "n_valid": counts[0],
            "n_logw_bound_masked": counts[1],
            # Per intermediate distribution: p_accept [n_dists, n_outer],
            # avg_distance [n_dists].
            "transition": {
                k: torch.stack([t[k] for t in t_infos]) for k in t_infos[0]
            },
        }
        return AISResult(point, log_w, mask, transition_state, info, flow_sample)
