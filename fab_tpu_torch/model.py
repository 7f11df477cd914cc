"""FABModel: flow + target + AIS + the fab_alpha_div loss + evaluation
(``fab_tpu/model.py``).

The flow's parameters live in its modules; the transition operator's adaptation
state is an explicit dict passed in and returned.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fab_tpu_torch import losses
from fab_tpu_torch.flows.base import Flow, flow_log_prob
from fab_tpu_torch.sampling.ais import AnnealedImportanceSampler
from fab_tpu_torch.targets.base import TargetDistribution
from fab_tpu_torch.utils.numerical import effective_sample_size


@dataclasses.dataclass(frozen=True)
class FABModel:
    flow: Flow
    target: TargetDistribution
    ais: Optional[AnnealedImportanceSampler]
    loss_type: str
    alpha: float = 2.0

    @classmethod
    def create(
        cls,
        flow: Flow,
        target: TargetDistribution,
        transition_operator=None,
        n_intermediate_distributions: int = 1,
        alpha: float = 2.0,
        ais_distribution_spacing: str = "linear",
        loss_type: str = "fab_alpha_div",
    ) -> "FABModel":
        """Wire flow + target + transition operator into an AIS chain."""
        if loss_type not in losses.LOSS_TYPES:
            raise ValueError(
                f"Unknown or unported loss_type {loss_type!r}; options: "
                f"{losses.LOSS_TYPES}"
            )
        if transition_operator is None:
            raise ValueError("If using AIS, transition operator must be provided.")
        ais = AnnealedImportanceSampler(
            flow=flow,
            target_log_prob=target.log_prob,
            transition_operator=transition_operator,
            n_intermediate_distributions=n_intermediate_distributions,
            spacing_type=ais_distribution_spacing,
            alpha=alpha,
        )
        return cls(flow=flow, target=target, ais=ais, loss_type=loss_type, alpha=alpha)

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Re-initialise the flow's parameters; return a fresh transition state."""
        self.flow.reset_parameters(generator)
        p = next(self.flow.parameters())
        return self.ais.transition_operator.init_state(
            self.flow.dim, dtype=p.dtype, device=p.device
        )

    def loss_and_info(
        self,
        transition_state,
        generator: torch.Generator,
        batch_size: int,
        tune: bool = True,
    ) -> Tuple[torch.Tensor, Any, Dict[str, Any]]:
        """(loss, new transition state, info); the loss is differentiable in the
        flow's parameters only (AIS output is detached)."""
        result = self.ais.sample_and_log_weights(
            transition_state, generator, batch_size, p_target=False, tune=tune
        )
        # Zero-fill invalid rows BEFORE the differentiated evaluation, so no NaN
        # cotangent reaches the parameters.
        x_safe = torch.where(result.mask[:, None], result.point.x, 0.0)
        log_q_x = flow_log_prob(self.flow, x_safe)
        loss = losses.fab_alpha_div(log_q_x, result.log_w, self.alpha, result.mask)
        return loss, result.transition_state, dict(result.info)

    def generate_eval_data(
        self,
        transition_state,
        generator: torch.Generator,
        outer_batch_size: int,
        inner_batch_size: int,
        p_target: bool = True,
    ) -> Tuple[np.ndarray, ...]:
        """A large eval batch from AIS passes of ``inner_batch_size`` rows, gathered
        on the host (``fab_tpu/model.py:194-263``).

        Returns (flow x, flow log_w, flow mask, AIS x, AIS log_w, AIS mask). The flow
        samples are the draw each AIS pass starts from (``AISResult.flow_sample``),
        weighed by log p - log q, so no second flow pass is spent on them.
        """
        if outer_batch_size % inner_batch_size != 0:
            raise ValueError(
                f"eval outer_batch_size ({outer_batch_size}) must be a multiple of "
                f"inner_batch_size ({inner_batch_size}); pick e.g. "
                f"{-(-outer_batch_size // inner_batch_size) * inner_batch_size}"
            )
        chunks = []
        for _ in range(outer_batch_size // inner_batch_size):
            result = self.ais.sample_and_log_weights(
                transition_state, generator, inner_batch_size, p_target=p_target,
                tune=False,
            )
            x0, log_q0 = result.flow_sample
            with torch.no_grad():
                log_p0 = self.target.log_prob(x0)
            base_mask = (
                torch.isfinite(x0).all(-1) & torch.isfinite(log_q0) & torch.isfinite(log_p0)
            )
            base_log_w = torch.where(base_mask, log_p0 - log_q0, -math.inf)
            chunk = (x0, base_log_w, base_mask, result.point.x, result.log_w, result.mask)
            chunks.append([t.detach().cpu().numpy() for t in chunk])
        return tuple(np.concatenate(parts) for parts in zip(*chunks))

    def get_eval_info(
        self,
        transition_state,
        generator: torch.Generator,
        outer_batch_size: int,
        inner_batch_size: int,
        p_target: bool = True,
        ais_only: bool = False,
    ) -> Dict[str, float]:
        """ESS of the flow and AIS samples, and the target's metrics on each
        (``fab_tpu/model.py:265-319``)."""
        base_x, base_log_w, base_mask, ais_x, ais_log_w, ais_mask = (
            self.generate_eval_data(
                transition_state, generator, outer_batch_size, inner_batch_size,
                p_target,
            )
        )
        device = next(self.flow.parameters()).device
        on_device = lambda a: torch.as_tensor(a, device=device)
        with torch.no_grad():
            info = {
                "eval_ess_flow": float(
                    effective_sample_size(on_device(base_log_w), on_device(base_mask))
                ),
                "eval_ess_ais": float(
                    effective_sample_size(on_device(ais_log_w), on_device(ais_mask))
                ),
            }
            if not ais_only:
                flow_info = self.target.performance_metrics(
                    on_device(base_x), on_device(base_log_w),
                    lambda x: flow_log_prob(self.flow, x), mask=on_device(base_mask),
                )
                info.update({"flow_" + k: float(v) for k, v in flow_info.items()})
            ais_info = self.target.performance_metrics(
                on_device(ais_x), on_device(ais_log_w), mask=on_device(ais_mask)
            )
        info.update({"ais_" + k: float(v) for k, v in ais_info.items()})
        return info


def format_transition_info(
    t_info: Dict[str, torch.Tensor], n_dists: int
) -> Dict[str, torch.Tensor]:
    """Flatten the stacked per-distribution transition info into logging keys
    (``fab_tpu/model.py:322-339``): acceptance probabilities and move distance of
    the first and, if there are several, the last intermediate distribution."""
    out = {}
    p_acc = t_info["p_accept"]  # [n_dists, n_outer]
    for i in range(p_acc.shape[-1]):
        out[f"dist0_p_accept_{i}"] = p_acc[0, i]
    out["average_distance_dist0"] = t_info["avg_distance"][0]
    if n_dists > 1:
        for i in range(p_acc.shape[-1]):
            out[f"dist{n_dists - 1}_p_accept_{i}"] = p_acc[-1, i]
        out[f"average_distance_dist_{n_dists - 1}"] = t_info["avg_distance"][-1]
    return out
