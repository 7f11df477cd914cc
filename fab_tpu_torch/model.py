"""FABModel: flow + target + AIS + the fab_alpha_div loss (``fab_tpu/model.py``).

The flow's parameters live in its modules; the transition operator's adaptation
state is an explicit dict passed in and returned. Evaluation (``get_eval_info``) is
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from fab_tpu_torch import losses
from fab_tpu_torch.flows.base import Flow, flow_log_prob
from fab_tpu_torch.sampling.ais import AnnealedImportanceSampler
from fab_tpu_torch.targets.base import TargetDistribution


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
