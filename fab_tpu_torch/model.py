"""FABModel: flow + target + AIS + loss dispatch + evaluation (``fab_tpu/model.py``).

The flow's parameters live in its modules; the transition operator's adaptation
state is an explicit dict passed in and returned (empty without AIS).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from fab_tpu_torch import losses
from fab_tpu_torch.flows.base import Flow, flow_log_prob, is_stochastic, log_q_noise
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.sampling.ais import AnnealedImportanceSampler
from fab_tpu_torch.targets.base import TargetDistribution
from fab_tpu_torch.targets.double_well import DoubleWellEnergy
from fab_tpu_torch.targets.many_well import ManyWellEnergy
from fab_tpu_torch.utils.numerical import effective_sample_size


@dataclasses.dataclass(frozen=True)
class FABModel:
    flow: Flow
    target: TargetDistribution
    ais: Optional[AnnealedImportanceSampler]
    loss_type: str
    alpha: float = 2.0
    # Optional (x, mask) -> mask, applied to sampled batches before the loss (the
    # train-time filter hook; ``fab_tpu`` uses it for ALDP's chirality filter).
    sample_filter: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None

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
        use_ais: bool = True,
    ) -> "FABModel":
        """Wire flow + target + transition operator into an AIS chain. The FAB losses
        always have one; the others only with ``use_ais``."""
        if loss_type not in losses.LOSS_TYPES:
            raise ValueError(
                f"Unknown loss_type {loss_type!r}; options: {losses.LOSS_TYPES}"
            )
        ais = None
        if use_ais or loss_type in ("fab_alpha_div", "fab_ub_alpha_2_div"):
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
        if self.ais is None:
            return {}
        p = next(self.flow.parameters())
        return self.ais.transition_operator.init_state(
            self.flow.dim, dtype=p.dtype, device=p.device
        )

    def filter_batch(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The sample filter's mask, or ``mask`` without a filter."""
        if self.sample_filter is None:
            return mask
        return self.sample_filter(x, mask)

    def loss_and_info(
        self,
        transition_state,
        generator: torch.Generator,
        batch_size: int,
        tune: bool = True,
    ) -> Tuple[torch.Tensor, Any, Dict[str, Any]]:
        """(loss, new transition state, info) for ``loss_type``; the loss is
        differentiable in the flow's parameters only (AIS output is detached). The
        FAB losses run AIS; the flow-sample losses differentiate through a
        reparametrised flow draw; ``target_forward_kl`` uses exact target samples.
        Under a data mesh the loss is this rank's share (``losses.py``)."""
        if self.loss_type in ("fab_alpha_div", "fab_ub_alpha_2_div"):
            result = self.ais.sample_and_log_weights(
                transition_state, generator, batch_size, p_target=False, tune=tune
            )
            mask = self.filter_batch(result.point.x, result.mask)
            # Zero-fill invalid rows BEFORE the differentiated evaluation, so no NaN
            # cotangent reaches the parameters.
            x_safe = torch.where(mask[:, None], result.point.x, 0.0)
            log_q_x = flow_log_prob(self.flow, x_safe, log_q_noise(self.flow, generator))
            if self.loss_type == "fab_alpha_div":
                loss = losses.fab_alpha_div(log_q_x, result.log_w, self.alpha, mask)
            else:
                loss = losses.fab_ub_alpha_2_div(
                    log_q_x, result.point.log_p, result.log_w, mask
                )
            return loss, result.transition_state, dict(result.info)
        if self.loss_type == "target_forward_kl":
            x_p = mesh.constrain_batch(self._target_sample(generator, batch_size))
            return (self.forward_kl_loss(x_p, log_q_noise(self.flow, generator)),
                    transition_state, {})
        if self.loss_type not in ("flow_reverse_kl", "flow_alpha_2_div",
                                  "flow_alpha_2_div_unbiased", "flow_alpha_2_div_nis"):
            raise NotImplementedError(self.loss_type)  # forward_kl: see forward_kl_loss
        x, log_q = self.flow.sample_and_log_prob(batch_size, generator)
        log_p = self.target.log_prob(x)
        loss_fn = getattr(losses, self.loss_type)
        if self.sample_filter is not None:
            mask = self.sample_filter(x, torch.isfinite(log_q) & torch.isfinite(log_p))
            return loss_fn(log_q, log_p, mask=mask), transition_state, {}
        return loss_fn(log_q, log_p), transition_state, {}

    def _target_sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """n exact target draws. ManyWell's and DoubleWell's come in the flow's dtype:
        ``fab_tpu`` draws them in the default float type, which its flow shares (f64
        under x64)."""
        if not isinstance(self.target, (ManyWellEnergy, DoubleWellEnergy)):
            return self.target.sample(generator, n)
        param = next(iter(self.flow.parameters()), None)
        return self.target.sample(generator, n,
                                  dtype=torch.float32 if param is None else param.dtype)

    def forward_kl_loss(
        self, x_p: torch.Tensor, generator: torch.Generator = None
    ) -> torch.Tensor:
        """Forward KL (up to a constant) on target samples x_p. ``generator`` is the
        key of a stochastic flow's log-q noise (``log_q_noise``); such a flow
        without one raises here."""
        if generator is None and is_stochastic(self.flow):
            raise ValueError(
                "forward_kl_loss of a stochastic (SNF) flow requires a generator for "
                "its log-q noise"
            )
        return losses.forward_kl(flow_log_prob(self.flow, x_p, generator))

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
        weighed by log p - log q, so no second flow pass is spent on them. Under a
        data mesh each chunk is gathered from every rank (one all-gather), so every
        rank returns the whole batch, as one process does.
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
            if mesh.active_mesh() is not None and mesh.divides(inner_batch_size):
                chunk = _gather_chunk(chunk)
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
        (``fab_tpu/model.py:265-319``): the flow samples' metrics get the flow's log
        q, ``inner_batch_size`` (ManyWell's exact-sample count) and ``generator``
        (for exact samples and test sets). Under a data mesh every rank runs it: the
        AIS passes are sharded, the metrics are computed whole on every rank."""
        base_x, base_log_w, base_mask, ais_x, ais_log_w, ais_mask = (
            self.generate_eval_data(
                transition_state, generator, outer_batch_size, inner_batch_size,
                p_target,
            )
        )
        device = next(self.flow.parameters()).device
        on_device = lambda a: torch.as_tensor(a, device=device)
        with torch.no_grad(), mesh.use_mesh(None):
            info = {
                "eval_ess_flow": float(
                    effective_sample_size(on_device(base_log_w), on_device(base_mask))
                ),
                "eval_ess_ais": float(
                    effective_sample_size(on_device(ais_log_w), on_device(ais_mask))
                ),
            }
            if not ais_only:
                key_lq = log_q_noise(self.flow, generator)
                flow_info = self.target.performance_metrics(
                    on_device(base_x), on_device(base_log_w),
                    lambda x: flow_log_prob(self.flow, x, key_lq),
                    batch_size=inner_batch_size, mask=on_device(base_mask),
                    generator=generator,
                )
                info.update({"flow_" + k: float(v) for k, v in flow_info.items()})
            ais_info = self.target.performance_metrics(
                on_device(ais_x), on_device(ais_log_w), mask=on_device(ais_mask),
                generator=generator,
            )
        info.update({"ais_" + k: float(v) for k, v in ais_info.items()})
        return info


def _gather_chunk(chunk):
    """(x0, base log_w, base mask, x, log_w, mask) of this rank's rows -> of every
    rank's, in one all-gather (values pass through float64)."""
    x0, base_log_w, base_mask, x, log_w, mask = chunk
    dim = x0.shape[-1]
    packed = torch.cat([x0.double(), base_log_w[:, None].double(),
                        base_mask[:, None].double(), x.double(), log_w[:, None].double(),
                        mask[:, None].double()], dim=1)
    full = mesh.all_gather_rows(packed)
    col = lambda start, stop, like: full[:, start:stop].to(like.dtype)
    return (col(0, dim, x0), col(dim, dim + 1, base_log_w)[:, 0],
            full[:, dim + 1] > 0, col(dim + 2, 2 * dim + 2, x),
            col(2 * dim + 2, 2 * dim + 3, log_w)[:, 0], full[:, 2 * dim + 3] > 0)


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
