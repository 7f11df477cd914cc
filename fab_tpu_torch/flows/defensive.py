"""Defensive mixture: a flow mixed with a learned diagonal Gaussian
(``fab_tpu/flows/defensive.py``).

q(x) = w q_flow(x) + (1 - w) N(x; mu, sigma), w = sigmoid(mixture_logit), with a
logaddexp log-prob and component-sampled (not reparameterised) draws. The inner
flow's log q is called without a generator, so a stochastic (SNF) inner flow
raises its ``ValueError`` there, as in ``fab_tpu``: there is no fixed-key fallback.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fab_tpu_torch import random
from fab_tpu_torch.flows.base import DiagGaussianBase, Flow
from fab_tpu_torch.parallel.mesh import constrain_batch


class DefensiveMixture(nn.Module):
    """Wraps ``flow``; adds the defensive Gaussian ``defensive`` and the flow's
    weight logit ``mixture_logit`` (2.2 at initialisation, a weight of ~0.9)."""

    def __init__(self, flow: Flow):
        super().__init__()
        self.flow = flow
        self.dim = flow.dim
        ref = next(flow.parameters())
        self.defensive = DiagGaussianBase(flow.dim, dtype=ref.dtype, device=ref.device)
        self.mixture_logit = nn.Parameter(torch.full((), 2.2, dtype=ref.dtype,
                                                     device=ref.device))

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return (self.flow.dim,)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.flow.reset_parameters(generator)
        self.defensive.reset_parameters()
        with torch.no_grad():
            self.mixture_logit.fill_(2.2)

    def _log_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return F.logsigmoid(self.mixture_logit), F.logsigmoid(-self.mixture_logit)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        log_w_flow, log_w_def = self._log_weights()
        log_q_flow = self.flow.log_prob(x)
        log_q_def = self.defensive.log_prob(x)
        return torch.logaddexp(log_w_flow + log_q_flow, log_w_def + log_q_def)

    def sample_and_log_prob(
        self, n: int, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Draws, in ``fab_tpu``'s order: the component (a uniform below the flow's
        weight), the flow's sample, the Gaussian's; the mixed draw is detached. Under
        a data mesh each is this rank's rows of the global batch ``n``."""
        log_w_flow, _ = self._log_weights()
        with torch.no_grad():
            p = torch.exp(log_w_flow)
            use_flow = constrain_batch(random.bernoulli(generator, p, (n,), p.dtype, p.device))
            x_flow, _ = self.flow.sample_and_log_prob(n, generator)
            x_def, _ = self.defensive.sample_and_log_prob(n, generator)
            x = torch.where(use_flow[:, None], x_flow, x_def)
        return x, self.log_prob(x)

    def sample(self, n: int, generator: torch.Generator) -> torch.Tensor:
        return self.sample_and_log_prob(n, generator)[0]
