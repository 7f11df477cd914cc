"""Stochastic normalizing flow (SNF): Metropolis sampling layers inside the flow
(``fab_tpu/flows/snf.py``).

RealNVP blocks interleaved with Metropolis-Hastings layers that target the
interpolation log pi_lam = lam * log p + (1 - lam) * log N(0, I), lam ramping with
depth. A layer's log-det is log pi(start) - log pi(end), so one lam = 1 layer
telescopes the importance weight to the AIS identity log p(z0) - log q0(z0).

Noise: ``sample_and_log_prob(n, generator)`` draws from ``generator`` (the base, then
each MH layer in forward order). ``log_prob(x, generator)`` takes ``generator`` as a
key and draws from a restart of it (``random.restart``), walking the layers in
reverse, so every call with one key sees the same noise, as ``fab_tpu``'s keyed
``log_prob`` does. Each MH step draws a normal proposal [B, D], then a uniform [B].
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
from torch import nn

from fab_tpu_torch import random
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows.base import DiagGaussianBase, Flow
from fab_tpu_torch.flows.coupling import AffineCoupling
from fab_tpu_torch.flows.linear import ActNorm, LULinear
from fab_tpu_torch.parallel.mesh import draw_rows

NO_KEY = (
    "SNF log_prob requires a generator: the stochastic MH layers draw fresh noise per "
    "call. Pass generator=, or opt into the deterministic biased fallback with "
    "allow_fixed_key=True."
)


class MetropolisSamplingLayer(nn.Module):
    """MH sampling layer at interpolation weight ``lam``, without parameters."""

    is_stochastic = True

    def __init__(
        self,
        target_log_prob: Callable[[torch.Tensor], torch.Tensor],
        lam: float,
        n_steps: int = 10,
        proposal_scale: float = 0.1,
    ):
        super().__init__()
        self.target_log_prob = target_log_prob
        self.lam = lam
        self.n_steps = n_steps
        self.proposal_scale = proposal_scale

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass

    def _log_pi(self, x: torch.Tensor) -> torch.Tensor:
        """lam * log p(x) + (1 - lam) * log N(x; 0, I)."""
        log_base = -0.5 * (x**2).sum(-1) - 0.5 * x.shape[-1] * math.log(2 * math.pi)
        return self.lam * self.target_log_prob(x) + (1 - self.lam) * log_base

    def _mcmc(self, x: torch.Tensor, generator: torch.Generator):
        """n_steps MH steps. The selected positions are not detached: log q is
        differentiated through the chain (only the accept decision is not)."""
        log_pi_start = self._log_pi(x)
        log_pi_x = log_pi_start
        for _ in range(self.n_steps):
            noise = draw_rows(random.normal, generator, x.shape, x.dtype, x.device)
            x_prop = x + self.proposal_scale * noise
            log_pi_prop = self._log_pi(x_prop)
            accept_prob = torch.nan_to_num(torch.exp(log_pi_prop - log_pi_x), nan=0.0, posinf=1.0)
            u = draw_rows(random.uniform, generator, accept_prob.shape, accept_prob.dtype,
                          x.device)
            accept = accept_prob > u
            x = torch.where(accept[..., None], x_prop, x)
            log_pi_x = torch.where(accept, log_pi_prop, log_pi_x)
        return x, log_pi_start - log_pi_x

    def forward_and_log_det(self, z: torch.Tensor, generator: torch.Generator):
        """Sampling direction: (z', log pi(z) - log pi(z'))."""
        return self._mcmc(z, generator)

    def inverse_and_log_det(self, x: torch.Tensor, generator: torch.Generator):
        """Density direction: the kernel is its own reversal (detailed balance)."""
        return self._mcmc(x, generator)


class StochasticFlow(Flow):
    """A ``Flow`` whose chain holds MH sampling layers. They sit in ``bijectors`` at
    ``fab_tpu``'s indexes, so state-dict keys ``bijectors.<i>`` line up with
    ``params["layers"][i]``."""

    is_stochastic = True

    @property
    def layers(self) -> nn.ModuleList:
        """The chain, bijectors and MH layers (``fab_tpu``'s ``layers``)."""
        return self.bijectors

    def forward_and_log_det(self, z: torch.Tensor, generator: torch.Generator):
        log_det = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for layer in self.bijectors:
            if getattr(layer, "is_stochastic", False):
                z, ld = layer.forward_and_log_det(z, generator)
            else:
                z, ld = layer.forward_and_log_det(z)
            log_det = log_det + ld
        return z, log_det

    def inverse_and_log_det(self, x: torch.Tensor, generator: torch.Generator):
        log_det = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for layer in reversed(self.bijectors):
            if getattr(layer, "is_stochastic", False):
                x, ld = layer.inverse_and_log_det(x, generator)
            else:
                x, ld = layer.inverse_and_log_det(x)
            log_det = log_det + ld
        return x, log_det

    def sample_and_log_prob(
        self, n: int, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        z, log_q = self.base.sample_and_log_prob(n, generator)
        x, log_det = self.forward_and_log_det(z, generator)
        return x, log_q - log_det

    def log_prob(
        self, x: torch.Tensor, generator: torch.Generator = None, *,
        allow_fixed_key: bool = False,
    ) -> torch.Tensor:
        """log q(x) on the noise of the key ``generator`` (not advanced). Without
        one it raises, unless ``allow_fixed_key`` asks for a fixed seed-0 key."""
        if generator is None:
            if not allow_fixed_key:
                raise ValueError(NO_KEY)
            generator = torch.Generator(device=x.device).manual_seed(0)
        z, log_det = self.inverse_and_log_det(x, random.restart(generator))
        return self.base.log_prob(z) + log_det


def make_snf_model(
    dim: int,
    target_log_prob: Callable[[torch.Tensor], torch.Tensor],
    n_flow_layers: int = 5,
    layer_nodes_per_dim: int = 10,
    act_norm: bool = False,
    it_snf_layer: int = 2,
    mh_prop_scale: float = 0.1,
    mh_steps: int = 10,
    init_mode: str = "he_normal",
    generator: torch.Generator = None,
    dtype=torch.float32,
    device="cuda",
) -> StochasticFlow:
    """n_flow_layers x [affine coupling, LU-linear (, ActNorm)] over a diagonal
    Gaussian, with an MH layer at lam = (i+1)/n_flow_layers after every
    ``it_snf_layer`` blocks. Parameters come from ``generator`` (a seed-0 generator
    on the device if none is given)."""
    device = resolve_device(device)
    width = dim * layer_nodes_per_dim
    layers: Sequence[nn.Module] = []
    for i in range(n_flow_layers):
        layers.append(AffineCoupling(dim, width, init_mode=init_mode, dtype=dtype,
                                     device=device))
        layers.append(LULinear(dim, dtype=dtype, device=device))
        if act_norm:
            layers.append(ActNorm(dim, dtype=dtype, device=device))
        if (i + 1) % it_snf_layer == 0:
            layers.append(MetropolisSamplingLayer(
                target_log_prob, lam=(i + 1) / n_flow_layers, n_steps=mh_steps,
                proposal_scale=mh_prop_scale,
            ))
    flow = StochasticFlow(dim, layers, DiagGaussianBase(dim, dtype=dtype, device=device))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    flow.reset_parameters(generator)
    return flow
