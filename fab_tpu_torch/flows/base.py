"""Flow core: bijector interface, diagonal-Gaussian base, composed Flow
(``fab_tpu/flows/base.py``).

Direction convention: ``forward`` maps base -> data (sampling); ``inverse`` maps
data -> base (density evaluation). Parameters live in the modules; state-dict keys
follow ``fab_tpu``'s pytree (``base.loc``, ``bijectors.<i>.mlp.<j>.w``, ...), see
``fab_tpu_torch/convert.py``.

``sample_and_log_prob(n, generator)`` takes the global batch ``n``: under a data
mesh a base draws its noise at [n, D] and keeps this rank's rows
(``parallel/mesh.py``), so the flow's draws are one process's.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple

import torch
from torch import nn

from fab_tpu_torch import random
from fab_tpu_torch.parallel.mesh import constrain_batch


class Bijector(nn.Module):
    """A bijector whose parameters are initialised by ``reset_parameters``."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Base -> data. Returns (x, log|det J|) with log-det shaped [B]."""
        raise NotImplementedError

    def inverse_and_log_det(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Data -> base. Returns (z, log|det J^-1|) with log-det shaped [B]."""
        raise NotImplementedError

    def shard_model_axis(self, mesh, name: str = "") -> None:
        """Split this bijector's parameters over the model axis (``fab_tpu``'s
        ``param_sharding``); replicated by default."""


class DiagGaussianBase(nn.Module):
    """Trainable diagonal-Gaussian base distribution (loc, log_scale)."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.loc = nn.Parameter(torch.zeros((dim,), dtype=dtype, device=device))
        self.log_scale = nn.Parameter(torch.zeros((dim,), dtype=dtype, device=device))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.loc.zero_()
            self.log_scale.zero_()

    def sample_and_log_prob(
        self, n: int, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        eps = constrain_batch(
            random.normal(generator, (n, self.dim), self.loc.dtype, self.loc.device))
        z = self.loc + eps * torch.exp(self.log_scale)
        return z, self._log_prob_from_eps(eps)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        eps = (z - self.loc) * torch.exp(-self.log_scale)
        return self._log_prob_from_eps(eps)

    def _log_prob_from_eps(self, eps: torch.Tensor) -> torch.Tensor:
        log_norm = -0.5 * self.dim * math.log(2 * math.pi) - self.log_scale.sum()
        return log_norm - 0.5 * (eps**2).sum(-1)


class UniformGaussianBase(nn.Module):
    """Uniform on [-b, b] on the circular dims and standard normal elsewhere, with
    no parameters (``fab_tpu/flows/base.py:99-146``; the ALDP flow's base); b is
    ``circular_bound``, pi by default.

    Its log density is -inf outside [-b, b] on a circular dim. The module holds
    no state to save; an empty buffer carries its dtype and device, which
    ``Flow.to`` sets.
    """

    def __init__(self, dim: int, circular_dims: Sequence[int],
                 circular_bound: float = math.pi, dtype=torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.circular_dims = tuple(int(i) for i in circular_dims)
        self.circular_bound = float(circular_bound)
        circ = torch.zeros((dim,), dtype=torch.bool, device=device)
        circ[list(self.circular_dims)] = True
        self.register_buffer("circular", circ, persistent=False)
        self.register_buffer("_like", torch.zeros((0,), dtype=dtype, device=device),
                             persistent=False)

    def reset_parameters(self) -> None:
        pass

    def sample_and_log_prob(
        self, n: int, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype, device, b = self._like.dtype, self._like.device, self.circular_bound
        gauss = constrain_batch(random.normal(generator, (n, self.dim), dtype, device))
        uni = constrain_batch(
            random.uniform(generator, (n, self.dim), dtype, device) * (2 * b) - b).clamp(min=-b)
        z = torch.where(self.circular, uni, gauss)
        return z, self.log_prob(z)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        b = self.circular_bound
        log_gauss = -0.5 * z**2 - 0.5 * math.log(2 * math.pi)
        log_uni = torch.where(z.abs() <= b, z.new_full((), -math.log(2 * b)), -math.inf)
        return torch.where(self.circular, log_uni, log_gauss).sum(-1)


class Flow(nn.Module):
    """A normalizing flow q: a base (``base``: a trainable diagonal Gaussian by
    default, or ``UniformGaussianBase``) + chain of bijectors."""

    def __init__(self, dim: int, bijectors: Sequence[Bijector], base: nn.Module = None):
        super().__init__()
        self.dim = dim
        self.base = base if base is not None else DiagGaussianBase(dim)
        self.bijectors = nn.ModuleList(bijectors)

    @property
    def base_dist(self) -> nn.Module:
        """The base distribution (``fab_tpu``'s field of that name)."""
        return self.base

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return (self.dim,)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.base.reset_parameters()
        for bij in self.bijectors:
            bij.reset_parameters(generator)

    def shard_model_axis(self, mesh) -> None:
        """Split the bijectors' conditioners over the model axis of ``mesh``
        (``fab_tpu``'s ``Flow.param_sharding``: the base replicated); see
        ``parallel/tensor.py:shard_flow_params``."""
        for i, bij in enumerate(self.bijectors):
            if isinstance(bij, Bijector):
                bij.shard_model_axis(mesh, f"bijectors.{i}")

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        log_det = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for bij in self.bijectors:
            z, ld = bij.forward_and_log_det(z)
            log_det = log_det + ld
        return z, log_det

    def inverse_and_log_det(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        log_det = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for bij in reversed(self.bijectors):
            x, ld = bij.inverse_and_log_det(x)
            log_det = log_det + ld
        return x, log_det

    def sample_and_log_prob(
        self, n: int, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        z, log_q = self.base.sample_and_log_prob(n, generator)
        x, log_det = self.forward_and_log_det(z)
        return x, log_q - log_det

    def sample(self, n: int, generator: torch.Generator) -> torch.Tensor:
        return self.sample_and_log_prob(n, generator)[0]

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z, log_det = self.inverse_and_log_det(x)
        return self.base.log_prob(z) + log_det


def is_stochastic(flow) -> bool:
    """Whether ``flow``'s log q draws noise (an SNF declares ``is_stochastic``)."""
    return getattr(flow, "is_stochastic", False)


def flow_log_prob(flow, x: torch.Tensor, generator: torch.Generator = None) -> torch.Tensor:
    """log q(x). A stochastic flow gets ``generator`` as the key of its noise (the
    same key gives the same noise, see ``random.restart``); a deterministic flow
    ignores it."""
    if is_stochastic(flow):
        return flow.log_prob(x, generator)
    return flow.log_prob(x)


def log_q_noise(flow, generator: torch.Generator):
    """The key for one role's log-q calls (one AIS pass, one loss re-evaluation, one
    replay batch, one evaluation): split from ``generator`` for a stochastic flow;
    None for a deterministic one, which then draws nothing and launches nothing."""
    return random.split(generator) if is_stochastic(flow) else None


@contextlib.contextmanager
def frozen(module: nn.Module):
    """Turn off parameter gradients inside the block (``stop_gradient`` on params).

    Gradients with respect to the inputs still flow; the previous flags come back
    on exit.
    """
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield module
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)
