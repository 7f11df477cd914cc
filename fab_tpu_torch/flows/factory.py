"""Flow factory and ActNorm's data-dependent initialisation
(``fab_tpu/flows/factory.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows.base import DiagGaussianBase, Flow
from fab_tpu_torch.flows.coupling import AffineCoupling
from fab_tpu_torch.flows.fused import FusedRealNVPFlow
from fab_tpu_torch.flows.large_coupling import LargeFusedCoupling
from fab_tpu_torch.flows.linear import ActNorm, LULinear
from fab_tpu_torch.flows.resampled import ResampledGaussianBase


def make_realnvp(
    dim: int,
    n_flow_layers: int = 5,
    layer_nodes_per_dim: int = 10,
    act_norm: bool = False,
    scale_cap: float = 0.0,
    fused: bool = False,
    fused_coupling: bool = False,
    init_mode: str = "he_normal",
    generator: torch.Generator = None,
    dtype=torch.float32,
    device="cuda",
) -> Flow:
    """RealNVP stack: n_flow_layers x [affine coupling, LU-linear (, ActNorm)].

    ``fused=True`` returns a FusedRealNVPFlow whose passes run as one K1 launch
    (no ActNorm, no scale cap, as in ``fab_tpu``). ``fused_coupling=True`` makes each
    coupling a LargeFusedCoupling, one K2 call per layer (LGCP-1600-class dims). The
    two exclude each other. Parameters are initialised from ``generator`` (a fresh
    seed-0 generator on the device if none is given). ``act_norm`` defaults to False
    here (``fab_tpu``'s default is True): the port's callers name it.
    """
    device = resolve_device(device)
    width = dim * layer_nodes_per_dim
    coupling = LargeFusedCoupling if fused_coupling else AffineCoupling
    bijectors = []
    for _ in range(n_flow_layers):
        bijectors.append(
            coupling(
                dim, width, scale_cap=scale_cap, init_mode=init_mode, dtype=dtype,
                device=device,
            )
        )
        bijectors.append(LULinear(dim, dtype=dtype, device=device))
        if act_norm:
            bijectors.append(ActNorm(dim, dtype=dtype, device=device))
    base = DiagGaussianBase(dim, dtype=dtype, device=device)
    if fused:
        flow = FusedRealNVPFlow(dim, bijectors, base)
    else:
        flow = Flow(dim, bijectors, base)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    flow.reset_parameters(generator)
    return flow


def make_resampled_realnvp(
    dim: int,
    n_flow_layers: int = 5,
    layer_nodes_per_dim: int = 10,
    act_norm: bool = False,
    a_hidden_units: int = 256,
    a_hidden_layers: int = 2,
    T: int = 100,
    init_mode: str = "he_normal",
    generator: torch.Generator = None,
    dtype=torch.float32,
    device="cuda",
) -> Flow:
    """The unfused RealNVP of ``make_realnvp`` over a LARS resampled-Gaussian base
    (acceptance net ``a_hidden_layers`` x ``a_hidden_units``, truncation ``T``),
    which initialises from its own seed."""
    flow = make_realnvp(
        dim, n_flow_layers=n_flow_layers, layer_nodes_per_dim=layer_nodes_per_dim,
        act_norm=act_norm, init_mode=init_mode, generator=generator, dtype=dtype,
        device=device,
    )
    flow.base = ResampledGaussianBase(
        dim, hidden_units=a_hidden_units, n_hidden_layers=a_hidden_layers, T=T,
        init_mode=init_mode, dtype=dtype, device=flow.base.loc.device,
    )
    return flow


def data_dependent_init(
    flow: Flow,
    generator: torch.Generator,
    n_samples: int = 500,
    data: Optional[torch.Tensor] = None,
) -> Flow:
    """Data-dependent ActNorm initialisation, in place: push a batch (``data``, or
    ``n_samples`` draws of the base) forward layer by layer and set each ActNorm so
    that its output is standardised per dimension. Returns the flow."""
    with torch.no_grad():
        if data is None:
            z, _ = flow.base.sample_and_log_prob(n_samples, generator)
        else:
            z = data
        for bij in flow.bijectors:
            if isinstance(bij, ActNorm):
                std = z.std(0, correction=0) + 1e-6
                log_scale = -torch.log(std)
                bij.log_scale.copy_(log_scale)
                bij.shift.copy_(-z.mean(0) * torch.exp(log_scale))
            if getattr(bij, "is_stochastic", False):
                z, _ = bij.forward_and_log_det(z, generator)
            else:
                z, _ = bij.forward_and_log_det(z)
    return flow
