"""Flow factory (``fab_tpu/flows/factory.py:make_realnvp``)."""
from __future__ import annotations

import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows.base import DiagGaussianBase, Flow
from fab_tpu_torch.flows.coupling import AffineCoupling
from fab_tpu_torch.flows.fused import FusedRealNVPFlow
from fab_tpu_torch.flows.large_coupling import LargeFusedCoupling
from fab_tpu_torch.flows.linear import LULinear


def make_realnvp(
    dim: int,
    n_flow_layers: int = 5,
    layer_nodes_per_dim: int = 10,
    scale_cap: float = 0.0,
    fused: bool = False,
    fused_coupling: bool = False,
    init_mode: str = "he_normal",
    generator: torch.Generator = None,
    dtype=torch.float32,
    device="cuda",
) -> Flow:
    """RealNVP stack: n_flow_layers x [affine coupling, LU-linear].

    ``fused=True`` returns a FusedRealNVPFlow whose passes run as one K1 launch.
    ``fused_coupling=True`` makes each coupling a LargeFusedCoupling, one K2 call per
    layer (LGCP-1600-class dims). The two exclude each other. Parameters are
    initialised from ``generator`` (a fresh seed-0 generator on the device if none
    is given). ActNorm is not ported yet: this is ``fab_tpu``'s
    ``make_realnvp(..., act_norm=False)``.
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
    base = DiagGaussianBase(dim, dtype=dtype, device=device)
    if fused:
        flow = FusedRealNVPFlow(dim, bijectors, base)
    else:
        flow = Flow(dim, bijectors, base)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    flow.reset_parameters(generator)
    return flow
