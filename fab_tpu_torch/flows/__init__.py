from fab_tpu_torch.flows.base import (
    DiagGaussianBase,
    Flow,
    UniformGaussianBase,
    flow_log_prob,
    frozen,
)
from fab_tpu_torch.flows.coupling import AffineCoupling
from fab_tpu_torch.flows.factory import data_dependent_init, make_realnvp
from fab_tpu_torch.flows.fused import FusedRealNVPFlow
from fab_tpu_torch.flows.large_coupling import LargeFusedCoupling
from fab_tpu_torch.flows.linear import ActNorm, LULinear
from fab_tpu_torch.flows.splines import PeriodicShift, SplineCoupling

__all__ = [
    "ActNorm",
    "AffineCoupling",
    "DiagGaussianBase",
    "Flow",
    "FusedRealNVPFlow",
    "LULinear",
    "LargeFusedCoupling",
    "PeriodicShift",
    "SplineCoupling",
    "UniformGaussianBase",
    "data_dependent_init",
    "flow_log_prob",
    "frozen",
    "make_realnvp",
]
