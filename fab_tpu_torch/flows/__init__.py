from fab_tpu_torch.flows.base import DiagGaussianBase, Flow, flow_log_prob, frozen
from fab_tpu_torch.flows.coupling import AffineCoupling
from fab_tpu_torch.flows.factory import make_realnvp
from fab_tpu_torch.flows.fused import FusedRealNVPFlow
from fab_tpu_torch.flows.large_coupling import LargeFusedCoupling
from fab_tpu_torch.flows.linear import LULinear

__all__ = [
    "AffineCoupling",
    "DiagGaussianBase",
    "Flow",
    "FusedRealNVPFlow",
    "LULinear",
    "LargeFusedCoupling",
    "flow_log_prob",
    "frozen",
    "make_realnvp",
]
