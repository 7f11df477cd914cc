from fab_tpu_torch.flows.autoregressive import (
    MaskedAffineAutoregressive,
    Permutation,
    make_masked_affine_maf,
)
from fab_tpu_torch.flows.base import (
    Bijector,
    DiagGaussianBase,
    Flow,
    UniformGaussianBase,
    flow_log_prob,
    frozen,
    is_stochastic,
    log_q_noise,
)
from fab_tpu_torch.flows.coupling import AffineCoupling
from fab_tpu_torch.flows.defensive import DefensiveMixture
from fab_tpu_torch.flows.factory import (
    data_dependent_init,
    make_realnvp,
    make_resampled_realnvp,
)
from fab_tpu_torch.flows.fused import FusedRealNVPFlow
from fab_tpu_torch.flows.large_coupling import LargeFusedCoupling
from fab_tpu_torch.flows.linear import ActNorm, LULinear
from fab_tpu_torch.flows.resampled import ResampledGaussianBase
from fab_tpu_torch.flows.snf import MetropolisSamplingLayer, StochasticFlow, make_snf_model
from fab_tpu_torch.flows.splines import PeriodicShift, SplineCoupling

__all__ = [
    "ActNorm",
    "AffineCoupling",
    "Bijector",
    "DefensiveMixture",
    "DiagGaussianBase",
    "Flow",
    "FusedRealNVPFlow",
    "LULinear",
    "LargeFusedCoupling",
    "MaskedAffineAutoregressive",
    "MetropolisSamplingLayer",
    "PeriodicShift",
    "Permutation",
    "ResampledGaussianBase",
    "SplineCoupling",
    "StochasticFlow",
    "UniformGaussianBase",
    "data_dependent_init",
    "flow_log_prob",
    "frozen",
    "is_stochastic",
    "log_q_noise",
    "make_masked_affine_maf",
    "make_realnvp",
    "make_resampled_realnvp",
    "make_snf_model",
]
