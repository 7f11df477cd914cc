from fab_tpu_torch.sampling.ais import AISResult, AnnealedImportanceSampler
from fab_tpu_torch.sampling.hmc import HamiltonianMonteCarlo
from fab_tpu_torch.sampling.metropolis import Metropolis
from fab_tpu_torch.sampling.point import (
    create_point,
    grad_intermediate_log_prob,
    intermediate_log_prob,
    resample,
)
from fab_tpu_torch.sampling.schedules import beta_schedule

__all__ = [
    "AISResult",
    "AnnealedImportanceSampler",
    "HamiltonianMonteCarlo",
    "Metropolis",
    "beta_schedule",
    "create_point",
    "grad_intermediate_log_prob",
    "intermediate_log_prob",
    "resample",
]
