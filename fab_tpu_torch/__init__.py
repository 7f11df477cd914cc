"""fab_tpu_torch: the PyTorch / CUDA port of fab_tpu for NVIDIA Hopper.

Module names mirror ``fab_tpu``. The package imports ``torch`` and never JAX or
``fab_tpu``. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from fab_tpu_torch.targets.double_well import DoubleWellEnergy
from fab_tpu_torch.targets.lgcp import LogGaussianCoxProcess
from fab_tpu_torch.targets.many_well import ManyWellEnergy

__all__ = ["DoubleWellEnergy", "LogGaussianCoxProcess", "ManyWellEnergy"]
