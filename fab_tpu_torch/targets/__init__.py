from fab_tpu_torch.targets.double_well import DoubleWellEnergy
from fab_tpu_torch.targets.gaussian import Gaussian
from fab_tpu_torch.targets.gmm import GMM
from fab_tpu_torch.targets.lgcp import LogGaussianCoxProcess
from fab_tpu_torch.targets.many_well import ManyWellEnergy

__all__ = ["DoubleWellEnergy", "GMM", "Gaussian", "LogGaussianCoxProcess", "ManyWellEnergy"]
