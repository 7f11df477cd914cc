"""An external ``nn.Module`` as a trainable flow (``fab_tpu/wrappers/flax_module.py``
and ``haiku_module.py``, one seam for both).

The module brings two methods with an explicit generator, as ``fab_tpu``'s flax and
haiku modules take an explicit key:

    def sample_and_log_prob(self, generator, n) -> (x [n, dim], log_q [n])
    def log_prob(self, x [B, dim]) -> [B]

Its parameters are the wrapper's, so they train through the port's trainers. Under a
data mesh it samples at the global ``n`` and keeps this rank's rows, as ``fab_tpu``'s
wrapper constrains its sample; draw its noise through ``fab_tpu_torch.random`` at
the global shape and every rank draws as one process. On a model mesh it stays
replicated (``fab_tpu``'s wrappers shard nothing).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fab_tpu_torch.parallel.mesh import constrain_batch


class WrappedModuleFlow(nn.Module):
    def __init__(self, module: nn.Module, dim: int):
        super().__init__()
        self.module = module
        self.dim = dim

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return (self.dim,)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The module's ``reset_parameters(generator)``, if it has one; otherwise
        its parameters stay as constructed (``fab_tpu`` initialises a flax or haiku
        module from the key)."""
        reset = getattr(self.module, "reset_parameters", None)
        if reset is not None:
            reset(generator)

    def sample_and_log_prob(self, n: int, generator: torch.Generator):
        x, log_q = self.module.sample_and_log_prob(generator, n)
        return constrain_batch(x), constrain_batch(log_q)

    def sample(self, n: int, generator: torch.Generator) -> torch.Tensor:
        return self.sample_and_log_prob(n, generator)[0]

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.module.log_prob(x)
