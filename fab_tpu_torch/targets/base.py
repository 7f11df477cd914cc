"""Target-distribution interface (``fab_tpu/targets/base.py``)."""
from __future__ import annotations

import torch


class TargetDistribution:
    dim: int

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Unnormalised target log-density, batched: [B, D] -> [B]."""
        raise NotImplementedError
