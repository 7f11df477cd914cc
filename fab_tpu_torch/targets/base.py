"""Target-distribution interface (``fab_tpu/targets/base.py``): an unnormalised
``log_prob``, exact ``sample`` where available, and the problem's
``performance_metrics``."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


class TargetDistribution:
    dim: int

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Unnormalised target log-density, batched: [B, D] -> [B]."""
        raise NotImplementedError

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Exact samples, where available."""
        raise NotImplementedError

    def performance_metrics(
        self,
        samples: torch.Tensor,
        log_w: torch.Tensor,
        log_q_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        batch_size: Optional[int] = None,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Problem-specific eval metrics."""
        raise NotImplementedError
