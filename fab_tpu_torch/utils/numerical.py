"""Masked importance-weight estimators (``fab_tpu/utils/numerical.py:20-64``).

Invalid rows are excluded from every reduction instead of being dropped, so shapes
stay static.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def masked_log_weights(log_w: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Set log-weights of invalid rows to -inf so they vanish under softmax."""
    if mask is None:
        return log_w
    return torch.where(mask, log_w, -math.inf)


def _count(log_w: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return log_w.shape[0]
    return mask.sum().clamp(min=1)


def effective_sample_size(
    log_w: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Normalised ESS ``1 / (N * sum(w_bar**2))`` over valid rows."""
    assert log_w.dim() == 1
    w_bar = torch.softmax(masked_log_weights(log_w, mask), dim=0)
    return 1.0 / (w_bar**2).sum() / _count(log_w, mask)


def log_z_estimate(log_w: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``logsumexp(log_w) - log N`` over valid rows."""
    n = _count(log_w, mask)
    log_n = math.log(n) if mask is None else torch.log(n.to(log_w.dtype))
    return torch.logsumexp(masked_log_weights(log_w, mask), dim=0) - log_n
