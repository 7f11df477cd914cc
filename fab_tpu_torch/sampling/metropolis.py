"""Masked mean shared by the transition kernels (``fab_tpu/sampling/metropolis.py:24``).

The Metropolis kernel itself is not ported yet.
"""
from __future__ import annotations

import torch


def masked_mean(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, vals, 0.0).sum() / mask.sum().clamp(min=1)
