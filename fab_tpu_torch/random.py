"""The port's random draws, each from an explicit ``torch.Generator``.

Every draw of the main path goes through these three functions, so a test can
replace them to replay noise drawn elsewhere (for example by ``fab_tpu``).
"""
from __future__ import annotations

from typing import Sequence

import torch


def normal(generator: torch.Generator, shape: Sequence[int], dtype, device) -> torch.Tensor:
    """Standard normal draws."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)


def exponential(
    generator: torch.Generator, shape: Sequence[int], dtype, device
) -> torch.Tensor:
    """Exp(1) draws."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    return out.exponential_(generator=generator)


def gumbel(generator: torch.Generator, shape: Sequence[int], dtype, device) -> torch.Tensor:
    """Standard Gumbel draws (-log of an Exp(1) draw)."""
    return -torch.log(exponential(generator, shape, dtype, device))
