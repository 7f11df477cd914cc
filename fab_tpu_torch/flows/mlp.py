"""Minimal MLP used by coupling-layer conditioners (``fab_tpu/flows/mlp.py``).

Weights are row-major [in, out], as in ``fab_tpu``, so parameters convert one to one
and the fused kernel reads them as they are.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn


class Dense(nn.Module):
    """y = x @ w + b with w [d_in, d_out]."""

    def __init__(self, d_in: int, d_out: int, dtype=torch.float32, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((d_in, d_out), dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros((d_out,), dtype=dtype, device=device))


def mlp_init(
    sizes: Sequence[int],
    generator: torch.Generator,
    zero_init_last: bool = True,
    dtype=torch.float32,
    device=None,
    init_mode: str = "he_normal",
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Initial (w, b) per layer; the last layer is zero if ``zero_init_last``.

    ``init_mode``:
      - ``"he_normal"``: w ~ N(0, 2/fan_in), b = 0.
      - ``"torch"``: torch.nn.Linear's defaults, w and b ~ U(-1/sqrt(fan_in),
        1/sqrt(fan_in)).
    """
    if init_mode not in ("he_normal", "torch"):
        raise ValueError(f"unknown init_mode {init_mode!r}")
    out = []
    for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        w = torch.zeros((d_in, d_out), dtype=dtype, device=device)
        b = torch.zeros((d_out,), dtype=dtype, device=device)
        if last and zero_init_last:
            pass
        elif init_mode == "torch":
            bound = 1.0 / math.sqrt(d_in)
            w.uniform_(-bound, bound, generator=generator)
            b.uniform_(-bound, bound, generator=generator)
        else:
            w.normal_(0.0, math.sqrt(2.0 / d_in), generator=generator)
        out.append((w, b))
    return out


def mlp_apply(layers: Sequence[Dense], x: torch.Tensor) -> torch.Tensor:
    """Forward pass; ReLU between layers, linear output."""
    for i, layer in enumerate(layers):
        x = x @ layer.w + layer.b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x
