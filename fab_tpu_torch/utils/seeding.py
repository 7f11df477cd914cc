"""The fixed-seed problem constants of the GMM-40 target and the quadratic test
function (``fab_tpu/utils/seeding.py``).

Both are the draws of PyTorch's CPU generator at a fixed seed, in the order the
original FAB code makes them, so that the expectation bias and the test-set metrics
are comparable across packages. They are kept as float64 numpy arrays and moved to
the caller's device and dtype where they are used.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=None)
def gmm_mean_draws(n_mixes: int, dim: int, seed: int) -> np.ndarray:
    """The uniform(-1, 1) draws of the GMM component means at a torch seed, before
    the ``loc_scaling`` factor: ``(rand - 0.5) * 2`` in float32, as float64."""
    gen = torch.Generator().manual_seed(seed)
    draws = (torch.rand((n_mixes, dim), generator=gen) - 0.5) * 2
    return draws.numpy().astype(np.float64)


@lru_cache(maxsize=None)
def quadratic_constants(dim: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x_shift, A, b) of the quadratic test function, drawn in this order:
    x_shift = 2 randn(dim), A = 2 rand(dim, dim), b = rand(dim)."""
    gen = torch.Generator().manual_seed(seed)
    x_shift = 2 * torch.randn(dim, generator=gen)
    a_mat = 2 * torch.rand((dim, dim), generator=gen)
    b_vec = torch.rand(dim, generator=gen)
    return tuple(t.numpy().astype(np.float64) for t in (x_shift, a_mat, b_vec))
