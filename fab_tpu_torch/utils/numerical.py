"""Masked importance-weight estimators and the expectation test function
(``fab_tpu/utils/numerical.py``).

Invalid rows are excluded from every reduction instead of being dropped, so shapes
stay static. Under a data mesh (``fab_tpu_torch/parallel/mesh.py``) ``log_w``,
``mask`` and ``x`` are this rank's rows and every estimate is over the global batch,
the same on every rank: a max and a sum all-reduce each.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.utils.seeding import quadratic_constants


def masked_log_weights(log_w: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Set log-weights of invalid rows to -inf so they vanish under softmax."""
    if mask is None:
        return log_w
    return torch.where(mask, log_w, -math.inf)


def _count(log_w: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return log_w.shape[0]
    return mask.sum().clamp(min=1)


def _global_weight_sums(log_w: torch.Tensor, mask: Optional[torch.Tensor]):
    """(max, sum of w, sum of w**2, valid rows) over the global batch, with w the
    weights scaled by exp(-max): a max and one sum all-reduce."""
    lw = masked_log_weights(log_w, mask)
    m = mesh.max_all(lw)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(lw - m)
    count = lw.new_tensor(lw.shape[0]) if mask is None else mask.sum().to(lw.dtype)
    s1, s2, n = mesh.all_reduce(torch.stack([w.sum(), (w * w).sum(), count]))
    return m, s1, s2, n.clamp(min=1)


def effective_sample_size(
    log_w: torch.Tensor, mask: Optional[torch.Tensor] = None, normalised: bool = False
) -> torch.Tensor:
    """Normalised ESS ``1 / (N * sum(w_bar**2))`` over valid rows.

    With ``normalised`` the input is taken as the normalised weights ``w_bar``
    themselves, as ``fab_tpu``'s branch does: a row the mask drops is still set to
    -inf there, so with a mask that drops a row the ESS is 0."""
    assert log_w.dim() == 1
    if normalised:
        w_bar = masked_log_weights(log_w, mask)
        n = log_w.new_tensor(log_w.shape[0]) if mask is None else mask.sum().to(log_w.dtype)
        s2 = (w_bar**2).sum()
        if mesh.active_mesh() is not None:
            s2, n = mesh.all_reduce(torch.stack([s2, n]))
        return 1.0 / s2 / n.clamp(min=1)
    if mesh.active_mesh() is not None:
        _, s1, s2, n = _global_weight_sums(log_w, mask)
        return s1 * s1 / s2 / n
    w_bar = torch.softmax(masked_log_weights(log_w, mask), dim=0)
    return 1.0 / (w_bar**2).sum() / _count(log_w, mask)


def effective_sample_size_over_p(
    log_w: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """ESS estimated from target samples, ``1 / mean(exp(log_w))`` over valid rows;
    needs a normalised target log-prob."""
    assert log_w.dim() == 1
    if mesh.active_mesh() is not None:
        if mask is None:
            mask = torch.ones_like(log_w, dtype=torch.bool)
        return 1.0 / mesh.masked_mean(torch.exp(log_w), mask)
    if mask is None:
        return 1.0 / torch.exp(log_w).mean()
    return 1.0 / (torch.where(mask, torch.exp(log_w), 0.0).sum() / _count(log_w, mask))


def log_z_estimate(log_w: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``logsumexp(log_w) - log N`` over valid rows."""
    if mesh.active_mesh() is not None:
        m, s1, _, n = _global_weight_sums(log_w, mask)
        return torch.log(s1) + m - torch.log(n)
    n = _count(log_w, mask)
    log_n = math.log(n) if mask is None else torch.log(n.to(log_w.dtype))
    return torch.logsumexp(masked_log_weights(log_w, mask), dim=0) - log_n


def importance_weighted_expectation(
    f: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    log_w: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-normalised importance-sampling estimate of E_p[f(x)] over valid rows."""
    w_bar = mesh.softmax(masked_log_weights(log_w, mask))
    f_x = f(x)
    if mask is not None:
        f_x = torch.where(mask, f_x, 0.0)
    total = (w_bar * f_x).sum(0)
    return total if mesh.active_mesh() is None else mesh.all_reduce(total)


def mc_estimate_true_expectation(
    sample_fn: Callable[[torch.Generator, int], torch.Tensor],
    expectation_function: Callable[[torch.Tensor], torch.Tensor],
    n_samples: int,
    generator: torch.Generator,
    batch_size: int = 100_000,
) -> torch.Tensor:
    """Plain Monte Carlo estimate of E[f(x)] from exact samples, drawn in chunks of
    ``batch_size`` (``max(n_samples // batch_size, 1)`` of them) so that a large
    ``n_samples`` never sits on the device at once."""
    n_batches = max(n_samples // batch_size, 1)
    total = None
    for _ in range(n_batches):
        part = expectation_function(sample_fn(generator, batch_size)).sum()
        total = part if total is None else total + part
    return total / (n_batches * batch_size)


def quadratic_function(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The fixed-seed quadratic test function of the expectation-bias metrics:
    (x + s)^T A (x + s) + b^T (x + s), with the constants of ``utils/seeding.py``."""
    x_shift, a_mat, b_vec = (
        torch.as_tensor(a, dtype=x.dtype, device=x.device)
        for a in quadratic_constants(x.shape[-1], seed)
    )
    x = x + x_shift
    return torch.einsum("...i,ij,...j->...", x, a_mat, x) + torch.einsum("j,...j->...", b_vec, x)
