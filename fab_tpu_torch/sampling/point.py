"""Point construction and annealed intermediate densities (``fab_tpu/sampling/point.py``).

The intermediate density is the general-alpha form
``log pi_beta = ((1-beta) + beta(1-alpha)) log q + beta * alpha * log p``; alpha=1
gives the plain AIS target p. Every Point is detached: the AIS chain is never
backpropagated through.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from fab_tpu_torch import random
from fab_tpu_torch.typing import LogProbFn, Point


def batched_value_and_grad(
    f: LogProbFn, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row value and x-gradient of a batched scalar-per-row function."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        vals = f(x)
        (grads,) = torch.autograd.grad(vals, x, torch.ones_like(vals))
    return vals.detach(), grads


def create_point(
    x: torch.Tensor,
    log_q_fn: LogProbFn,
    log_p_fn: LogProbFn,
    with_grad: bool,
    log_q_x: Optional[torch.Tensor] = None,
) -> Point:
    """A Point with cached log-probs (and their x-gradients if ``with_grad``)."""
    x = x.detach()
    if with_grad:
        log_q, grad_log_q = batched_value_and_grad(log_q_fn, x)
        log_p, grad_log_p = batched_value_and_grad(log_p_fn, x)
        return Point(x, log_q, log_p, grad_log_q, grad_log_p)
    with torch.no_grad():
        log_q = log_q_x if log_q_x is not None else log_q_fn(x)
        return Point(x, log_q.detach(), log_p_fn(x))


def intermediate_coefficients(beta, ais_alpha: float):
    """(coef_log_q, coef_log_p) of the annealed density at inverse temperature beta."""
    return (1.0 - beta) + beta * (1.0 - ais_alpha), beta * ais_alpha


def intermediate_log_prob(point: Point, beta, ais_alpha: float) -> torch.Tensor:
    c_q, c_p = intermediate_coefficients(beta, ais_alpha)
    return c_q * point.log_q + c_p * point.log_p


def grad_intermediate_log_prob(point: Point, beta, ais_alpha: float) -> torch.Tensor:
    assert point.grad_log_q is not None and point.grad_log_p is not None
    c_q, c_p = intermediate_coefficients(beta, ais_alpha)
    return c_q * point.grad_log_q + c_p * point.grad_log_p


def resample(generator: torch.Generator, point: Point, log_w: torch.Tensor) -> Point:
    """Multinomial resampling of the rows by log-weight (with replacement)."""
    indices = random.categorical(generator, log_w, log_w.shape[0])
    return Point(*(None if a is None else a[indices] for a in point))
