"""Rational-quadratic spline couplings, with circular dims (``fab_tpu/flows/splines.py``).

Monotone piecewise rational-quadratic maps on [-B, B] with K bins and identity tails
outside (Durkan et al., Neural Spline Flows, arXiv:1906.04032). A circular dim uses
B = pi and ties its two boundary derivatives, so the map is smooth on the circle.
One call transforms a block that mixes circular and linear dims through per-dim
bounds and masks.

The circular bound is pi in the tensor's own dtype. ``fab_tpu`` builds it as a
float32 pi (``splines.py:264-267``), so in float64 the two packages differ by about
1e-7 on the circular dims.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fab_tpu_torch.flows.base import Bijector
from fab_tpu_torch.flows.mlp import Dense, mlp_apply, mlp_init, shard_mlp

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3
# Offset so that a raw derivative of 0 gives derivative 1: a zero-initialised
# conditioner starts at (close to) the identity map.
DERIV_OFFSET = math.log(math.expm1(1.0 - DEFAULT_MIN_DERIVATIVE))
# The tail bound of a circular dim.
CIRCULAR_BOUND = math.pi


def _normalise_bins(raw: torch.Tensor, total, min_size: float) -> torch.Tensor:
    """Softmax bin sizes with a minimum, summing to ``total``."""
    k = raw.shape[-1]
    probs = torch.softmax(raw, dim=-1)
    return (min_size + (1 - min_size * k) * probs) * total


def _knots(sizes: torch.Tensor, bk) -> torch.Tensor:
    """[..., K+1] knot positions from -bk by cumulative bin sizes."""
    inner = torch.cumsum(sizes, dim=-1) - bk
    return torch.cat([torch.zeros_like(inner[..., :1]) - bk, inner], dim=-1)


def rational_quadratic_spline(
    x: torch.Tensor,
    raw_widths: torch.Tensor,
    raw_heights: torch.Tensor,
    raw_derivs: torch.Tensor,
    inverse: bool,
    tail_bound,
    circular=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise monotone RQ spline on [-B, B] (``fab_tpu/flows/splines.py:41-164``).

    x: [...]; raw_widths/raw_heights: [..., K]. With ``circular=False`` every dim
    is linear: raw_derivs [..., K-1] (boundary derivatives 1) and a scalar
    ``tail_bound``. Otherwise ``circular`` is a bool tensor and ``tail_bound`` a
    tensor, both broadcastable against x, and raw_derivs [..., K]: a circular dim
    ties both boundary derivatives to raw_derivs[..., 0], a linear one uses the
    first K-1. Returns (y, log|dy/dx|), identity outside [-B, B].
    """
    k = raw_widths.shape[-1]
    if isinstance(tail_bound, (int, float)):
        b = bk = float(tail_bound)
    else:
        b = tail_bound.to(raw_widths.dtype)
        bk = b[..., None]

    widths = _normalise_bins(raw_widths, 2 * bk, DEFAULT_MIN_BIN_WIDTH)
    heights = _normalise_bins(raw_heights, 2 * bk, DEFAULT_MIN_BIN_HEIGHT)
    x_knots = _knots(widths, bk)
    y_knots = _knots(heights, bk)

    # softplus as log(1 + e^x) everywhere (jax.nn.softplus), without torch's
    # linear cut-over above 20.
    d_raw = DEFAULT_MIN_DERIVATIVE + torch.logaddexp(
        raw_derivs + DERIV_OFFSET, raw_derivs.new_zeros(())
    )
    if circular is False:
        ones = torch.ones_like(d_raw[..., :1])
        derivs = torch.cat([ones, d_raw, ones], dim=-1)  # [..., K+1]
    else:
        # Mixed block: circular dims use all K (tied ends), linear dims the first
        # K-1 as interior with unit boundaries.
        circ_d = torch.cat([d_raw, d_raw[..., :1]], dim=-1)
        ones = torch.ones_like(d_raw[..., :1])
        lin_d = torch.cat([ones, d_raw[..., : k - 1], ones], dim=-1)
        derivs = torch.where(circular[..., None], circ_d, lin_d)

    inside = (x >= -b) & (x <= b)
    x_safe = torch.clamp(x, -b, b)

    # The bin of each input: how many left knots lie at or below it.
    knots = y_knots if inverse else x_knots
    idx = ((x_safe[..., None] >= knots[..., :-1]).sum(-1) - 1).clamp(0, k - 1)
    onehot = (torch.arange(k, device=x.device) == idx[..., None]).to(x_safe.dtype)

    def take(a):
        return (a * onehot).sum(-1)

    xk = take(x_knots[..., :-1])
    yk = take(y_knots[..., :-1])
    wk = take(widths)
    hk = take(heights)
    dk = take(derivs[..., :-1])
    dk1 = take(derivs[..., 1:])
    sk = hk / wk

    if not inverse:
        theta = (x_safe - xk) / wk
        t1m = theta * (1 - theta)
        numer = hk * (sk * theta**2 + dk * t1m)
        denom = sk + (dk1 + dk - 2 * sk) * t1m
        y = yk + numer / denom
        deriv_num = sk**2 * (dk1 * theta**2 + 2 * sk * t1m + dk * (1 - theta) ** 2)
        log_det = torch.log(deriv_num) - 2 * torch.log(denom)
        return torch.where(inside, y, x), torch.where(inside, log_det, 0.0)

    # Inverse: the root of the quadratic in theta, in the stable form 2c / (-b - sqrt).
    y_rel = x_safe - yk
    a = hk * (sk - dk) + y_rel * (dk1 + dk - 2 * sk)
    bb = hk * dk - y_rel * (dk1 + dk - 2 * sk)
    c = -sk * y_rel
    disc = torch.clamp(bb**2 - 4 * a * c, min=0.0)
    theta = torch.clamp(2 * c / (-bb - torch.sqrt(disc)), 0.0, 1.0)
    xx = theta * wk + xk
    t1m = theta * (1 - theta)
    denom = sk + (dk1 + dk - 2 * sk) * t1m
    deriv_num = sk**2 * (dk1 * theta**2 + 2 * sk * t1m + dk * (1 - theta) ** 2)
    log_det = -(torch.log(deriv_num) - 2 * torch.log(denom))
    return torch.where(inside, xx, x), torch.where(inside, log_det, 0.0)


class SplineCoupling(Bijector):
    """Coupling layer with an RQ-spline transform of the second block
    (``fab_tpu/flows/splines.py:167-289``).

    The MLP [features, hidden x n_hidden_layers, d_trans * 3K] (zero last layer)
    gives K widths, K heights and K derivatives per transformed dim (a linear dim
    ignores the last derivative). ``circular_mask`` marks circular transformed dims
    (bound pi); ``circular_cond_mask`` marks circular conditioning dims, which enter
    the MLP as sin in place and cos appended, so the conditioner is continuous
    across the +-pi seam.
    """

    def __init__(
        self,
        dim: int,
        hidden_units: int,
        n_bins: int = 8,
        tail_bound: float = 3.0,
        n_hidden_layers: int = 2,
        swap: bool = False,
        circular_mask: Sequence[bool] = (),
        circular_cond_mask: Sequence[bool] = (),
        init_mode: str = "he_normal",
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.dim = dim
        self.n_bins = n_bins
        self.tail_bound = float(tail_bound)
        self.swap = swap
        self.init_mode = init_mode
        d = (dim + 1) // 2
        self.d_cond, self.d_trans = (dim - d, d) if swap else (d, dim - d)
        circ = tuple(bool(c) for c in circular_mask) or (False,) * self.d_trans
        cond = tuple(bool(c) for c in circular_cond_mask)
        if len(circ) != self.d_trans:
            raise ValueError("circular_mask must cover the transformed dims")
        if cond and len(cond) != self.d_cond:
            raise ValueError("circular_cond_mask must cover the conditioning dims")
        self.any_circular = any(circ)
        self.n_cond_circular = sum(cond)
        self.register_buffer("circular", torch.tensor(circ, device=device), persistent=False)
        self._bounds = {}  # (dtype, device) -> per-dim tail bound
        self.register_buffer("cond_circular", torch.tensor(cond or (False,) * self.d_cond,
                                                            device=device), persistent=False)
        self.register_buffer("cond_circular_idx", torch.tensor(
            [j for j, c in enumerate(cond) if c], dtype=torch.long, device=device),
            persistent=False)
        self.sizes = ([self.d_cond + self.n_cond_circular] + [hidden_units] * n_hidden_layers
                      + [self.d_trans * 3 * n_bins])
        self.mlp = nn.ModuleList(
            Dense(i, o, dtype, device) for i, o in zip(self.sizes[:-1], self.sizes[1:])
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        ref = self.mlp[0].w
        values = mlp_init(
            self.sizes, generator, zero_init_last=True, dtype=ref.dtype,
            device=ref.device, init_mode=self.init_mode,
        )
        for layer, (w, b) in zip(self.mlp, values):
            layer.assign(w, b)

    def shard_model_axis(self, mesh, name: str = "spline coupling") -> None:
        """``fab_tpu/flows/splines.py:281-288``: the MLP's column / row split."""
        shard_mlp(self.mlp, self.sizes, mesh, name)

    def _split(self, x: torch.Tensor):
        d = (self.dim + 1) // 2
        if self.swap:
            return x[..., d:], x[..., :d]
        return x[..., :d], x[..., d:]

    def _merge(self, x_cond: torch.Tensor, y_trans: torch.Tensor) -> torch.Tensor:
        if self.swap:
            return torch.cat([y_trans, x_cond], -1)
        return torch.cat([x_cond, y_trans], -1)

    def _cond_features(self, x_cond: torch.Tensor) -> torch.Tensor:
        if not self.n_cond_circular:
            return x_cond
        feats = torch.where(self.cond_circular, torch.sin(x_cond), x_cond)
        return torch.cat([feats, torch.cos(x_cond[..., self.cond_circular_idx])], -1)

    def _transform(self, x: torch.Tensor, inverse: bool):
        x_cond, x_trans = self._split(x)
        h = mlp_apply(self.mlp, self._cond_features(x_cond))
        h = h.reshape(h.shape[:-1] + (self.d_trans, 3 * self.n_bins))
        k = self.n_bins
        rw, rh, rd = h[..., :k], h[..., k : 2 * k], h[..., 2 * k :]
        if not self.any_circular:
            y_trans, ld = rational_quadratic_spline(
                x_trans, rw, rh, rd[..., : k - 1], inverse=inverse,
                tail_bound=self.tail_bound, circular=False,
            )
        else:
            bound = self._bound(x)
            y_trans, ld = rational_quadratic_spline(
                x_trans, rw, rh, rd, inverse=inverse, tail_bound=bound,
                circular=self.circular,
            )
        return self._merge(x_cond, y_trans), ld.sum(-1)

    def _bound(self, x: torch.Tensor) -> torch.Tensor:
        """Per-dim tail bound in x's dtype: pi on circular dims, built once."""
        key = (x.dtype, x.device)
        if key not in self._bounds:
            bound = np.where(self.circular.cpu().numpy(), CIRCULAR_BOUND, self.tail_bound)
            self._bounds[key] = torch.tensor(bound, dtype=x.dtype, device=x.device)
        return self._bounds[key]

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._transform(z, inverse=False)

    def inverse_and_log_det(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._transform(x, inverse=True)


class PeriodicShift(Bijector):
    """A constant shift of the circular dims, wrapped back to [-bound, bound)
    (``bound`` pi by default), with log-det 0 and no parameters
    (``fab_tpu/flows/splines.py:292-327``)."""

    def __init__(self, dim: int, circular_dims: Sequence[int], shift: float,
                 bound: float = math.pi, device=None):
        super().__init__()
        self.dim = dim
        self.circular_dims = tuple(int(i) for i in circular_dims)
        self.shift = float(shift)
        self.bound = float(bound)
        mask = np.zeros(dim, bool)
        mask[list(self.circular_dims)] = True
        self.register_buffer("mask", torch.tensor(mask, device=device), persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass

    def _shift(self, x: torch.Tensor, direction: float) -> torch.Tensor:
        vals = x + direction * self.shift
        wrapped = torch.remainder(vals + self.bound, 2 * self.bound) - self.bound
        return torch.where(self.mask, wrapped, x)

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._shift(z, 1.0), torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)

    def inverse_and_log_det(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._shift(x, -1.0), torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
