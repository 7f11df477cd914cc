"""Plotting helpers (``fab_tpu/utils/plotting.py``): training curves, the contours
of a log-prob function and a scatter of a pair of marginals.

``matplotlib`` is imported when a plot is made, not with this module: a machine
without it can run everything else. ``pyplot()`` raises ``ImportError`` naming
matplotlib; ``plots_available()`` says whether it imports, and
``when_plots_available(make)`` is the runners' switch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

PLOTS_OFF = "plots off: matplotlib is not installed"


def plots_available() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def when_plots_available(make):
    """``make()`` if matplotlib imports; else None, after printing PLOTS_OFF. For a
    runner: a plot is output, not compute, so a run goes on without it."""
    if plots_available():
        return make()
    print(PLOTS_OFF)
    return None


def pyplot():
    """``matplotlib.pyplot`` on the non-interactive Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_history(history) -> None:
    """One training curve per key, stacked."""
    plt = pyplot()
    _, axs = plt.subplots(len(history), 1, figsize=(7, 3 * len(history)))
    if len(history) == 1:
        axs = [axs]
    for i, key in enumerate(history):
        axs[i].plot(history[key])
        axs[i].set_title(key)
    plt.tight_layout()


def plot_contours(
    log_prob_func,
    ax=None,
    bounds: Tuple[float, float] = (-5.0, 5.0),
    grid_width_n_points: int = 20,
    n_contour_levels: Optional[int] = None,
    log_prob_min: float = -1000.0,
    device="cpu",
    dtype=torch.float32,
):
    """Contours of a torch log-prob function over a square grid (a ``dtype`` tensor
    on ``device``), clipped below at ``log_prob_min``."""
    plt = pyplot()
    if ax is None:
        _, ax = plt.subplots(1)
    pts_1d = np.linspace(bounds[0], bounds[1], grid_width_n_points)
    xx, yy = np.meshgrid(pts_1d, pts_1d)
    grid = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], axis=-1), dtype=dtype,
                           device=device)
    with torch.no_grad():
        log_p = log_prob_func(grid).cpu().numpy()
    log_p = np.clip(log_p, log_prob_min, None).reshape(
        grid_width_n_points, grid_width_n_points
    )
    if n_contour_levels:
        ax.contour(xx, yy, log_p, levels=n_contour_levels)
    else:
        ax.contour(xx, yy, log_p)
    return ax


def plot_marginal_pair(
    samples,
    ax=None,
    marginal_dims: Tuple[int, int] = (0, 1),
    bounds: Tuple[float, float] = (-5.0, 5.0),
    alpha: float = 0.5,
):
    """Scatter of two coordinates of ``samples`` (a tensor or an array), clipped to
    ``bounds``."""
    plt = pyplot()
    if ax is None:
        _, ax = plt.subplots(1)
    if torch.is_tensor(samples):
        samples = samples.detach().cpu().numpy()
    samples = np.clip(np.asarray(samples), bounds[0], bounds[1])
    ax.plot(samples[:, marginal_dims[0]], samples[:, marginal_dims[1]], "o", alpha=alpha)
    return ax
