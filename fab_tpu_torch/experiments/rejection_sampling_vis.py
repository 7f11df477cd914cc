"""The DoubleWell exact rejection sampler: its envelope and a histogram of its draws
(``experiments/rejection_sampling_vis.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.rejection_sampling_vis [--n-samples 100000]
        [--out rejection_sampling.png] [--device cpu]

Checks that the envelope k q lies above the unnormalised first-dimension density p
on [-4, 4] (log(kq / p) > 0 everywhere), with or without matplotlib. With
matplotlib, plots p, the envelope and a histogram of ``--n-samples`` rejection
draws into ``--out``; without it, prints ``plots off: matplotlib is not installed``.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.targets.double_well import DW_Z_DIM1, DoubleWellEnergy
from fab_tpu_torch.utils.plotting import PLOTS_OFF, plots_available, pyplot


def envelope_gap(dw: DoubleWellEnergy, xs: torch.Tensor):
    """(log p, log(k q), log(k q) - log p) along dimension 1 at ``xs``, k = 3 Z."""
    log_p = -dw.energy_dim_1(xs)  # = -x^4 + 6x^2 + 0.5x for the canonical constants
    log_kq = math.log(DW_Z_DIM1 * 3) + dw._proposal_log_prob(xs)
    return log_p, log_kq, log_kq - log_p


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-samples", type=int, default=100_000)
    parser.add_argument("--out", default="rejection_sampling.png")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    dw = DoubleWellEnergy()
    xs = torch.linspace(-4.0, 4.0, 1000, device=device)
    log_p, log_kq, gap = (t.cpu().numpy() for t in envelope_gap(dw, xs))
    assert gap.min() > 0, f"envelope violated: min log(kq/p) = {gap.min():.4f}"
    x_min = float(xs[int(gap.argmin())])
    print(f"envelope OK: min log(kq/p) = {gap.min():.4f} at x = {x_min:.3f}")

    x1 = dw.sample_first_dimension(torch.Generator(device=device).manual_seed(0),
                                   args.n_samples, device=device).cpu().numpy()
    out = {"min_log_gap": float(gap.min()), "x_at_min": x_min, "n_samples": len(x1)}
    if not plots_available():
        print(PLOTS_OFF)
        return out
    plt = pyplot()
    xs = xs.cpu().numpy()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(x1, bins=200, density=True, alpha=0.4, label="rejection samples")
    ax.plot(xs, np.exp(log_p) / DW_Z_DIM1, label="p(x1) (normalised)")
    ax.plot(xs, np.exp(log_kq) / DW_Z_DIM1, "--", label="k q(x1) envelope / Z")
    ax.legend()
    ax.set_xlabel("$x_1$")
    plt.tight_layout()
    fig.savefig(args.out, dpi=150)
    plt.close(fig)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
