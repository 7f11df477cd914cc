"""Every marginal pair of a ManyWell flow checkpoint
(``experiments/visualise_marginal_pairs.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.visualise_marginal_pairs \
        --config experiments/configs/many_well.yaml --checkpoint <run dir or state.pkl> \
        [--n-samples 500] [--max-wells 8] [--out many_well_marginal_pairs.png]
        [--device cpu] [overrides ...]

An (n_wells x n_wells) grid whose cell (i, j) scatters flow samples of dimensions
(2i, 2j + 1) over one well's contours. The figure is the only output, so without
matplotlib the script raises ImportError naming it, before it loads anything.
"""
from __future__ import annotations

import argparse

import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.load_model_for_eval import load_model
from fab_tpu_torch.experiments.setup_run import setup_precision
from fab_tpu_torch.targets import ManyWellEnergy
from fab_tpu_torch.utils.plotting import plot_contours, plot_marginal_pair, pyplot
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="experiments/configs/many_well.yaml")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--n-samples", type=int, default=500)
    parser.add_argument("--max-wells", type=int, default=8,
                        help="cap the grid size for very high-dim targets")
    parser.add_argument("--out", default="many_well_marginal_pairs.png")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    plt = pyplot()  # the figure is the output: no matplotlib, no run

    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    setup_precision(cfg)
    target = ManyWellEnergy(dim=cfg.target.dim, device=device)
    model, _ = load_model(cfg, target, args.checkpoint, maybe_enable_x64(cfg), device)
    with torch.no_grad():
        x = model.flow.sample(args.n_samples, torch.Generator(device=device).manual_seed(0))

    n = min(target.n_wells, args.max_wells)
    plot_bound = 3.0
    fig, axs = plt.subplots(n, n, figsize=(2 * n, 2 * n), sharex=True, sharey=True,
                            squeeze=False)
    for i in range(n):
        for j in range(n):
            ax = axs[i, j]
            dims = (2 * i, 2 * j + 1)
            plot_contours(target.log_prob_2d, bounds=(-plot_bound, plot_bound), ax=ax,
                          n_contour_levels=20, grid_width_n_points=40, device=device)
            plot_marginal_pair(x, ax=ax, bounds=(-plot_bound, plot_bound),
                               marginal_dims=dims, alpha=0.2)
            if i == n - 1:
                ax.set_xlabel(f"$x_{{{dims[0] + 1}}}$")
            if j == 0:
                ax.set_ylabel(f"$x_{{{dims[1] + 1}}}$")
    plt.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
