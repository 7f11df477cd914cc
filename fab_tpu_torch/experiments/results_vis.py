"""Paper figures: flow (and AIS) samples over the target's contours, one row per
checkpoint (``experiments/results_vis.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.results_vis --config experiments/configs/gmm.yaml \
        --run "FAB w/ buffer=<run dir>" --run "Rev KL=<run dir>" [--n-samples 1000]
        [--ais] [--out results_vis.png] [--device cpu] [overrides ...]

The problem (GMM or ManyWell) is read from the config. A GMM row scatters the flow's
samples (and with ``--ais`` the AIS chain's, targeting p) over the mixture's
contours; a ManyWell row the first three within-well marginal pairs. The figure is
the only output, so without matplotlib the script raises ImportError naming it,
before it loads anything.
"""
from __future__ import annotations

import argparse

import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.evaluate import build_target
from fab_tpu_torch.experiments.load_model_for_eval import load_model
from fab_tpu_torch.experiments.setup_run import setup_precision
from fab_tpu_torch.utils.plotting import plot_contours, plot_marginal_pair, pyplot
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64


def _sample(model, transition_state, generator, n, use_ais):
    with torch.no_grad():
        x_flow = model.flow.sample(n, generator)
    x_ais = None
    if use_ais and model.ais is not None:
        result = model.ais.sample_and_log_weights(transition_state, generator, n,
                                                  p_target=True, tune=False)
        x_ais = result.point.x
    return x_flow, x_ais


def plot_gmm_row(axs, target, x_flow, x_ais, plot_bound):
    for ax, samples, title in zip(axs, (x_flow, x_ais), ("flow", "AIS")):
        if samples is None:
            ax.axis("off")
            continue
        plot_contours(target.log_prob, bounds=(-plot_bound, plot_bound),
                      n_contour_levels=50, grid_width_n_points=200, ax=ax,
                      device=target.device, dtype=target.dtype)
        plot_marginal_pair(samples, ax=ax, bounds=(-plot_bound, plot_bound), alpha=0.3)
        ax.set_title(title)


def plot_many_well_row(axs, target, x_flow, plot_bound=3.0):
    """The first three within-well marginal pairs."""
    for j, ax in enumerate(axs):
        plot_contours(target.log_prob_2d, bounds=(-plot_bound, plot_bound), ax=ax,
                      n_contour_levels=20, grid_width_n_points=100, device=target.device)
        plot_marginal_pair(x_flow, ax=ax, bounds=(-plot_bound, plot_bound),
                           marginal_dims=(2 * j, 2 * j + 1), alpha=0.3)
        ax.set_title(f"$x_{{{2 * j + 1}}}, x_{{{2 * j + 2}}}$")


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--run", action="append", required=True,
                        help="LABEL=CHECKPOINT_DIR (repeatable; one figure row per run)")
    parser.add_argument("--n-samples", type=int, default=1000)
    parser.add_argument("--ais", action="store_true", help="also plot AIS samples")
    parser.add_argument("--out", default="results_vis.png")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    plt = pyplot()  # the figure is the output: no matplotlib, no run

    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    setup_precision(cfg)
    dtype = maybe_enable_x64(cfg)
    problem = "gmm" if "n_mixes" in cfg.target else "many_well"
    target = build_target(cfg, dtype, device)
    runs = [r.split("=", 1) for r in args.run]

    if problem == "gmm":
        n_cols = 2 if args.ais else 1
        plot_bound = cfg.target.loc_scaling * 1.4
    else:
        n_cols = 3
    fig, axs = plt.subplots(len(runs), n_cols, figsize=(4 * n_cols, 4 * len(runs)),
                            squeeze=False)
    for i, (label, ckpt) in enumerate(runs):
        model, transition_state = load_model(cfg, target, ckpt, dtype, device)
        generator = torch.Generator(device=device).manual_seed(0)
        x_flow, x_ais = _sample(model, transition_state, generator, args.n_samples, args.ais)
        if problem == "gmm":
            plot_gmm_row(axs[i], target, x_flow, x_ais, plot_bound)
        else:
            plot_many_well_row(axs[i], target, x_flow)
        axs[i, 0].set_ylabel(label)
    plt.tight_layout()
    fig.savefig(args.out, dpi=150)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
