"""GMM-40 experiment entry point (``experiments/run_gmm.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.run_gmm --config experiments/configs/gmm.yaml \
        [--device cpu] [training.seed=1 fab.loss_type=flow_reverse_kl ...]

The target is always the seed-0 mixture (``training.seed`` seeds the run only), its
true expectation a Monte Carlo estimate from ``target.true_expectation_n_samples``
exact samples (1e7 by default). ``evaluation.n_plots`` times in a run, the flow's
and the AIS chain's samples are drawn over the target's contours into
``<save_path>/plots/`` when matplotlib is installed; without it the runner prints
``plots off: matplotlib is not installed`` and trains all the same.
"""
from __future__ import annotations

import argparse

import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.setup_run import setup_trainer_and_run_flow
from fab_tpu_torch.parallel import distributed
from fab_tpu_torch.targets import GMM
from fab_tpu_torch.utils.plotting import (
    plot_contours,
    plot_marginal_pair,
    pyplot,
    when_plots_available,
)
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64


def parse_args(argv, default_config: str):
    """--config, --device (default cuda: no silent CPU) and dotted overrides."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=default_config)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    return cfg, resolve_device(args.device)


def flow_and_ais_samples(model, transition_state, generator, n: int):
    """n flow samples and, if the model has AIS, the x of n AIS samples (None
    otherwise), for a plot."""
    with torch.no_grad():
        x_flow = model.flow.sample(n, generator)
    x_ais = None
    if model.ais is not None:
        result = model.ais.sample_and_log_weights(transition_state, generator, n,
                                                  p_target=False, tune=False)
        x_ais = result.point.x
    return x_flow, x_ais


def make_plotter(target: GMM, plot_bound: float):
    """Flow samples and AIS samples over the mixture's contours, side by side."""

    def plot(model, transition_state, generator):
        plt = pyplot()
        fig, axs = plt.subplots(1, 2, figsize=(8, 4))
        bounds = (-plot_bound, plot_bound)
        x_flow, x_ais = flow_and_ais_samples(model, transition_state, generator, 300)
        for ax, samples, title in ((axs[0], x_flow, "flow samples"),
                                   (axs[1], x_ais, "AIS samples")):
            if samples is None:
                continue
            plot_contours(target.log_prob, ax=ax, bounds=bounds, n_contour_levels=50,
                          grid_width_n_points=100, device=target.device)
            plot_marginal_pair(samples, ax=ax, bounds=bounds)
            ax.set_title(title)
        plt.tight_layout()
        return [fig]

    return plot


def make_target(cfg, device) -> GMM:
    """The config's seed-0 mixture, in its dtype on ``device``."""
    return GMM(
        dim=cfg.target.dim,
        n_mixes=cfg.target.n_mixes,
        loc_scaling=cfg.target.loc_scaling,
        log_var_scaling=cfg.target.log_var_scaling,
        seed=0,
        true_expectation_estimation_n_samples=int(
            cfg.target.get("true_expectation_n_samples", 1e7)
        ),
        expectation_generator=torch.Generator(device=device).manual_seed(0),
        dtype=maybe_enable_x64(cfg),
        device=device,
    )


def main(argv=None):
    cfg, device = parse_args(argv, "experiments/configs/gmm.yaml")
    target = make_target(cfg, device)
    plotter = when_plots_available(
        lambda: make_plotter(target, plot_bound=cfg.target.loc_scaling * 1.4))
    return setup_trainer_and_run_flow(cfg, target, plotter=plotter, device=device)


if __name__ == "__main__":
    main()
    distributed.shutdown()
