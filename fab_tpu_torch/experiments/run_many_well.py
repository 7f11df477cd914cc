"""Many-Well experiment entry point (``experiments/run_many_well.py`` of the
repository).

    python3 -m fab_tpu_torch.experiments.run_many_well \
        --config experiments/configs/many_well.yaml [--device cpu] [target.dim=6 ...]

The flow is the plain RealNVP that ``setup_run`` builds (as ``fab_tpu``'s runner
does, no fused flow). ``evaluation.n_plots`` times in a run, the first two wells'
coordinate pairs of flow and AIS samples are drawn over a well's contours, when
matplotlib is installed (else ``plots off: matplotlib is not installed``).
"""
from __future__ import annotations

from fab_tpu_torch.experiments.run_gmm import flow_and_ais_samples, parse_args
from fab_tpu_torch.experiments.setup_run import setup_trainer_and_run_flow
from fab_tpu_torch.parallel import distributed
from fab_tpu_torch.targets import ManyWellEnergy
from fab_tpu_torch.utils.plotting import (
    plot_contours,
    plot_marginal_pair,
    pyplot,
    when_plots_available,
)


def make_plotter(target: ManyWellEnergy):
    """Per-well marginal-pair scatter of flow and AIS samples over the 2-D well's
    contours, for the first (up to) two wells."""

    def plot(model, transition_state, generator):
        plt = pyplot()
        plot_bound = 3.0
        bounds = (-plot_bound, plot_bound)
        n_rows = min(target.n_wells, 2)
        fig, axs = plt.subplots(n_rows, 2, figsize=(8, 3 * n_rows), sharex=True,
                                sharey=True, squeeze=False)
        x_flow, x_ais = flow_and_ais_samples(model, transition_state, generator, 300)
        for i in range(n_rows):
            for col, samples in enumerate([x_flow, x_ais]):
                if samples is None:
                    continue
                plot_contours(target.log_prob_2d, ax=axs[i, col], bounds=bounds,
                              n_contour_levels=20, grid_width_n_points=50,
                              device=target.device)
                plot_marginal_pair(samples, ax=axs[i, col], bounds=bounds,
                                   marginal_dims=(i * 2, i * 2 + 1))
            axs[i, 0].set_ylabel(f"dims {i*2},{i*2+1}")
        axs[0, 0].set_title("flow samples")
        axs[0, 1].set_title("AIS samples")
        plt.tight_layout()
        return [fig]

    return plot


def main(argv=None):
    cfg, device = parse_args(argv, "experiments/configs/many_well.yaml")
    target = ManyWellEnergy(dim=cfg.target.dim, device=device)
    plotter = when_plots_available(lambda: make_plotter(target))
    return setup_trainer_and_run_flow(cfg, target, plotter=plotter, device=device)


if __name__ == "__main__":
    main()
    distributed.shutdown()
