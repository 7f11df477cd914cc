"""GMM-40 experiment entry point (``experiments/run_gmm.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.run_gmm --config experiments/configs/gmm.yaml \
        [--device cpu] [training.seed=1 fab.loss_type=flow_reverse_kl ...]

The target is always the seed-0 mixture (``training.seed`` seeds the run only), its
true expectation a Monte Carlo estimate from ``target.true_expectation_n_samples``
exact samples (1e7 by default). No plots: the plotter is not ported yet.
"""
from __future__ import annotations

import argparse

import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.setup_run import setup_trainer_and_run_flow
from fab_tpu_torch.targets import GMM
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


def main(argv=None):
    cfg, device = parse_args(argv, "experiments/configs/gmm.yaml")
    dtype = maybe_enable_x64(cfg)
    target = GMM(
        dim=cfg.target.dim,
        n_mixes=cfg.target.n_mixes,
        loc_scaling=cfg.target.loc_scaling,
        log_var_scaling=cfg.target.log_var_scaling,
        seed=0,
        true_expectation_estimation_n_samples=int(
            cfg.target.get("true_expectation_n_samples", 1e7)
        ),
        expectation_generator=torch.Generator(device=device).manual_seed(0),
        dtype=dtype,
        device=device,
    )
    return setup_trainer_and_run_flow(cfg, target, plotter=None, device=device)


if __name__ == "__main__":
    main()
