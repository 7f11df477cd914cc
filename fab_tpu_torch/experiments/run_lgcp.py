"""Log-Gaussian Cox process experiment entry point (``experiments/run_lgcp.py`` of
the repository).

    python3 -m fab_tpu_torch.experiments.run_lgcp --config experiments/configs/lgcp.yaml \
        [--device cpu] [flow.fused_coupling=true ...]

With ``flow.fused_coupling=true`` every coupling runs through K2; with
``target.in_graph_kernel=true`` the target builds chol(K) from its float32 grid
coordinates in the run's dtype (``targets/lgcp.py``).
"""
from __future__ import annotations

from fab_tpu_torch.experiments.run_gmm import parse_args
from fab_tpu_torch.experiments.setup_run import setup_trainer_and_run_flow
from fab_tpu_torch.parallel import distributed
from fab_tpu_torch.targets import LogGaussianCoxProcess
from fab_tpu_torch.utils.training import maybe_enable_x64


def main(argv=None):
    cfg, device = parse_args(argv, "experiments/configs/lgcp.yaml")
    target = LogGaussianCoxProcess(grid_size=cfg.target.grid_size,
                                   in_graph_kernel=bool(cfg.target.get("in_graph_kernel", False)),
                                   dtype=maybe_enable_x64(cfg), device=device)
    if target.dim != cfg.target.dim:
        raise ValueError(f"target.dim={cfg.target.dim} but the grid gives {target.dim}")
    return setup_trainer_and_run_flow(cfg, target, plotter=None, device=device)


if __name__ == "__main__":
    main()
    distributed.shutdown()
