"""Log-Gaussian Cox process experiment entry point (``experiments/run_lgcp.py`` of
the repository).

    python3 -m fab_tpu_torch.experiments.run_lgcp --config experiments/configs/lgcp.yaml \
        [--device cpu] [flow.fused_coupling=true ...]

With ``flow.fused_coupling=true`` every coupling runs through K2.
"""
from __future__ import annotations

from fab_tpu_torch.experiments.run_gmm import parse_args
from fab_tpu_torch.experiments.setup_run import setup_trainer_and_run_flow
from fab_tpu_torch.parallel import distributed
from fab_tpu_torch.targets import LogGaussianCoxProcess
from fab_tpu_torch.utils.training import maybe_enable_x64


def main(argv=None):
    cfg, device = parse_args(argv, "experiments/configs/lgcp.yaml")
    if cfg.target.get("in_graph_kernel"):
        raise NotImplementedError(
            "target.in_graph_kernel is not ported (ROADMAP Queue 1, item 10: the port "
            "keeps chol(K)^T on the device, built once)"
        )
    target = LogGaussianCoxProcess(grid_size=cfg.target.grid_size,
                                   dtype=maybe_enable_x64(cfg), device=device)
    if target.dim != cfg.target.dim:
        raise ValueError(f"target.dim={cfg.target.dim} but the grid gives {target.dim}")
    return setup_trainer_and_run_flow(cfg, target, plotter=None, device=device)


if __name__ == "__main__":
    main()
    distributed.shutdown()
