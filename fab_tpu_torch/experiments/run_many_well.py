"""Many-Well experiment entry point (``experiments/run_many_well.py`` of the
repository).

    python3 -m fab_tpu_torch.experiments.run_many_well \
        --config experiments/configs/many_well.yaml [--device cpu] [target.dim=6 ...]

The flow is the plain RealNVP that ``setup_run`` builds (as ``fab_tpu``'s runner
does, no fused flow). No plots: the plotter is not ported yet.
"""
from __future__ import annotations

from fab_tpu_torch.experiments.run_gmm import parse_args
from fab_tpu_torch.experiments.setup_run import setup_trainer_and_run_flow
from fab_tpu_torch.targets import ManyWellEnergy


def main(argv=None):
    cfg, device = parse_args(argv, "experiments/configs/many_well.yaml")
    target = ManyWellEnergy(dim=cfg.target.dim, device=device)
    return setup_trainer_and_run_flow(cfg, target, plotter=None, device=device)


if __name__ == "__main__":
    main()
