"""Evaluate every checkpoint of an LGCP-1600 run in one process
(``experiments/eval_lgcp_trajectory.sh``): the posterior-mean field RMSE and the ESS
per checkpoint, the run's convergence trajectory.

    python3 -m fab_tpu_torch.experiments.eval_lgcp_trajectory [--device cpu]
        [--dry-run] RUN_DIR [N_SAMPLES] [key=value ...]

``RUN_DIR/model_checkpoints/iter_<N>/state.pkl`` are evaluated in the numeric order
of N, as ``lgcp_iter<N>``, by one call of ``evaluate.main`` (lgcp.yaml with
``target.in_graph_kernel=true``, N_SAMPLES samples, 2048 by default, inner batch
512, then the trailing overrides) into
``results/torch/reports/lgcp_trajectory.csv``. With ``flow.fused_coupling=true`` a
run trained through the fused coupling kernel is evaluated through it (K2) on the
card. ``--dry-run`` prints the checkpoints and evaluates nothing.
"""
from __future__ import annotations

import glob
import os

from fab_tpu_torch.experiments import evaluate, study

N_SAMPLES = 2048


def checkpoints(run_dir: str) -> list:
    """(name, state.pkl) for each iter_<N> checkpoint, N ascending."""
    dirs = glob.glob(os.path.join(run_dir, "model_checkpoints", "iter_*"))
    its = sorted(int(os.path.basename(d).split("_", 1)[1]) for d in dirs)
    return [(f"lgcp_iter{it}", os.path.join(run_dir, "model_checkpoints", f"iter_{it}",
                                            "state.pkl")) for it in its]


def main(argv=None):
    p = study.parser(__doc__.splitlines()[0], cells=False)
    args = study.parse(p, argv)
    if not args.positional:
        p.error("usage: eval_lgcp_trajectory RUN_DIR [N_SAMPLES]")
    run_dir = args.positional[0]
    n = int(args.positional[1]) if len(args.positional) > 1 else N_SAMPLES
    found = checkpoints(run_dir)
    csv_path = os.path.join(args.root, "reports", "lgcp_trajectory.csv")
    if args.dry_run:
        for name, path in found:
            print(f"{name}: --num-samples {n} --inner-batch 512 target.in_graph_kernel=true "
                  f"{' '.join(args.trailing)} -> {path} ({csv_path})")
        return found
    print(f"evaluating {2 * len(found)} args from {run_dir}")
    os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    evaluate.main(["--config", os.path.join(study.REPO, study.CONFIGS, "lgcp.yaml"),
                   *[a for name, path in found for a in ("--run", f"{name}={path}")],
                   "--num-samples", str(n), "--inner-batch", "512", "--out", csv_path,
                   "--device", args.device, "target.in_graph_kernel=true", *args.trailing])
    return found


if __name__ == "__main__":
    main()
