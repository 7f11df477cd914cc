"""Evaluate the GMM-40 method study's runs (``experiments/eval_gmm_study.sh``):
50,000 flow and AIS samples per run by default (the first argument), inner batch
500, the AIS target p, then the LaTeX table of the CSV (``latex_table``).

    python3 -m fab_tpu_torch.experiments.eval_gmm_study [--device cpu] [--dry-run]
        [N_SAMPLES] [key=value ...]

The runs are the newest run directory (by modification time) of each
``results/torch/gmm_study/<method>/seed<seed>/`` and
``results/torch/gmm_buffer_f64/seed<seed>/`` that holds a checkpoint; the
gmm_buffer_f64 runs are the fab_buffer rows, so a gmm_study/fab_buffer directory is
skipped when they exist. All are evaluated in this process by ``evaluate.main``
(gmm.yaml, ``fab.loss_type=fab_alpha_div``, then the trailing overrides) into
``results/torch/reports/gmm_study_results.csv``; the port's ``latex_table`` (the
repository script's output, byte for byte) writes its table to
``results/torch/reports/gmm_study_table.tex`` and prints it. Nothing is written to
the repository's ``reports/``. ``--dry-run`` prints the runs and evaluates nothing.
"""
from __future__ import annotations

import csv
import glob
import os

from fab_tpu_torch.experiments import evaluate, latex_table, study

N_SAMPLES = 50_000


def runs(root: str) -> list:
    """(name, run dir) per study directory, as eval_gmm_study.sh:13-30 picks them."""
    out = []
    dirs = sorted(glob.glob(os.path.join(root, "gmm_study", "*", "seed*")))
    dirs += sorted(glob.glob(os.path.join(root, "gmm_buffer_f64", "seed*")))
    for d in dirs:
        if not os.path.isdir(d):
            continue
        method = os.path.basename(os.path.dirname(d))
        if method == "gmm_buffer_f64":
            method = "fab_buffer"
        elif method == "fab_buffer" and os.path.isdir(os.path.join(root, "gmm_buffer_f64")):
            continue  # gmm_buffer_f64 already gives the fab_buffer rows
        seed = os.path.basename(d).replace("seed", "")
        subdirs = [s for s in glob.glob(os.path.join(d, "*", "")) if os.path.isdir(s)]
        if not subdirs:
            continue
        latest = max(subdirs, key=os.path.getmtime).rstrip(os.sep)
        if glob.glob(os.path.join(latest, "model_checkpoints", "iter_*")):
            out.append((f"{method}_seed{seed}", latest))
    return out


def main(argv=None):
    args = study.parse(study.parser(__doc__.splitlines()[0], cells=False), argv)
    n = int(args.positional[0]) if args.positional else N_SAMPLES
    found = runs(args.root)
    reports = os.path.join(args.root, "reports")
    csv_path = os.path.join(reports, "gmm_study_results.csv")
    if args.dry_run:
        for name, path in found:
            print(f"{name}: --num-samples {n} --inner-batch 500 fab.loss_type=fab_alpha_div "
                  f"{' '.join(args.trailing)} -> {path} ({csv_path})")
        return found
    print(f"evaluating {2 * len(found)} args")
    os.makedirs(reports, exist_ok=True)
    evaluate.main(["--config", os.path.join(study.REPO, study.CONFIGS, "gmm.yaml"),
                   *[a for name, path in found for a in ("--run", f"{name}={path}")],
                   "--num-samples", str(n), "--inner-batch", "500", "--out", csv_path,
                   "--device", args.device, "fab.loss_type=fab_alpha_div", *args.trailing])
    with open(csv_path) as f:
        table = latex_table.table(list(csv.DictReader(f)), "gmm")
    with open(os.path.join(reports, "gmm_study_table.tex"), "w") as f:
        f.write(table)
    print(table, end="")
    return found


if __name__ == "__main__":
    main()
