"""LaTeX results table from an evaluation CSV (``experiments/latex_table.py`` of the
repository): rows grouped by method (the model name without ``_seedN``), mean +- sem
of each problem's headline metrics. numpy only.

    python3 -m fab_tpu_torch.experiments.latex_table --csv gmm_results.csv --problem gmm
    python3 -m fab_tpu_torch.experiments.latex_table --csv alpha_study.csv --alpha-study

``--alpha-study`` groups rows by the ``alpha`` column (seeds together) instead of by
method. The output is the repository script's, byte for byte.
"""
from __future__ import annotations

import argparse
import csv
from collections import defaultdict

import numpy as np

PROBLEM_METRICS = {
    "gmm": [
        ("eval_ess_flow", "ESS (flow)", 1),
        ("eval_ess_ais", "ESS (AIS)", 1),
        ("flow_test_set_mean_log_prob", r"$\log q(x)$ test", 1),
        ("flow_kl_forward", "Fwd. KL", 1),
        ("flow_bias_normed", r"Bias ($\times 100$)", 100),
        ("flow_bias_no_correction", r"Bias uncorr. ($\times 100$)", 100),
    ],
    "many_well": [
        ("eval_ess_flow", "ESS (flow)", 1),
        ("flow_test_set_exact_mean_log_prob", r"$\log q(x)$ exact", 1),
        ("flow_test_set_modes_mean_log_prob", r"$\log q(x)$ modes", 1),
        ("flow_forward_kl", "Fwd. KL", 1),
        ("ais_relative_MSE_Z_estimate", r"rel. err. $\hat Z$", 1),
        ("ais_abs_MSE_log_Z_estimate", r"abs. err. $\log \hat Z$", 1),
    ],
    "lgcp": [
        ("eval_ess_flow", "ESS (flow)", 1),
        ("eval_ess_ais", "ESS (AIS)", 1),
        ("ais_post_mean_field_rmse", "posterior-mean RMSE", 1),
    ],
}

ALPHA_STUDY_METRICS = [
    ("eval_ess_flow", "ESS (flow)", 1),
    ("eval_ess_ais", "ESS (AIS)", 1),
    ("flow_test_set_mean_log_prob", r"$\log q(x)$ test", 1),
    ("flow_bias_normed", r"Bias ($\times 100$)", 100),
]


def _cell(vals) -> str:
    """mean +- sem of one metric over a group's seeds. Values of 1e6 and more in size
    (a mode-collapsed flow's overflowed forward KL or log-prob) are left out and
    counted; the CSV keeps them."""
    if not vals:
        return "--"
    finite_vals = [v for v in vals if abs(v) < 1e6]
    n_over = len(vals) - len(finite_vals)
    if not finite_vals:
        return r"$>10^{6}$ (overflow)"
    mean = np.mean(finite_vals)
    sem = np.std(finite_vals) / max(len(finite_vals) - 1, 1) ** 0.5
    fmt = ".3f" if 1e-3 <= abs(mean) < 1e4 or mean == 0 else ".3g"
    cell = f"${mean:{fmt}} \\pm {sem:.3g}$"
    if n_over:
        cell += rf" [{n_over}/{len(vals)} seeds overflowed]"
    return cell


def table(rows, problem: str = "gmm", alpha_study: bool = False) -> str:
    """The table's lines (each ending in a newline) for ``rows`` of a CSV."""
    grouped = defaultdict(list)
    if alpha_study:
        for r in rows:
            grouped[rf"$\alpha = {float(r['alpha']):g}$"].append(r)
        metrics = ALPHA_STUDY_METRICS
    else:
        for r in rows:
            grouped[r["model_name"].rsplit("_seed", 1)[0]].append(r)
        metrics = PROBLEM_METRICS[problem]
    lines = [" & ".join(["Method"] + [label for _, label, _ in metrics]) + r" \\",
             r"\midrule"]
    n_seeds_max = max(len(rs) for rs in grouped.values()) if grouped else 0
    for name, rs in grouped.items():
        cells = [name.replace("_", r"\_")]
        # A group of fewer seeds than the table's largest says so, so that a
        # one-seed "+- 0" is not read as agreement between seeds.
        if 0 < len(rs) < n_seeds_max:
            cells[0] += rf" [{len(rs)} seed{'s' if len(rs) > 1 else ''} only]"
        for key, _, scale in metrics:
            cells.append(_cell([float(r[key]) * scale for r in rs if r.get(key, "") != ""]))
        lines.append(" & ".join(cells) + r" \\")
    return "".join(line + "\n" for line in lines)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", required=True)
    parser.add_argument("--problem", choices=PROBLEM_METRICS, default="gmm")
    parser.add_argument("--alpha-study", action="store_true")
    args = parser.parse_args(argv)
    with open(args.csv) as f:
        rows = list(csv.DictReader(f))
    text = table(rows, args.problem, args.alpha_study)
    print(text, end="")
    return text


if __name__ == "__main__":
    main()
