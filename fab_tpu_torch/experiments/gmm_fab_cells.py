"""GMM-40's FAB cells at gmm.yaml's budget of 2e7 flow forward passes, f64, seeds 0-2,
run one after another as study cells (``study.run_cells``), and a summary of each
cell's run.

- ``fab_no_buffer_s<N>``: ``run_gmm_method_study``'s cell of that name (78,125
  iterations), into ``<root>/gmm_study/fab_no_buffer/seed<N>/``;
- ``fab_buffer_s<N>``: ``run_gmm`` with the ESS ablation control's overrides
  (``experiments/run_gmm_ess_ablation.sh:21-26``: FAB with the prioritised buffer) at
  the full budget (52,076 iterations), in-run evals 5, checkpoints 2, plots 0, into
  ``<root>/gmm_buffer_f64/seed<N>/``, the directory ``eval_gmm_study`` reads as the
  fab_buffer rows.

    python3 -m fab_tpu_torch.experiments.gmm_fab_cells [--only NAME ...] [--dry-run]
        [--results-root DIR] [--timeout S] [--commit REF] [key=value ...]
    python3 -m fab_tpu_torch.experiments.gmm_fab_cells --summary [--results-root DIR]
    python3 -m fab_tpu_torch.experiments.gmm_fab_cells --trajectory NAME=RUN_DIR ...
    python3 -m fab_tpu_torch.experiments.gmm_fab_cells --tails NAME=CHECKPOINT ...
        [--device cpu] [--num-samples N]

Trailing ``key=value`` overrides go to every cell (a short probe of the step times,
for example). ``--timeout`` is the study's backstop: a cell still running after it is
killed, is a failed cell and a line in ``<root>/gmm_fab_cells_FAILED``. Then, and with
``--summary`` alone, each cell found under the root is summed up from its log, its
``logging_hist.csv`` (one row per logged chunk: the last of every ``log_every``
iterations) and its last checkpoint, into ``<root>/cells.json``: the iteration
reached against the budget, whether the step was compiled and the run resumed, the
wall time and the median step that ``Trainer.run`` prints, the non-finite losses and
skipped updates among the logged rows, the last in-run ``eval_ess_flow``, whether
the last checkpoint's flow parameters are finite, the command, the card and the
commit. ``--trajectory`` prints runs' logged trajectories side by side (``trajectory``),
``--tails`` where trained flows put the mass behind the unweighted bias (``tails``).
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

from fab_tpu_torch.checkpoint import load_checkpoint
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments import run_gmm_method_study, study
from fab_tpu_torch.experiments.setup_run import get_n_iterations
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64

SEEDS = (0, 1, 2)
METHODS = ("fab_no_buffer", "fab_buffer")
CELLS = [f"{m}_s{s}" for m in METHODS for s in SEEDS]
BUFFER_OVERRIDES = ("fab.loss_type=fab_alpha_div", "training.use_buffer=true",
                    "training.prioritised_buffer=true")
RUN_OVERRIDES = ("evaluation.n_plots=0", "evaluation.n_eval=5", "evaluation.n_checkpoints=2")


def split(name: str):
    method, seed = name.rsplit("_s", 1)
    return method, int(seed)


def cell(name: str) -> study.Cell:
    method, seed = split(name)
    if method == "fab_no_buffer":
        return run_gmm_method_study.cell(method, seed)
    return study.Cell(name=name, runner="run_gmm", config="gmm.yaml",
                      overrides=(*BUFFER_OVERRIDES, f"training.seed={seed}", *RUN_OVERRIDES),
                      save_path=f"gmm_buffer_f64/seed{seed}", log=f"gmm_buffer_f64_s{seed}")


def save_dir(root: str, name: str) -> str:
    return os.path.join(root, cell(name).save_path)


def log_path(root: str, name: str) -> str:
    return os.path.join(root, "logs", f"{cell(name).log}.log")


def budget(name: str, trailing=()) -> int:
    """The cell's iteration count from its configuration (``get_n_iterations``)."""
    cfg = apply_overrides(load_config(os.path.join(study.REPO, study.CONFIGS, "gmm.yaml")),
                          [*cell(name).overrides, *trailing])
    t, to = cfg.training, cfg.fab.transition_operator
    return get_n_iterations(t.n_iterations, t.n_flow_forward_pass, t.batch_size,
                            cfg.fab.loss_type, to.n_inner_steps,
                            cfg.fab.n_intermediate_distributions, to.type, t.use_buffer,
                            t.get("min_buffer_length"))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run_cells(cells, args) -> dict:
    """Each cell through ``study.run_cells`` in turn; name -> (exit code, wall s)."""
    one = argparse.Namespace(**{**vars(args), "only": None})
    done = {}
    for c in cells:
        t0 = time.time()
        ((_, rc),) = study.run_cells([c], one, "gmm-fab", guard=None, timeout_s=args.timeout,
                                     failed_file="gmm_fab_cells_FAILED")
        done[c.name] = (rc, time.time() - t0)
    return done


def _float(v: str) -> float:
    try:
        return float(v)
    except ValueError:
        return math.nan


def summarise(root: str, name: str, trailing=()) -> dict:
    """What the cell's run left under ``root`` (see the module's docstring)."""
    runs = [d for d in glob.glob(os.path.join(save_dir(root, name), "*", ""))
            if os.path.isdir(d)]
    out = {"cell": name, "budget_iterations": budget(name, trailing)}
    if not runs:
        return dict(out, run_dir=None)
    run = max(runs, key=os.path.getmtime).rstrip(os.sep)
    out["run_dir"] = os.path.relpath(run, root)
    rows = []
    hist = os.path.join(run, "logging_hist.csv")
    if os.path.exists(hist):
        with open(hist) as f:
            rows = list(csv.DictReader(f))
    train = [r for r in rows if r.get("loss", "") != ""]
    # Trainer logs its evals' keys bare, the buffer trainers with "_p_target".
    ess_key = "eval_ess_flow_p_target" if rows and "eval_ess_flow_p_target" in rows[0] \
        else "eval_ess_flow"
    evals = [r for r in rows if r.get(ess_key, "") != ""]
    out.update(
        iterations=int(_float(train[-1]["step"])) if train else 0,
        logged_rows=len(train),
        nonfinite_losses=sum(not math.isfinite(_float(r["loss"])) for r in train),
        skipped_updates=sum(_float(r.get("update_applied", "1")) == 0 for r in train),
        last_eval_ess_flow=_float(evals[-1][ess_key]) if evals else None,
        last_eval_step=int(_float(evals[-1]["step"])) if evals else None,
    )
    ckpts = glob.glob(os.path.join(run, "model_checkpoints", "iter_*", "state.pkl"))
    if ckpts:
        last = max(ckpts, key=lambda p: int(p.split("iter_")[-1].split(os.sep)[0]))
        leaves = []

        def walk(node):
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)
            elif isinstance(node, np.ndarray):
                leaves.append(node)

        walk(load_checkpoint(last)["params"]["flow"])
        finite = bool(leaves) and all(bool(np.isfinite(a).all()) for a in leaves)
        out.update(last_checkpoint=os.path.relpath(last, root), finite_params=finite)
    log = log_path(root, name)
    text = ""
    if os.path.exists(log):
        with open(log, errors="replace") as f:
            text = f.read()
    timing = re.findall(r"run timing: iterations \d+-\d+ in ([\d.]+) s; median step over "
                        r"the last 10 chunks ([\d.]+ ms|not measured)", text)
    out.update(
        compiled="train step: compiled" in text,
        resumed="Resuming from" in text,
        run_wall_s=float(timing[-1][0]) if timing else None,
        median_step_ms=(float(timing[-1][1].split()[0])
                        if timing and timing[-1][1] != "not measured" else None),
    )
    return out


SPREAD_SEEDS = (0, 1)


def spread(root: str, device: str, n: int = 50_000, overrides=()) -> list:
    """The evaluation's own noise: the first cell of each method that left a
    checkpoint, evaluated by ``evaluate.evaluate_checkpoint`` as ``eval_gmm_study``
    evaluates it (``n`` samples, inner batch 500, f64, AIS target p) at evaluation
    seeds 0 and 1; the rows go to ``<root>/reports/gmm_eval_seed_spread.csv``."""
    from fab_tpu_torch.experiments import eval_gmm_study, evaluate

    cfg = apply_overrides(load_config(os.path.join(study.REPO, study.CONFIGS, "gmm.yaml")),
                          ["fab.loss_type=fab_alpha_div", *overrides])
    dtype = maybe_enable_x64(cfg)
    target = evaluate.build_target(cfg, dtype, device)
    rows, seen = [], set()
    for name, path in eval_gmm_study.runs(root):
        method = evaluate.method_of(name)
        if method in seen:
            continue
        seen.add(method)
        for seed in SPREAD_SEEDS:
            info = evaluate.evaluate_checkpoint(cfg, target, path, n, 500, seed=seed,
                                                dtype=dtype, device=device)
            rows.append(dict({k: float(v) for k, v in info.items()}, model_name=name,
                             eval_seed=seed))
            print(name, seed, {k: round(v, 4) for k, v in info.items()}, flush=True)
    os.makedirs(os.path.join(root, "reports"), exist_ok=True)
    _write_csv(os.path.join(root, "reports", SPREAD_CSV), rows)
    return rows


def _write_csv(path: str, rows, first=("model_name",)) -> None:
    cols = list(first) + sorted({k for r in rows for k in r} - set(first))
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, restval="")
        writer.writeheader()
        writer.writerows(rows)


def _read_csv(path: str) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def provenance(cell: dict) -> str:
    """A port row's provenance: where and how far its flow was trained."""
    return (f"port on the card ({cell.get('card')}); commit {cell.get('commit')}; "
            f"iterations={cell['iterations']} of {cell['budget_iterations']}; "
            f"resumed={'yes' if cell.get('resumed') else 'no'}; "
            f"eval_gmm_study 50,000 samples / inner 500, f64, AIS target p, on the card")


def report(root: str, out: str) -> None:
    """Copy the study's rows into ``out`` with a provenance column: the port's rows
    (``<root>/reports/gmm_study_results.csv``), their LaTeX table, the seed spread
    and, where present, fab_tpu's scores of the same checkpoints
    (``<root>/reports/gmm_study_results_fab_tpu_eval.csv``); and ``README.md``, one
    line per cell from ``<root>/cells.json``."""
    from fab_tpu_torch.experiments import latex_table

    with open(os.path.join(root, "cells.json")) as f:
        cells = json.load(f)
    by_row = {f"{split(n)[0]}_seed{split(n)[1]}": c for n, c in cells.items()}
    os.makedirs(out, exist_ok=True)
    rows = _read_csv(os.path.join(root, "reports", "gmm_study_results.csv"))
    for r in rows:
        r["provenance"] = provenance(by_row[r["model_name"]])
    _write_csv(os.path.join(out, "gmm_study_results.csv"), rows)
    with open(os.path.join(out, "gmm_study_table.tex"), "w") as f:
        f.write(latex_table.table(rows, "gmm"))
    shutil.copy(os.path.join(root, "reports", SPREAD_CSV), os.path.join(out, SPREAD_CSV))
    cross = os.path.join(root, "reports", CROSS_CSV)
    if os.path.exists(cross):
        rows = _read_csv(cross)
        for r in rows:
            r["provenance"] = ("fab_tpu's experiments/evaluate.py on the CPU (JAX, f64), "
                               "50,000 samples / inner 500, AIS target p, of the port's "
                               f"checkpoint {by_row[r['model_name']]['last_checkpoint']}")
        _write_csv(os.path.join(out, CROSS_CSV), rows)
    lines = []
    for name in CELLS:
        c = cells.get(name)
        if c is None:
            lines.append(f"- `{name}`: not run.")
            continue
        lines.append(
            f"- `{name}`: `{c.get('command')}`; commit "
            f"{c.get('commit')}; {c.get('card')}; {c['iterations']} of "
            f"{c['budget_iterations']} iterations, step "
            f"{'compiled' if c.get('compiled') else 'eager'}; process wall "
            f"{c.get('process_wall_s')} s, run loop {c.get('run_wall_s')} s, median step "
            f"{c.get('median_step_ms')} ms (last 10 chunks of 10); non-finite losses "
            f"{c['nonfinite_losses']} and skipped updates {c['skipped_updates']} of "
            f"{c['logged_rows']} logged rows; last in-run eval_ess_flow "
            f"{c.get('last_eval_ess_flow')} (iteration {c.get('last_eval_step')}); final "
            f"parameters finite: {c.get('finite_params')}; resumed: "
            f"{'yes' if c.get('resumed') else 'no'}; exit code {c.get('rc')}.")
    with open(os.path.join(out, "README.md"), "w") as f:
        f.write(README_HEAD + "\n".join(lines).replace(sys.executable, "python3") + "\n"
                + comparison(out))


def comparison(out: str) -> str:
    """Markdown: each method's and metric's three-seed range in the port's rows and in
    fab_tpu's (``reports/gmm_study_results.csv``), and each fab_tpu score of a port
    flow that lies more than twice the seed spread off the port's own."""
    rows = _read_csv(os.path.join(out, "gmm_study_results.csv"))
    ref = _read_csv(os.path.join(study.REPO, "reports", "gmm_study_results.csv"))
    method = lambda r: r["model_name"].rsplit("_seed", 1)[0]
    lines = ["", "## The port's three-seed ranges against fab_tpu's", "",
             "| Method | Metric | Port [min, max] | fab_tpu [min, max] | Overlap |",
             "|---|---|---|---|---|"]
    for m in METHODS:
        for k in [k for k in rows[0] if k not in ("model_name", "provenance")]:
            a = [float(r[k]) for r in rows if method(r) == m]
            b = [float(r[k]) for r in ref if method(r) == m and r.get(k, "") != ""]
            if a and b:
                lines.append(f"| {m} | `{k}` | [{min(a):.4g}, {max(a):.4g}] | "
                             f"[{min(b):.4g}, {max(b):.4g}] | "
                             f"{'yes' if min(a) <= max(b) and min(b) <= max(a) else 'no'} |")
    cross_path = os.path.join(out, CROSS_CSV)
    if not os.path.exists(cross_path):
        return "\n".join(lines) + "\n"
    seeds = _read_csv(os.path.join(out, SPREAD_CSV))
    spread = {}
    for m in METHODS:
        pair = [r for r in seeds if method(r) == m]
        spread[m] = {k: abs(float(pair[0][k]) - float(pair[1][k])) for k in pair[0]
                     if k not in ("model_name", "eval_seed")}
    port = {r["model_name"]: r for r in rows}
    lines += ["", "## fab_tpu's scores of the port's flows, more than twice the seed "
              "spread off", "", "| Row | Metric | Port | fab_tpu | Twice the spread |",
              "|---|---|---|---|---|"]
    scores = [(r, k, 2 * v) for r in _read_csv(cross_path) for k, v in spread[method(r)].items()]
    off = [(r, k, two) for r, k, two in scores
           if not abs(float(r[k]) - float(port[r["model_name"]][k])) <= two]
    lines += [f"| {r['model_name']} | `{k}` | {float(port[r['model_name']][k]):.4g} | "
              f"{float(r[k]):.4g} | {two:.4g} |" for r, k, two in off]
    lines.append(f"\n{len(off)} of {len(scores)} scores lie more than twice the spread off.")
    return "\n".join(lines) + "\n"


TRAJECTORY_KEYS = ("ess_base", "ess_ais", "loss")
TRAJECTORY_EVAL_KEYS = ("eval_ess_flow", "flow_bias_no_correction", "flow_kl_forward")


def trajectory(runs, n_windows: int = 10) -> str:
    """Markdown: GMM-40 runs side by side along their iterations, from their
    ``logging_hist.csv`` (``runs``: (name, run directory) pairs; both packages write
    the file with the same columns). For each of TRAJECTORY_KEYS, the median of the
    finite logged values in each of ``n_windows`` equal spans of iterations, and the
    skipped updates in each span; then each in-run eval's TRAJECTORY_EVAL_KEYS."""
    hists = {name: _read_csv(os.path.join(path, "logging_hist.csv")) for name, path in runs}
    last = max(_float(r["step"]) for rows in hists.values() for r in rows)
    edges = np.linspace(0.0, last, n_windows + 1)
    spans = [f"{int(a) + 1}-{int(b)}" for a, b in zip(edges[:-1], edges[1:])]
    head = "| Iterations | " + " | ".join(hists) + " |"
    rule = "|---|" + "---|" * len(hists)
    lines = []
    for key in (*TRAJECTORY_KEYS, "skipped updates"):
        lines += ["", f"Logged `{key}`" + ("" if key.startswith("skipped") else
                                           ", median over each span") + ":", "", head, rule]
        for i, span in enumerate(spans):
            cells = []
            for rows in hists.values():
                inside = [r for r in rows if r.get("loss", "") != ""
                          and edges[i] < _float(r["step"]) <= edges[i + 1]]
                if key.startswith("skipped"):
                    cells.append(str(sum(_float(r["update_applied"]) == 0 for r in inside)))
                    continue
                vals = [_float(r[key]) for r in inside if math.isfinite(_float(r[key]))]
                cells.append(f"{np.median(vals):.4g}" if vals else "-")
            lines.append(f"| {span} | " + " | ".join(cells) + " |")
    evals = {name: {int(_float(r["step"])): r for r in rows if r.get("eval_ess_flow", "") != ""}
             for name, rows in hists.items()}
    lines += ["", "In-run evals, " + " / ".join(f"`{k}`" for k in TRAJECTORY_EVAL_KEYS) + ":",
              "", head.replace("Iterations", "Iteration"), rule]
    for step in sorted({s for by_step in evals.values() for s in by_step}):
        cells = [" / ".join(f"{_float(by_step[step][k]):.4g}" for k in TRAJECTORY_EVAL_KEYS)
                 if step in by_step else "-" for by_step in evals.values()]
        lines.append(f"| {step} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


FAR = 10.0  # a flow sample this far from every mixture mean lies off the target's mass


def tails(runs, device, n: int = 50_000, overrides=()) -> str:
    """Markdown: where each checkpoint's flow puts the mass behind the unweighted
    bias. ``n`` flow samples (generator seed 0) of each (name, checkpoint) in
    ``runs``, on gmm.yaml's GMM in f64; the rows the evaluation leaves out (a
    non-finite x, log q or log p); over the rest, the unweighted bias of the
    quadratic, the share of samples farther than FAR from every mixture mean, their
    share of the quadratic's sum, and the bias without them."""
    import torch

    from fab_tpu_torch.experiments import evaluate
    from fab_tpu_torch.experiments.load_model_for_eval import load_model
    from fab_tpu_torch.utils.numerical import quadratic_function

    cfg = apply_overrides(load_config(os.path.join(study.REPO, study.CONFIGS, "gmm.yaml")),
                          ["fab.loss_type=fab_alpha_div", *overrides])
    dtype = maybe_enable_x64(cfg)
    target = evaluate.build_target(cfg, dtype, device)
    truth = float(target.true_expectation)
    bias = lambda f: abs(float(f.mean()) / truth - 1.0)
    lines = [f"| Flow | Rows left out of {n} | Unweighted bias | Share farther than {FAR:g} "
             "| Their share of the sum | Bias without them |", "|---|---|---|---|---|---|"]
    for name, path in runs:
        model, _ = load_model(cfg, target, path, dtype, device)
        generator = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            x, log_q = model.flow.sample_and_log_prob(n, generator)
            valid = (torch.isfinite(x).all(-1) & torch.isfinite(log_q)
                     & torch.isfinite(target.log_prob(x)))
            x = x[valid]
            f = quadratic_function(x)
            far = torch.cdist(x, target.locs.to(x.dtype)).min(-1).values > FAR
        lines.append(f"| {name} | {int((~valid).sum())} | {bias(f):.4g} | "
                     f"{float(far.double().mean()):.4g} | {float(f[far].sum() / f.sum()):.4g} | "
                     f"{bias(f[~far]):.4g} |")
    return "\n".join(lines) + "\n"


SPREAD_CSV = "gmm_eval_seed_spread.csv"
CROSS_CSV = "gmm_study_results_fab_tpu_eval.csv"
README_HEAD = """# GMM-40's FAB cells, trained and evaluated by the port on the card

Written by `python3 -m fab_tpu_torch.experiments.gmm_fab_cells --summary --report
fab_tpu_torch/reports` from the cells' runs; `tests/test_torch_gmm_study_results.py`
holds these files against `reports/gmm_study_results.csv`. A cell's "commit" is
the parent commit and the git tree of the working copy its chip call ran; the code
those runs went through (`train.py`, the runners, this module's cell commands) is
this directory's commit's.

- `gmm_study_results.csv`: the port's `eval_gmm_study` rows (50,000 samples, inner
  batch 500, f64, AIS target p, on the card), with a provenance column.
- `gmm_study_table.tex`: their table (`fab_tpu_torch.experiments.latex_table`).
- `gmm_eval_seed_spread.csv`: one checkpoint per method evaluated at evaluation seeds
  0 and 1 (`--spread`), the yardstick of the cross-evaluation.
- `gmm_study_results_fab_tpu_eval.csv`: the same checkpoints scored by fab_tpu's
  `experiments/evaluate.py` on the CPU (JAX, f64, 50,000 / 500).
- `gmm_fab_no_buffer_tails.md`: where the fab_no_buffer flows put the mass behind the
  unweighted bias (`--tails`), beside fab_tpu's own runs, and the runs' logged
  trajectories (`--trajectory`).

One line per cell:

"""


def main(argv=None):
    p = study.parser(__doc__.splitlines()[0])
    p.add_argument("--timeout", type=float, default=None, help="the backstop, s per cell")
    p.add_argument("--commit", default="not given")
    p.add_argument("--summary", action="store_true", help="only sum up the runs found")
    p.add_argument("--spread", action="store_true",
                   help="evaluate one checkpoint per method at two evaluation seeds")
    p.add_argument("--num-samples", type=int, default=50_000, help="of --spread, --tails")
    p.add_argument("--report", metavar="DIR", help="write the committed files into DIR")
    p.add_argument("--trajectory", nargs="+", metavar="NAME=RUN_DIR",
                   help="print GMM-40 runs' logged trajectories side by side")
    p.add_argument("--tails", nargs="+", metavar="NAME=CHECKPOINT",
                   help="print where trained flows put the mass behind the unweighted bias")
    args = p.parse_args(argv)
    args.trailing, args.root = args.args, os.path.join(study.REPO, args.results_root)
    if args.trajectory or args.tails:
        text = (trajectory([a.split("=", 1) for a in args.trajectory]) if args.trajectory
                else tails([a.split("=", 1) for a in args.tails], resolve_device(args.device),
                           args.num_samples, args.trailing))
        print(text, end="")
        return text
    if args.spread:
        return spread(args.root, resolve_device(args.device), args.num_samples, args.trailing)
    cells = study.select([cell(n) for n in CELLS], args)
    if args.dry_run:
        return study.run_cells(cells, args, "gmm-fab")
    done = {}
    if not args.summary and not args.report:
        resolve_device(args.device)
        done = run_cells(cells, args)
    path = os.path.join(args.root, "cells.json")
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    for c in cells:
        if not os.path.isdir(save_dir(args.root, c.name)):
            continue
        row = dict(table.get(c.name, {}), **summarise(args.root, c.name, args.trailing))
        if c.name in done:
            command = " ".join(study.command(c, args)).replace(sys.executable, "python3")
            row.update(rc=done[c.name][0], process_wall_s=round(done[c.name][1], 1),
                       overrides=list(args.trailing),
                       command=command.replace(study.REPO + os.sep, ""),
                       card=card() if args.device == "cuda" else "cpu", commit=args.commit)
        table[c.name] = row
        print(json.dumps(row), flush=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    if args.report:
        report(args.root, os.path.join(study.REPO, args.report))
    return table


if __name__ == "__main__":
    main()
