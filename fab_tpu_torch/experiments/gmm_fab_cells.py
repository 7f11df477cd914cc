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
        [--report DIR]
    python3 -m fab_tpu_torch.experiments.gmm_fab_cells --spread [--results-root DIR]
    python3 -m fab_tpu_torch.experiments.gmm_fab_cells --trajectory NAME=RUN_DIR ...
    python3 -m fab_tpu_torch.experiments.gmm_fab_cells --tails NAME=CHECKPOINT ...
        [--device cpu] [--num-samples N]
    python3 -m fab_tpu_torch.experiments.gmm_fab_cells --noise-report DIR
        --noise-eval SOURCE=CSV ... --noise-tails MD ...
    python3 -m fab_tpu_torch.experiments.gmm_fab_cells --fab-tpu-report DIR
        --fab-tpu-eval CSV ... --fab-tpu-run NAME=RUN_DIR ... [--commit REF]

The noise study's cells (PERF.md §6), run only when ``--only`` names them:
``fab_no_buffer_s3`` and ``_s4``, and ``fab_no_buffer_served_s<N>`` (N in 0-2): the
cell ``fab_no_buffer_s<N>`` run by ``run_gmm_served``, every draw made by CPU
generators and moved to the device, into ``<root>/gmm_study/fab_no_buffer_served/seed<N>/``. ``--noise-report`` tables the
study's fourteen runs (``noise_report``). ``--fab-tpu-report`` writes fab_tpu's own
fab_buffer runs on the CPU, as fab_tpu's evaluator scored them, with their provenance
(``fab_tpu_cpu_report``).

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

import contextlib
import dataclasses
import datetime
import functools
import glob
import math
import os

import numpy as np

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments import run_gmm_method_study, study
from fab_tpu_torch.experiments.study import read_csv, to_float, write_csv
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64

SEEDS = (0, 1, 2)
METHODS = ("fab_no_buffer", "fab_buffer")
CELLS = [f"{m}_s{s}" for m in METHODS for s in SEEDS]
# The noise study's cells, run only when named by --only: fab_no_buffer at two more
# seeds, and fab_no_buffer on CPU-drawn noise served to the device (run_gmm_served).
NOISE_SEEDS = (3, 4)
SERVED = "fab_no_buffer_served"
NOISE_CELLS = ([f"fab_no_buffer_s{s}" for s in NOISE_SEEDS]
               + [f"{SERVED}_s{s}" for s in SEEDS])
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
    if method == SERVED:
        return dataclasses.replace(run_gmm_method_study.cell("fab_no_buffer", seed),
                                   name=name, runner="run_gmm_served",
                                   save_path=f"gmm_study/{SERVED}/seed{seed}",
                                   log=f"gmm_study_served_s{seed}")
    return study.Cell(name=name, runner="run_gmm", config="gmm.yaml",
                      overrides=(*BUFFER_OVERRIDES, f"training.seed={seed}", *RUN_OVERRIDES),
                      save_path=f"gmm_buffer_f64/seed{seed}", log=f"gmm_buffer_f64_s{seed}")


def budget(name: str, trailing=()) -> int:
    """The cell's iteration count (``study.budget``)."""
    return study.budget(cell(name), trailing)


# Evaluation seeds of --spread: on the device's generator, and on CPU generators
# whose draws are moved to the device.
SPREAD_SEEDS = {"device": (0, 1, 2, 3, 4), "cpu": (0, 1, 2)}


def spread(root: str, device: str, n: int = 50_000, overrides=()) -> list:
    """The evaluation's own noise: the first cell of each method that left a
    checkpoint, evaluated by ``evaluate.evaluate_checkpoint`` as ``eval_gmm_study``
    evaluates it (``n`` samples, inner batch 500, f64, AIS target p) at the
    evaluation seeds SPREAD_SEEDS give each source of noise (``eval_noise``; CPU
    generators serve the device through ``run_gmm_served.served``); the rows go to
    ``<root>/reports/gmm_eval_seed_spread.csv``."""
    from fab_tpu_torch.experiments import eval_gmm_study, evaluate, run_gmm_served

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
        for noise, seeds in SPREAD_SEEDS.items():
            with run_gmm_served.served() if noise == "cpu" else contextlib.nullcontext():
                for seed in seeds:
                    info = evaluate.evaluate_checkpoint(
                        cfg, target, path, n, 500, seed=seed, dtype=dtype, device=device,
                        noise_device=device if noise == "device" else noise)
                    rows.append(dict({k: float(v) for k, v in info.items()},
                                     model_name=name, eval_seed=seed, eval_noise=noise))
                    print(name, noise, seed, {k: round(v, 4) for k, v in info.items()},
                          flush=True)
    os.makedirs(os.path.join(root, "reports"), exist_ok=True)
    write_csv(os.path.join(root, "reports", SPREAD_CSV), rows)
    return rows


TEST_SET = ("flow_kl_forward", "flow_test_set_mean_log_prob", "flow_test_set_n_nonfinite")
# Whether an evaluation row's flow overflows on the test set (``study.overflows``): rows
# left non-finite, or a mean log q below -1e6 (a row that does not report them, as
# fab_tpu's fab_buffer rows, does not overflow).
overflows = functools.partial(study.overflows, log_q_columns=("flow_test_set_mean_log_prob",))
# The cross-evaluation's yardstick from ``--spread``'s rows (``study.seed_spread``).
seed_spread = functools.partial(study.seed_spread, overflow=overflows)
EVALUATION = "eval_gmm_study 50,000 samples / inner 500, f64, AIS target p, on the card"


STUDY_ROWS = [f"{m}_seed{s}" for m in METHODS for s in SEEDS]


def report(root: str, out: str) -> None:
    """The study's committed files in ``out`` from the runs under ``root``
    (``study.report`` of REPORT): the port's rows, their table, the seed spread,
    fab_tpu's scores, and README.md's GMM-40 section, the study's cells first, then
    any other run found there (the noise study's)."""
    study.report(root, out, REPORT)


def comparison(out: str) -> str:
    """Markdown (``study.comparison``): each method's and metric's three-seed range in
    the port's rows and in fab_tpu's (``reports/gmm_study_results.csv``), an
    overflowing row left out of the test-set metrics' ranges, and each fab_tpu score
    of a port flow that lies more than twice the seed spread off the port's own."""
    cross_path = os.path.join(out, CROSS_CSV)
    has_cross = os.path.exists(cross_path)
    return study.comparison(
        read_csv(os.path.join(out, "gmm_study_results.csv")),
        read_csv(os.path.join(study.REPO, "reports", "gmm_study_results.csv")), METHODS,
        TEST_SET, overflows,
        lambda r: (f"{float(r['flow_test_set_n_nonfinite']):g} test rows non-finite, mean "
                   f"log q {float(r['flow_test_set_mean_log_prob']):.4g}"),
        read_csv(cross_path) if has_cross else None,
        seed_spread(read_csv(os.path.join(out, SPREAD_CSV))) if has_cross else None)


TRAJECTORY_KEYS = ("ess_base", "ess_ais", "loss")
TRAJECTORY_EVAL_KEYS = ("eval_ess_flow", "flow_bias_no_correction", "flow_kl_forward")


def trajectory(runs, n_windows: int = 10) -> str:
    """Markdown: GMM-40 runs side by side along their iterations, from their
    ``logging_hist.csv`` (``runs``: (name, run directory) pairs; both packages write
    the file with the same columns). For each of TRAJECTORY_KEYS, the median of the
    finite logged values in each of ``n_windows`` equal spans of iterations, and the
    skipped updates in each span; then each in-run eval's TRAJECTORY_EVAL_KEYS."""
    hists = {name: read_csv(os.path.join(path, "logging_hist.csv")) for name, path in runs}
    last = max(to_float(r["step"]) for rows in hists.values() for r in rows)
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
                          and edges[i] < to_float(r["step"]) <= edges[i + 1]]
                if key.startswith("skipped"):
                    cells.append(str(sum(to_float(r["update_applied"]) == 0 for r in inside)))
                    continue
                vals = [to_float(r[key]) for r in inside if math.isfinite(to_float(r[key]))]
                cells.append(f"{np.median(vals):.4g}" if vals else "-")
            lines.append(f"| {span} | " + " | ".join(cells) + " |")
    evals = {name: {int(to_float(r["step"])): r for r in rows if r.get("eval_ess_flow", "") != ""}
             for name, rows in hists.items()}
    lines += ["", "In-run evals, " + " / ".join(f"`{k}`" for k in TRAJECTORY_EVAL_KEYS) + ":",
              "", head.replace("Iterations", "Iteration"), rule]
    for step in sorted({s for by_step in evals.values() for s in by_step}):
        cells = [" / ".join(f"{to_float(by_step[step][k]):.4g}" for k in TRAJECTORY_EVAL_KEYS)
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


# The noise study's runs (PERF.md §6): group (K: the card's own noise, S: the
# card on CPU-drawn noise, C: CPU runs), seed, the source of its evaluation CSV, its
# row there, and its row in a --tails table.
NOISE_RUNS = ([("K", s, "card", f"fab_no_buffer_seed{s}", f"port_card_s{s}")
               for s in SEEDS + NOISE_SEEDS]
              + [("S", s, "card", f"{SERVED}_seed{s}", f"port_served_s{s}") for s in SEEDS]
              + [("C", s, "cpu", f"fab_no_buffer_seed{s}", f"port_cpu_s{s}") for s in SEEDS]
              + [("C", s, "fab_tpu", f"fab_no_buffer_seed{s}", f"fab_tpu_cpu_s{s}")
                 for s in SEEDS])
# A run that repeats one of NOISE_RUNS (its cell and seed) at a later tree: group,
# seed, source and row as above. It stands beside the run it repeats, outside the
# rule, and only where its --tails row is given.
NOISE_RERUNS = [("K re-run", 0, "card_rerun", "fab_no_buffer_seed0", "port_card_s0_rerun")]
NOISE_METRIC = "flow_bias_no_correction"


def _tails_rows(path: str) -> dict:
    """name -> (rows left out, unweighted bias, share farther than FAR) of the
    ``tails`` tables in a markdown file."""
    out = {}
    with open(path) as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) == 6 and cells[1].isdigit():
                out[cells[0]] = (int(cells[1]), float(cells[2]), float(cells[3]))
    return out


def noise_outcome(rows) -> str:
    """The noise study's decision rule (PERF.md §6) on the runs' metric: (i) every K
    run above every S and C run, and S's range overlapping C's; (ii) K and S both
    above all of C; (iii) K's range overlapping that of S and C together."""
    val = lambda g: [r[NOISE_METRIC] for r in rows if r["group"] == g]
    k, s, c = val("K"), val("S"), val("C")
    if min(k) > max(s + c) and min(s) <= max(c) and min(c) <= max(s):
        return "(i) the card's noise"
    if min(k) > max(c) and min(s) > max(c):
        return "(ii) the card's arithmetic at length"
    if min(k) <= max(s + c) and min(s + c) <= max(k):
        return "(iii) chance"
    return "none of (i)-(iii)"


def noise_report(evals, tails_paths, out: str) -> list:
    """The noise study's runs (NOISE_RUNS) in one table: each run's metric from its
    evaluation CSV (``evals``: SOURCE=CSV, SOURCE one of card, cpu, fab_tpu,
    card_rerun), or, for a run with no row there, the unweighted bias of its ``tails``
    row; beside it the rows its flow leaves out and the share farther than FAR
    (``tails_paths``: markdown files of ``tails`` tables); then the runs ranked, the
    rule's outcome, and the NOISE_RERUNS whose ``tails`` row is given. Writes
    ``<out>/gmm_fab_no_buffer_noise.csv`` and ``.md``; returns the rows."""
    scores = {}
    for spec in evals:
        source, path = spec.split("=", 1)
        for r in read_csv(path):
            scores[(source, r["model_name"])] = (float(r[NOISE_METRIC]), os.path.basename(path))
    found = {}
    for path in tails_paths:
        found.update(_tails_rows(path))
    rows = []
    reruns = [r for r in NOISE_RERUNS if r[-1] in found]
    for group, seed, source, name, tails_name in NOISE_RUNS + reruns:
        left_out, tails_bias, far = found[tails_name]
        metric, by = scores.get((source, name), (tails_bias, f"--tails ({tails_name})"))
        rows.append({"group": group, "seed": seed, "run": tails_name, NOISE_METRIC: metric,
                     "scored_by": by, "rows_left_out": left_out, "far_share": far})
    os.makedirs(out, exist_ok=True)
    write_csv(os.path.join(out, NOISE_CSV), rows, first=("group", "seed", "run"))
    ranked = sorted(rows[:len(NOISE_RUNS)], key=lambda r: -r[NOISE_METRIC])
    lines = [NOISE_HEAD, f"| Group | Seed | Run | `{NOISE_METRIC}` | Scored by | Rows left out "
             f"of 50000 | Share farther than {FAR:g} |", "|---|---|---|---|---|---|---|"]
    lines += [f"| {r['group']} | {r['seed']} | {r['run']} | {r[NOISE_METRIC]:.4g} | "
              f"{r['scored_by']} | {r['rows_left_out']} | {r['far_share']:.4g} |" for r in rows]
    lines += ["", "Ranked, highest first: " + ", ".join(
        f"{r['group']}{r['seed']}" + ("" if r["run"].startswith("port") else " (fab_tpu)")
        for r in ranked) + ".", "", f"Outcome by the rule: **{noise_outcome(rows)}**."]
    if reruns:
        lines += ["", "Re-runs (the same cell and seed at a later tree; not in the rule): "
                  + "; ".join(f"{r['run']} {r[NOISE_METRIC]:.4g} ({r['scored_by']}), rows "
                              f"left out {r['rows_left_out']}, far share {r['far_share']:.4g}"
                              for r in rows[len(NOISE_RUNS):]) + "."]
    with open(os.path.join(out, NOISE_CSV.replace(".csv", ".md")), "w") as f:
        f.write("\n".join(lines) + "\n")
    return rows


NOISE_CSV = "gmm_fab_no_buffer_noise.csv"
NOISE_HEAD = """# GMM-40 fab_no_buffer: the card's noise, the card's arithmetic, the CPU's runs

Written by `python3 -m fab_tpu_torch.experiments.gmm_fab_cells --noise-report
fab_tpu_torch/reports --noise-eval SOURCE=CSV ... --noise-tails MD ...` (the command
is in `README.md` here). Every run is gmm.yaml's fab_no_buffer cell at the paper's
budget (78,125 iterations, f64). Groups: **K**, the port on the card with the card's
own generator; **S**, the port on the card with every draw made by CPU generators and
moved to the card (`gmm_fab_cells --only fab_no_buffer_served_s<N>`, `run_gmm_served`);
**C**, CPU runs, of the port and of fab_tpu itself. The metric is `eval_gmm_study`'s
(50,000 samples, inner batch 500, evaluation seed 0: the card's runs on the card, the
port's CPU runs on the CPU, fab_tpu's by its own `experiments/evaluate.py`), or, where a run kept no
checkpoint to score, the unweighted bias of its `--tails` row. The last two columns
are `--tails` (50,000 flow samples, generator seed 0, on the CPU). The rule (PERF.md
§6, the noise study): (i) the card's noise when every K run lies above every S and C
run and S mixes with C; (ii) the card's arithmetic at length when K and S both lie
above all of C; (iii) chance when K's range overlaps that of S and C together.

"""
SPREAD_CSV = "gmm_eval_seed_spread.csv"
NOISE_LINES_HEAD = """The noise study's runs (`gmm_fab_no_buffer_noise.md`), one line each
(`_cpu_`: the port on the CPU; `<root>`: the run's `--results-root`):

"""
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
- `gmm_eval_seed_spread.csv`: checkpoints evaluated at several evaluation seeds
  (`--spread`: 0-4 on the card's generator and 0-2 on CPU generators, `eval_noise`;
  a checkpoint evaluated earlier keeps its rows), and the yardstick of the
  cross-evaluation: per method and metric, the widest spread of one checkpoint among
  those whose test rows all stay finite (`seed_spread`).
- `gmm_study_results_fab_tpu_eval.csv`: the same checkpoints scored by fab_tpu's
  `experiments/evaluate.py` on the CPU (JAX, f64, 50,000 / 500).
- `gmm_fab_no_buffer_tails.md`: where the fab_no_buffer flows put the mass behind the
  unweighted bias (`--tails`), beside fab_tpu's own runs, and the runs' logged
  trajectories (`--trajectory`).
- `gmm_fab_no_buffer_noise.md` and `.csv`: the noise study's fourteen fab_no_buffer
  runs, the card's own noise, the card on CPU-drawn noise and the CPU's runs, and the
  outcome of its rule (`--noise-report`); its inputs
  `gmm_fab_no_buffer_noise_eval_card.csv` and `_cpu.csv` (the new runs'
  `eval_gmm_study` rows, on the card and on the CPU), `_card_rerun.csv` (the card's
  seed 0 run again at a later tree), `gmm_fab_no_buffer_noise_tails.md` (their
  `--tails`) and `gmm_fab_no_buffer_fab_tpu_cpu_eval.csv` (fab_tpu's runs scored by its
  own evaluator).
- `gmm_fab_buffer_fab_tpu_cpu_eval.csv`: fab_tpu's own fab_buffer cells, seeds 0-2, run
  and scored by fab_tpu on the CPU (50,000 / 500, with the non-finite test rows), with
  their provenance (`--fab-tpu-report`).

One line per cell:

"""


FAB_TPU_CPU_CSV = "gmm_fab_buffer_fab_tpu_cpu_eval.csv"


def fab_tpu_cpu_report(eval_csvs, runs, commit: str, out: str) -> list:
    """fab_tpu's own fab_buffer cells on the CPU (``experiments/run_gmm.py`` on gmm.yaml
    with BUFFER_OVERRIDES and RUN_OVERRIDES; ``runs``: (row name, run directory)
    pairs), their scores by fab_tpu's ``experiments/evaluate.py`` (``eval_csvs``), into
    ``<out>/gmm_fab_buffer_fab_tpu_cpu_eval.csv`` with a provenance column: the tree
    (``commit``), the iterations each run logged last against the budget, and its wall
    time from its directory's time stamp (the run's start) to its last checkpoint."""
    scores = {r["model_name"]: r for path in eval_csvs for r in read_csv(path)}
    rows = []
    for name, run in runs:
        run = run.rstrip(os.sep)
        reached = max(int(to_float(r["step"])) for r in
                      read_csv(os.path.join(run, "logging_hist.csv")) if r.get("loss", ""))
        last = max(glob.glob(os.path.join(run, "model_checkpoints", "iter_*")),
                   key=lambda p: int(p.rsplit("iter_", 1)[1]))
        start = datetime.datetime.strptime(os.path.basename(run), "%Y-%m-%d_%H-%M-%S")
        wall = os.path.getmtime(last) - start.timestamp()
        rows.append(dict(scores[name], provenance=(
            f"fab_tpu's experiments/run_gmm.py on the CPU (JAX, f64), "
            f"{' '.join((*BUFFER_OVERRIDES, *RUN_OVERRIDES))}, {commit}; "
            f"iterations={reached} of {budget('fab_buffer_s0')}; wall {wall:.0f} s (the run "
            "directory's time stamp to its last checkpoint); scored by fab_tpu's "
            "experiments/evaluate.py on the CPU, 50,000 samples / inner 500, f64, AIS "
            "target p, evaluation seed 0")))
    os.makedirs(out, exist_ok=True)
    write_csv(os.path.join(out, FAB_TPU_CPU_CSV), rows)
    return rows


REPORT = study.Report(
    rows_csv="gmm_study_results.csv", cross_csv=CROSS_CSV, spread_csv=SPREAD_CSV,
    table_tex="gmm_study_table.tex", problem="gmm", rows=STUDY_ROWS, cells=CELLS,
    evaluation=EVALUATION,
    cross_evaluation=("fab_tpu's experiments/evaluate.py on the CPU (JAX, f64), 50,000 "
                      "samples / inner 500, AIS target p"),
    head=README_HEAD, others_head=NOISE_LINES_HEAD, comparison=comparison)


def main(argv=None):
    p = study.parser(__doc__.splitlines()[0])
    p.add_argument("--timeout", type=float, default=None, help="the backstop, s per cell")
    p.add_argument("--commit", default="not given")
    p.add_argument("--summary", action="store_true", help="only sum up the runs found")
    p.add_argument("--spread", action="store_true",
                   help="evaluate one checkpoint per method at several evaluation seeds")
    p.add_argument("--num-samples", type=int, default=50_000, help="of --spread, --tails")
    p.add_argument("--report", metavar="DIR", help="write the committed files into DIR")
    p.add_argument("--trajectory", nargs="+", metavar="NAME=RUN_DIR",
                   help="print GMM-40 runs' logged trajectories side by side")
    p.add_argument("--tails", nargs="+", metavar="NAME=CHECKPOINT",
                   help="print where trained flows put the mass behind the unweighted bias")
    p.add_argument("--noise-report", metavar="DIR",
                   help="write the noise study's table of runs into DIR")
    p.add_argument("--noise-eval", action="append", default=[], metavar="SOURCE=CSV",
                   help="of --noise-report: evaluation rows (SOURCE: card, cpu, fab_tpu)")
    p.add_argument("--noise-tails", action="append", default=[], metavar="MD",
                   help="of --noise-report: a markdown file of --tails tables")
    p.add_argument("--fab-tpu-report", metavar="DIR",
                   help="write fab_tpu's own fab_buffer runs' scores into DIR")
    p.add_argument("--fab-tpu-eval", action="append", default=[], metavar="CSV",
                   help="of --fab-tpu-report: scores (repeatable)")
    p.add_argument("--fab-tpu-run", action="append", default=[], metavar="NAME=RUN_DIR",
                   help="of --fab-tpu-report: a run of fab_tpu's (repeatable)")
    args = p.parse_args(argv)
    args.trailing, args.root = args.args, os.path.join(study.REPO, args.results_root)
    if args.trajectory or args.tails:
        text = (trajectory([a.split("=", 1) for a in args.trajectory]) if args.trajectory
                else tails([a.split("=", 1) for a in args.tails], resolve_device(args.device),
                           args.num_samples, args.trailing))
        print(text, end="")
        return text
    if args.fab_tpu_report:
        return fab_tpu_cpu_report(args.fab_tpu_eval, [a.split("=", 1) for a in args.fab_tpu_run],
                                  args.commit, os.path.join(study.REPO, args.fab_tpu_report))
    if args.noise_report:
        return noise_report(args.noise_eval, args.noise_tails,
                            os.path.join(study.REPO, args.noise_report))
    if args.spread:
        return spread(args.root, resolve_device(args.device), args.num_samples, args.trailing)
    cells = study.select([cell(n) for n in (CELLS + NOISE_CELLS if args.only else CELLS)],
                         args)
    if args.dry_run:
        return study.run_cells(cells, args, "gmm-fab")
    done = {}
    if not args.summary and not args.report:
        resolve_device(args.device)
        done = study.run_in_turn(cells, args, "gmm-fab", "gmm_fab_cells_FAILED")
    table = study.write_summaries(cells, args, done)
    if args.report:
        report(args.root, os.path.join(study.REPO, args.report))
    return table


if __name__ == "__main__":
    main()
