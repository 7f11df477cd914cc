"""ManyWell-32's FAB cells at the method study's budget of 2.25e8 flow forward passes,
f32, seeds 0-2, run one after another as study cells (``study.run_in_turn``), and a
summary of each cell's run.

- ``fab_buffer_s<N>`` and ``fab_no_buffer_s<N>``: ``run_mw_method_study``'s cells of
  those names (``experiments/run_mw_method_study.sh:46-53``: many_well.yaml with
  ``training.use_64_bit=false``, ``training.tlimit=0.66``, 225,000,000 flow forward
  passes, one in-run eval, one checkpoint, no plots): 4,963 and 5,231 iterations,
  into ``<root>/mw_study/<method>/seed<N>/``.

    python3 -m fab_tpu_torch.experiments.mw_fab_cells [--only NAME ...] [--dry-run]
        [--results-root DIR] [--timeout S] [--commit REF] [key=value ...]
    python3 -m fab_tpu_torch.experiments.mw_fab_cells --evaluate [--num-samples N]
        [--spread] [--slim] [--results-root DIR] [--only NAME ...]
    python3 -m fab_tpu_torch.experiments.mw_fab_cells --summary [--results-root DIR]
        [--report DIR]

Trailing ``key=value`` overrides go to every cell (a short probe of the step times,
for example). ``--timeout`` is the backstop (``run_mw_method_study``'s 4800 s): a
cell still running after it is killed, is a failed cell and a line in
``<root>/mw_fab_cells_FAILED``. A cell that ``training.tlimit`` stops is a failed cell
too: it has not reached its budget, and its summary says that the time limit stopped
it. After the cells, and with ``--summary`` alone, each cell found under the root is
summed up (``study.summarise``) into ``<root>/cells.json``.

``--evaluate`` scores the last checkpoint of each cell found under the root (of
``--only``'s cells, if given) by ``evaluate.main``: 20,480 flow and AIS samples
(``reports/README.md:24``), inner batch 2048, f32, the AIS target p, evaluation seed 0,
into ``<root>/reports/mw_study_results.csv``; with ``--spread``, the first of those
checkpoints of each method again at evaluation seeds 0-4 on the device's generator
(``<root>/reports/mw_eval_seed_spread.csv``); with ``--slim``, then, each of those
checkpoints is rewritten with the flow's parameters and the step alone (the
buffer's 512,000 rows and Adam's moments dropped), so that a run can be copied off
the card's machine. ``--report DIR`` writes the committed files and README.md's
ManyWell-32 section (``study.report``).
"""
from __future__ import annotations

import argparse
import functools
import glob
import os

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments import run_mw_method_study, study
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64

SEEDS = (0, 1, 2)
METHODS = ("fab_buffer", "fab_no_buffer")
# The method study's cells of these methods, in its order (seed by seed).
_CELLS = {c.name: c for c in run_mw_method_study.cells(argparse.Namespace(positional=[]))
          if c.name.rsplit("_s", 1)[0] in METHODS}
CELLS = list(_CELLS)
STUDY_ROWS = [f"{m}_seed{s}" for m in METHODS for s in SEEDS]
CONFIG = "many_well.yaml"
N_SAMPLES, INNER_BATCH = 20_480, 2048
F32 = "training.use_64_bit=false"
SPREAD_SEEDS = (0, 1, 2, 3, 4)


def cell(name: str) -> study.Cell:
    return _CELLS[name]


def budget(name: str, trailing=()) -> int:
    """The cell's iteration count (``study.budget``)."""
    return study.budget(cell(name), trailing)


def runs(root: str, names=CELLS) -> list:
    """(row name, last checkpoint) of each cell in ``names`` whose newest run
    directory under ``root`` holds a checkpoint, in the study's order."""
    out = []
    for name in names:
        dirs = [d for d in glob.glob(os.path.join(root, cell(name).save_path, "*", ""))
                if os.path.isdir(d)]
        if not dirs:
            continue
        newest = max(dirs, key=os.path.getmtime)
        ckpts = glob.glob(os.path.join(newest, "model_checkpoints", "iter_*", "state.pkl"))
        if ckpts:
            last = max(ckpts, key=lambda p: int(p.split("iter_")[-1].split(os.sep)[0]))
            out.append((study.row_name(name), last))
    return out


def evaluate_runs(root: str, device: str, found, n: int = N_SAMPLES, overrides=()) -> list:
    """``evaluate.main`` over ``found`` ((row name, checkpoint) pairs) into
    ``<root>/reports/mw_study_results.csv``, and their LaTeX table."""
    from fab_tpu_torch.experiments import evaluate, latex_table

    reports = os.path.join(root, "reports")
    os.makedirs(reports, exist_ok=True)
    rows = evaluate.main(["--config", os.path.join(study.REPO, study.CONFIGS, CONFIG),
                          *[a for name, path in found for a in ("--run", f"{name}={path}")],
                          "--num-samples", str(n), "--inner-batch", str(INNER_BATCH),
                          "--out", os.path.join(reports, REPORT.rows_csv), "--device", device,
                          F32, *overrides])
    with open(os.path.join(reports, REPORT.table_tex), "w") as f:
        f.write(latex_table.table(study.read_csv(os.path.join(reports, REPORT.rows_csv)),
                                  REPORT.problem))
    return rows


def spread(root: str, device: str, found, n: int = N_SAMPLES, overrides=()) -> list:
    """The evaluation's own noise: the first checkpoint of each method in ``found``,
    evaluated as ``evaluate_runs`` evaluates it at evaluation seeds SPREAD_SEEDS on
    the device's generator, into ``<root>/reports/mw_eval_seed_spread.csv``."""
    from fab_tpu_torch.experiments import evaluate

    cfg = apply_overrides(load_config(os.path.join(study.REPO, study.CONFIGS, CONFIG)),
                          [F32, *overrides])
    dtype = maybe_enable_x64(cfg)
    target = evaluate.build_target(cfg, dtype, device)
    rows, seen = [], set()
    for name, path in found:
        if evaluate.method_of(name) in seen:
            continue
        seen.add(evaluate.method_of(name))
        for seed in SPREAD_SEEDS:
            info = evaluate.evaluate_checkpoint(cfg, target, path, n, INNER_BATCH, seed=seed,
                                                dtype=dtype, device=device)
            rows.append(dict({k: float(v) for k, v in info.items()}, model_name=name,
                             eval_seed=seed, eval_noise="device"))
            print(name, seed, {k: round(v, 4) for k, v in info.items()}, flush=True)
    os.makedirs(os.path.join(root, "reports"), exist_ok=True)
    study.write_csv(os.path.join(root, "reports", REPORT.spread_csv), rows)
    return rows


def slim(found) -> None:
    """Rewrite each checkpoint of ``found`` with its flow's parameters (and the
    transition state) and its step alone."""
    from fab_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    for _, path in found:
        state = load_checkpoint(path)
        save_checkpoint(path, {"params": state["params"], "step": state["step"]})


# The exact samples' and the mode test set's mean log q; the forward KL is read on
# the exact samples.
LOG_Q = ("flow_test_set_exact_mean_log_prob", "flow_test_set_modes_mean_log_prob")
TEST_SET = ("flow_forward_kl", *LOG_Q)
# A metric that no evaluation seed moves (the mode grid's mean log q), computed by both
# packages in f32, agrees to its rounding: the cross-evaluation allows this much of it
# beside twice the evaluation seeds' spread.
F32_RTOL = 1e-5
# Whether an evaluation row's flow overflows on its test sets (``study.overflows``): a
# mean log q below -1e6 or not finite.
overflows = functools.partial(study.overflows, log_q_columns=LOG_Q)
# The cross-evaluation's yardstick from ``--spread``'s rows (``study.seed_spread``).
seed_spread = functools.partial(study.seed_spread, overflow=overflows)


def comparison(out: str) -> str:
    """Markdown (``study.comparison``): the port's three-seed ranges against fab_tpu's
    (``reports/mw_study_results.csv``) and fab_tpu's scores of the port's flows more
    than twice the seed spread off."""
    cross_path = os.path.join(out, REPORT.cross_csv)
    has_cross = os.path.exists(cross_path)
    return study.comparison(
        study.read_csv(os.path.join(out, REPORT.rows_csv)),
        study.read_csv(os.path.join(study.REPO, "reports", "mw_study_results.csv")),
        METHODS, TEST_SET, overflows,
        lambda r: ", ".join(f"{k} {float(r[k]):.4g}" for k in LOG_Q),
        study.read_csv(cross_path) if has_cross else None,
        seed_spread(study.read_csv(os.path.join(out, REPORT.spread_csv))) if has_cross
        else None, F32_RTOL)


def line(name: str, c: dict, label: str) -> str:
    """``study.cell_line`` and what an f32 run at length adds: the buffer fill's s,
    TF32, and whether the time limit stopped the run."""
    fill = f"buffer fill {c['fill_s']} s" if c.get("fill_s") is not None else "no buffer"
    return study.cell_line(name, c, label)[:-1] + (
        f"; {fill}; TF32 {c.get('tf32')}; stopped by "
        f"training.tlimit: {'yes' if c.get('tlimit_reached') else 'no'} (its box is "
        "0.66 h).")


# What starts a cell's README line, beside GMM-40's cells of the same names.
LABEL = "ManyWell-32 "
README_HEAD = """# ManyWell-32's FAB cells, trained and evaluated by the port on the card

Written by `python3 -m fab_tpu_torch.experiments.mw_fab_cells --summary --report
fab_tpu_torch/reports` from the cells' runs; `tests/test_torch_mw_study_results.py`
holds these files against `reports/mw_study_results.csv`. The cells are
`run_mw_method_study`'s fab_buffer and fab_no_buffer cells (many_well.yaml, f32,
2.25e8 flow forward passes: 4,963 and 5,231 iterations). A cell's "commit" is the
parent commit and the git tree of the working copy its chip call ran.

- `mw_study_results.csv`: the port's rows (`mw_fab_cells --evaluate`: 20,480 samples,
  inner batch 2048, f32, AIS target p, evaluation seed 0, on the card), with a
  provenance column.
- `mw_study_table.tex`: their table (`fab_tpu_torch.experiments.latex_table`).
- `mw_eval_seed_spread.csv`: one checkpoint of each method evaluated at evaluation
  seeds 0-4 on the card's generator (`--spread`), and the yardstick of the
  cross-evaluation: per method and metric, the widest spread of one checkpoint among
  those whose test sets stay finite (`mw_fab_cells.seed_spread`).
- `mw_study_results_fab_tpu_eval.csv`: the same checkpoints scored by fab_tpu's
  `experiments/evaluate.py` on the CPU (JAX, f32, 20,480 / 2048).

A chip call runs cells, scores them on the card and keeps the flows alone in their
checkpoints (the buffer's 512,000 rows stay behind), under a results root of its own:

    python3 -m fab_tpu_torch.experiments.mw_fab_cells --results-root ROOT --commit REF \\
        --only fab_buffer_s0 --only fab_no_buffer_s0
    python3 -m fab_tpu_torch.experiments.mw_fab_cells --results-root ROOT --evaluate \\
        --spread --slim

fab_tpu's scores of the same checkpoints, on the CPU (`CKPT`: a cell's
`last_checkpoint` in `ROOT/cells.json`):

    JAX_PLATFORMS=cpu python3 experiments/evaluate.py \\
        --config experiments/configs/many_well.yaml --run fab_buffer_seed0=ROOT/CKPT ... \\
        --num-samples 20480 --inner-batch 2048 \\
        --out ROOT/reports/mw_study_results_fab_tpu_eval.csv training.use_64_bit=false

Then `python3 -m fab_tpu_torch.experiments.mw_fab_cells --summary --report
fab_tpu_torch/reports --results-root ROOT` for each root: a later root's cells join
the report.

One line per cell (`<root>`: the run's `--results-root`):

"""
REPORT = study.Report(
    rows_csv="mw_study_results.csv", cross_csv="mw_study_results_fab_tpu_eval.csv",
    spread_csv="mw_eval_seed_spread.csv", table_tex="mw_study_table.tex",
    problem="many_well", rows=STUDY_ROWS, cells=CELLS,
    evaluation=("mw_fab_cells --evaluate 20,480 samples / inner 2048, f32, AIS target p, "
                "on the card"),
    cross_evaluation=("fab_tpu's experiments/evaluate.py on the CPU (JAX, f32), 20,480 "
                      "samples / inner 2048, AIS target p"),
    head=README_HEAD, others_head="Other runs:\n\n", comparison=comparison, line=line,
    label=LABEL)


def main(argv=None):
    p = study.parser(__doc__.splitlines()[0])
    p.add_argument("--timeout", type=float, default=run_mw_method_study.BACKSTOP_S,
                   help="the backstop, s per cell")
    p.add_argument("--commit", default="not given")
    p.add_argument("--summary", action="store_true", help="only sum up the runs found")
    p.add_argument("--evaluate", action="store_true", help="score the runs found")
    p.add_argument("--spread", action="store_true",
                   help="of --evaluate: one checkpoint per method at evaluation seeds 0-4")
    p.add_argument("--slim", action="store_true",
                   help="of --evaluate: then keep only the flows in the checkpoints")
    p.add_argument("--num-samples", type=int, default=N_SAMPLES, help="of --evaluate")
    p.add_argument("--report", metavar="DIR", help="write the committed files into DIR")
    args = p.parse_args(argv)
    args.trailing, args.root = args.args, os.path.join(study.REPO, args.results_root)
    cells = study.select([cell(n) for n in CELLS], args)
    if args.dry_run:
        return study.run_cells(cells, args, "mw-fab")
    if args.evaluate:
        device = str(resolve_device(args.device))
        found = runs(args.root, [c.name for c in cells])
        rows = evaluate_runs(args.root, device, found, args.num_samples, args.trailing)
        if args.spread:
            rows = spread(args.root, device, found, args.num_samples, args.trailing)
        if args.slim:
            slim(found)
        return rows
    done = {}
    if not args.summary and not args.report:
        resolve_device(args.device)
        done = study.run_in_turn(cells, args, "mw-fab", "mw_fab_cells_FAILED")
    table = study.write_summaries(cells, args, done)
    if args.report:
        study.report(args.root, os.path.join(study.REPO, args.report), REPORT)
    return table


if __name__ == "__main__":
    main()
