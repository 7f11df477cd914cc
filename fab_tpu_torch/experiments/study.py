"""What the study modules share: a study is a list of cells, each one run of a
port runner, run one after another as subprocesses (the counterpart of the
``run()`` functions in ``experiments/*.sh``).

A cell is a name, a runner module, a config, the script's overrides and its save
path. For each cell, in order, ``run_cells``:

- skips it when the script's guard finds an earlier result under its save path
  (a checkpoint, for most scripts);
- runs ``python3 -m fab_tpu_torch.experiments.<runner> --config <config> --device
  <device> <overrides> evaluation.save_path=<root>/<save path>/ <trailing>``, where
  ``<trailing>`` are the study's own trailing ``key=value`` arguments, appended to
  every cell as the scripts' ``"$@"`` is;
- writes the run's output to ``<root>/logs/<cell log>.log``;
- with a backstop (``run_mw_method_study.sh``'s ``timeout 4800``), kills a run that
  outlives it and appends a FAILURE line to the study's ``FAILED`` file.

``<root>`` is ``results/torch`` under the repository (``--results-root``), so the
port's runs never overwrite a JAX run's ``results/``. ``--dry-run`` prints one line
per cell and runs nothing. ``--only NAME`` (repeatable) keeps the named cells.

The drivers of studies at length (``gmm_fab_cells``, ``mw_fab_cells``) share the rest
of this module: the cells run in turn (``run_in_turn``), each cell's summary from
its run (``summarise``), the overflow rule (``overflows``), the evaluation-seed
yardstick (``seed_spread``), a row's provenance, and the markdown that sets the
port's rows beside the reference's (``comparison``) in a README section of its own
(``write_section``).

The cells run one at a time on one card. ``run_gmm_method_study.sh`` ran two lanes
at once because its CPU host had two cores; that was a property of that host, not
of the study, so no study module takes a lane count.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

from fab_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIGS = os.path.join("experiments", "configs")
RESULTS = os.path.join("results", "torch")
# The scripts' skip guards, as globs under a cell's save path.
CHECKPOINT_GUARD = ("*/model_checkpoints/iter_*",)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    runner: str  # run_gmm | run_many_well
    config: str  # a file of experiments/configs
    overrides: tuple  # the script's dotted overrides, in its order, without the save path
    save_path: str  # the script's path under results/
    log: str  # the script's log-file stem


def parser(description: str, cells: bool = True) -> argparse.ArgumentParser:
    """--device (default cuda), --dry-run, --results-root, --only (a study of
    ``cells``), then the script's positional arguments and trailing key=value
    overrides."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dry-run", action="store_true", help="print the cells, run nothing")
    p.add_argument("--results-root", default=RESULTS,
                   help="where runs, logs and reports go (relative: to the repository)")
    if cells:
        p.add_argument("--only", action="append", default=None, metavar="NAME",
                       help="run only this cell (repeatable)")
    p.add_argument("args", nargs="*", help="the script's arguments, then key=value overrides")
    return p


def parse(p: argparse.ArgumentParser, argv):
    """Parsed arguments with ``positional`` (the script's own) and ``trailing``
    (the key=value overrides) split; the device is resolved before anything runs,
    so without a card a study raises unless given ``--device cpu``."""
    args = p.parse_args(argv)
    resolve_device(args.device)
    args.positional = [a for a in args.args if "=" not in a]
    args.trailing = [a for a in args.args if "=" in a]
    args.root = os.path.join(REPO, args.results_root)
    return args


def save_dir(args, cell: Cell) -> str:
    return os.path.join(args.root, cell.save_path)


def command(cell: Cell, args) -> list:
    """The cell's runner command line."""
    return [sys.executable, "-u", "-m", f"fab_tpu_torch.experiments.{cell.runner}",
            "--config", os.path.join(CONFIGS, cell.config), "--device", args.device,
            *cell.overrides, f"evaluation.save_path={save_dir(args, cell)}/",
            *args.trailing]


def select(cells: Sequence[Cell], args) -> list:
    if args.only is None:
        return list(cells)
    unknown = set(args.only) - {c.name for c in cells}
    if unknown:
        raise ValueError(f"no cell named {sorted(unknown)}; cells: {[c.name for c in cells]}")
    return [c for c in cells if c.name in args.only]


def print_cells(cells: Sequence[Cell], args) -> None:
    for cell in cells:
        print(f"{cell.name}: {' '.join([*cell.overrides, *args.trailing])} -> "
              f"{save_dir(args, cell)}/")


def _tail(path: str, n: int) -> list:
    with open(path, errors="replace") as f:
        return f.read().splitlines()[-n:]


def run_cells(cells: Sequence[Cell], args, tag: str, guard=CHECKPOINT_GUARD,
              timeout_s: Optional[float] = None, failed_file: Optional[str] = None,
              tail: int = 0, grep: Optional[str] = None) -> list:
    """Run (or with --dry-run print) ``cells`` in order; returns (cell, exit code)
    for each selected cell, the code None where the cell was not run. ``guard``:
    globs under a cell's save path whose match skips it (None: no guard).
    ``timeout_s``: the backstop; a run it kills is rc 124 and a FAILURE line in
    ``<root>/<failed_file>``. After a run, the last match of the regular expression
    ``grep`` in its log, then its log's last ``tail`` lines, are printed."""
    cells = select(cells, args)
    if args.dry_run:
        print_cells(cells, args)
        return [(cell, None) for cell in cells]
    results = []
    os.makedirs(os.path.join(args.root, "logs"), exist_ok=True)
    env = dict(os.environ, MPLBACKEND="Agg")
    for cell in cells:
        if guard and any(glob.glob(os.path.join(save_dir(args, cell), g)) for g in guard):
            print(f"skip {cell.name} (exists)")
            results.append((cell, None))
            continue
        log = os.path.join(args.root, "logs", f"{cell.log}.log")
        print(f"[{tag}] {cell.name} start {time.strftime('%H:%M:%S')}", flush=True)
        with open(log, "w") as out:
            try:
                rc = subprocess.run(command(cell, args), stdout=out, stderr=subprocess.STDOUT,
                                    cwd=REPO, env=env, timeout=timeout_s).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        if rc == 124 and failed_file is not None:
            line = f"[{tag}] FAILURE: {cell.name} KILLED by backstop timeout — cell missing"
            print(line)
            with open(os.path.join(args.root, failed_file), "a") as f:
                f.write(line + "\n")
        print(f"[{tag}] {cell.name} done rc={rc} {time.strftime('%H:%M:%S')}", flush=True)
        if grep is not None:
            with open(log, errors="replace") as f:
                hits = re.findall(grep, f.read())
            if hits:
                print(hits[-1])
        for ln in _tail(log, tail) if tail else ():
            print(ln)
        results.append((cell, rc))
    return results


# ------------------------------------------------------------ studies at length


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them, or "not read"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run_in_turn(cells, args, tag: str, failed_file: str) -> dict:
    """Each cell through ``run_cells`` in turn, with no skip guard and ``args.timeout``
    the backstop; name -> (exit code, wall s)."""
    one = argparse.Namespace(**{**vars(args), "only": None})
    done = {}
    for c in cells:
        t0 = time.time()
        ((_, rc),) = run_cells([c], one, tag, guard=None, timeout_s=args.timeout,
                               failed_file=failed_file)
        done[c.name] = (rc, time.time() - t0)
    return done


def to_float(v: str) -> float:
    try:
        return float(v)
    except ValueError:
        return math.nan


def write_csv(path: str, rows, first=("model_name",)) -> None:
    cols = list(first) + sorted({k for r in rows for k in r} - set(first))
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, restval="")
        writer.writeheader()
        writer.writerows(rows)


def read_csv(path: str) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def _flow_leaves(node, leaves: list) -> list:
    import numpy as np

    if isinstance(node, dict):
        for v in node.values():
            _flow_leaves(v, leaves)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _flow_leaves(v, leaves)
    elif isinstance(node, np.ndarray):
        leaves.append(node)
    return leaves


def summarise(root: str, name: str, save_dir: str, log: str, budget: int) -> dict:
    """What a cell's run left: the newest run directory under ``save_dir``, its
    ``logging_hist.csv`` (one row per logged chunk), its last checkpoint and the
    cell's log ``log``. The iteration reached against ``budget``, the logged rows and
    among them the non-finite losses and skipped updates, the last in-run
    ``eval_ess_flow``, whether the last checkpoint's flow parameters are finite,
    whether the step was compiled, the run resumed and the time limit stopped it,
    whether f32 products ran with TF32, the buffer fill's s and the wall time and
    median step that ``Trainer.run`` prints. Paths are relative to ``root``."""
    import numpy as np

    from fab_tpu_torch.checkpoint import load_checkpoint

    runs = [d for d in glob.glob(os.path.join(save_dir, "*", "")) if os.path.isdir(d)]
    out = {"cell": name, "budget_iterations": budget}
    if not runs:
        return dict(out, run_dir=None)
    run = max(runs, key=os.path.getmtime).rstrip(os.sep)
    out["run_dir"] = os.path.relpath(run, root)
    rows = []
    hist = os.path.join(run, "logging_hist.csv")
    if os.path.exists(hist):
        rows = read_csv(hist)
    train = [r for r in rows if r.get("loss", "") != ""]
    # Trainer logs its evals' keys bare, the buffer trainers with "_p_target".
    ess_key = "eval_ess_flow_p_target" if rows and "eval_ess_flow_p_target" in rows[0] \
        else "eval_ess_flow"
    evals = [r for r in rows if r.get(ess_key, "") != ""]
    out.update(
        iterations=int(to_float(train[-1]["step"])) if train else 0,
        logged_rows=len(train),
        nonfinite_losses=sum(not math.isfinite(to_float(r["loss"])) for r in train),
        skipped_updates=sum(to_float(r.get("update_applied", "1")) == 0 for r in train),
        last_eval_ess_flow=to_float(evals[-1][ess_key]) if evals else None,
        last_eval_step=int(to_float(evals[-1]["step"])) if evals else None,
    )
    ckpts = glob.glob(os.path.join(run, "model_checkpoints", "iter_*", "state.pkl"))
    if ckpts:
        last = max(ckpts, key=lambda p: int(p.split("iter_")[-1].split(os.sep)[0]))
        leaves = _flow_leaves(load_checkpoint(last)["params"]["flow"], [])
        finite = bool(leaves) and all(bool(np.isfinite(a).all()) for a in leaves)
        out.update(last_checkpoint=os.path.relpath(last, root), finite_params=finite)
    text = ""
    if os.path.exists(log):
        with open(log, errors="replace") as f:
            text = f.read()
    timing = re.findall(r"run timing: iterations \d+-\d+ in ([\d.]+) s; median step over "
                        r"the last 10 chunks ([\d.]+ ms|not measured)", text)
    fill = re.findall(r"buffer fill: \d+ rows in ([\d.]+) s", text)
    tf32 = re.findall(r"TF32 (on|off)", text)
    out.update(
        compiled="train step: compiled" in text,
        resumed="Resuming from" in text,
        tlimit_reached="tlimit reached" in text,
        tf32=tf32[-1] if tf32 else None,
        fill_s=float(fill[-1]) if fill else None,
        run_wall_s=float(timing[-1][0]) if timing else None,
        median_step_ms=(float(timing[-1][1].split()[0])
                        if timing and timing[-1][1] != "not measured" else None),
    )
    return out


def budget(cell: Cell, trailing=()) -> int:
    """The cell's iteration count from its configuration and ``trailing`` overrides
    (``get_n_iterations``)."""
    from fab_tpu_torch.experiments.setup_run import get_n_iterations
    from fab_tpu_torch.utils.training import apply_overrides, load_config

    cfg = apply_overrides(load_config(os.path.join(REPO, CONFIGS, cell.config)),
                          [*cell.overrides, *trailing])
    t, to = cfg.training, cfg.fab.transition_operator
    return get_n_iterations(t.n_iterations, t.n_flow_forward_pass, t.batch_size,
                            cfg.fab.loss_type, to.n_inner_steps,
                            cfg.fab.n_intermediate_distributions, to.type, t.use_buffer,
                            t.get("min_buffer_length"))


def write_summaries(cells, args, done) -> dict:
    """``<root>/cells.json``: each of ``cells`` whose save path exists under the root
    summed up (``summarise``, against the ``budget`` of the trailing overrides the
    cell ran with where the file records them, else the study's), merged into what
    the file held; a cell run now (``done``) also gets its exit code, process wall s,
    command, card and commit. Prints each row."""
    path = os.path.join(args.root, "cells.json")
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    for c in cells:
        if not os.path.isdir(save_dir(args, c)):
            continue
        trailing = table.get(c.name, {}).get("overrides", args.trailing)
        if c.name in done:
            trailing = args.trailing
        row = dict(table.get(c.name, {}), **summarise(
            args.root, c.name, save_dir(args, c),
            os.path.join(args.root, "logs", f"{c.log}.log"), budget(c, trailing)))
        if c.name in done:
            line = " ".join(command(c, args)).replace(sys.executable, "python3")
            row.update(rc=done[c.name][0], process_wall_s=round(done[c.name][1], 1),
                       overrides=list(args.trailing),
                       command=line.replace(REPO + os.sep, ""),
                       card=card() if args.device == "cuda" else "cpu", commit=args.commit)
        table[c.name] = row
        print(json.dumps(row), flush=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    return table


OVERFLOW_LOG_Q = -1e6


def overflows(row, log_q_columns) -> bool:
    """Whether an evaluation row's flow overflows on its test sets: rows left
    non-finite (``flow_test_set_n_nonfinite``, where the row reports it), or a mean
    log q in one of ``log_q_columns`` below OVERFLOW_LOG_Q or not finite (a column the
    row leaves empty does not overflow)."""
    n = row.get("flow_test_set_n_nonfinite", "")
    return (n != "" and float(n) > 0) or any(
        row.get(k, "") != "" and not float(row[k]) >= OVERFLOW_LOG_Q for k in log_q_columns)


def seed_spread(rows, overflow) -> dict:
    """The cross-evaluation's yardstick from rows of one checkpoint's evaluations at
    several evaluation seeds: per method and metric, the widest max - min over one
    checkpoint's evaluations, among the checkpoints none of whose evaluations
    ``overflow`` (such a flow's test-set metrics spread without bound)."""
    by_checkpoint = {}
    for r in rows:
        by_checkpoint.setdefault(r["model_name"], []).append(r)
    out = {}
    for name, same in by_checkpoint.items():
        if any(overflow(r) for r in same):
            continue
        widest = out.setdefault(name.rsplit("_seed", 1)[0], {})
        for k in (k for k in same[0] if k not in ("model_name", "eval_seed", "eval_noise")):
            values = [float(r[k]) for r in same]
            widest[k] = max(widest.get(k, 0.0), max(values) - min(values))
    return out


def provenance(cell: dict, evaluation: str) -> str:
    """A port row's provenance: where and how far its flow was trained, and
    ``evaluation``, how it was scored."""
    return (f"port on the card ({cell.get('card')}); commit {cell.get('commit')}; "
            f"iterations={cell['iterations']} of {cell['budget_iterations']}; "
            f"resumed={'yes' if cell.get('resumed') else 'no'}; {evaluation}")


def merged(new_rows, path: str, order) -> list:
    """The rows of ``new_rows`` named in ``order``, and those of the CSV at ``path``
    (an earlier report) that they do not replace, in that order."""
    rows = {r["model_name"]: r for r in (read_csv(path) if os.path.exists(path) else [])}
    rows.update({r["model_name"]: r for r in new_rows})
    return [rows[n] for n in order if n in rows]


def cell_line(name: str, c: dict, label: str = "") -> str:
    """A README line: ``label`` (what tells one study's cells from another's in one
    README), the cell's command and its summary (``write_summaries``)."""
    return (f"- {label}`{name}`: `{c.get('command')}`; commit "
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


def comparison(rows, ref, methods, test_set, overflow, describe, cross=None,
               spread=None, rtol=0.0) -> str:
    """Markdown: each method's and metric's three-seed range in the port's ``rows``
    and in the reference's ``ref``, an overflowing row (``overflow``; ``describe``
    says how, in words) left out of the ``test_set`` metrics' ranges, and each score
    of a port flow in ``cross`` (the reference package's evaluation of the same
    checkpoints) that lies more than twice ``spread`` (``seed_spread``) off the
    port's own, and more than ``rtol`` of it (the arithmetic's rounding, for a metric
    that no evaluation seed moves)."""
    method = lambda r: r["model_name"].rsplit("_seed", 1)[0]
    lines = ["", "## The port's three-seed ranges against fab_tpu's", "",
             "| Method | Metric | Port [min, max] | fab_tpu [min, max] | Overlap |",
             "|---|---|---|---|---|"]
    for m in methods:
        for k in [k for k in rows[0] if k not in ("model_name", "provenance")]:
            a = [float(r[k]) for r in rows
                 if method(r) == m and not (k in test_set and overflow(r))]
            b = [float(r[k]) for r in ref if method(r) == m and r.get(k, "") != ""]
            if a and b:
                lines.append(f"| {m} | `{k}` | [{min(a):.4g}, {max(a):.4g}] | "
                             f"[{min(b):.4g}, {max(b):.4g}] | "
                             f"{'yes' if min(a) <= max(b) and min(b) <= max(a) else 'no'} |")
    over = [r for r in rows if overflow(r)]
    if over:
        lines += ["", "Left out of the test-set metrics' ranges, their flows overflowing: "
                  + "; ".join(f"{r['model_name']} ({describe(r)})" for r in over) + "."]
    if cross is None:
        return "\n".join(lines) + "\n"
    port = {r["model_name"]: r for r in rows}
    lines += ["", "## fab_tpu's scores of the port's flows, more than twice the seed "
              "spread off", "", "| Row | Metric | Port | fab_tpu | Twice the spread |",
              "|---|---|---|---|---|"]
    scores = [(r, k, 2 * v) for r in cross for k, v in spread[method(r)].items()]
    off = [(r, k, two) for r, k, two in scores
           if not abs(float(r[k]) - float(port[r["model_name"]][k]))
           <= max(two, rtol * abs(float(port[r["model_name"]][k])))]
    lines += [f"| {r['model_name']} | `{k}` | {float(port[r['model_name']][k]):.4g} | "
              f"{float(r[k]):.4g} | {two:.4g} |" for r, k, two in off]
    lines.append(f"\n{len(off)} of {len(scores)} scores lie more than twice the spread off.")
    return "\n".join(lines) + "\n"


def read_section(path: str, heading: str) -> str:
    """The text of the README section that starts with the line ``heading`` (a
    level-1 heading) and runs to the next level-1 heading, or ""."""
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        text = f.read()
    sections = re.split(r"(?m)^(?=# )", text)
    return next((s for s in sections if s.split("\n", 1)[0] == heading), "")


def write_section(path: str, text: str) -> None:
    """Put ``text``, a README section whose first line is a level-1 heading, into
    the file at ``path``: in place of the section with that heading, else at the
    end; the other sections stay as they are, one blank line between two."""
    old = ""
    if os.path.exists(path):
        with open(path) as f:
            old = f.read()
    sections = [s.rstrip("\n") for s in re.split(r"(?m)^(?=# )", old) if s.strip()]
    heading = text.split("\n", 1)[0]
    at = [i for i, s in enumerate(sections) if s.split("\n", 1)[0] == heading]
    if at:
        sections[at[0]] = text.rstrip("\n")
    else:
        sections.append(text.rstrip("\n"))
    with open(path, "w") as f:
        f.write("\n\n".join(sections) + "\n")


@dataclasses.dataclass(frozen=True)
class Report:
    """What a study's ``report`` writes: its CSVs' names (under ``<root>/reports/``
    and in the output directory), the rows of its table and its cells in order, how
    a row was scored (``evaluation``) and how the reference package scored the same
    checkpoint (``cross_evaluation``), the LaTeX table's problem, and its README
    section: the head (a level-1 heading first), the head of the lines of runs that
    are not the study's cells, a cell's line (``(name, summary, label)`` -> text)
    with the label that starts its cell names and the comparison (``out`` ->
    markdown)."""
    rows_csv: str
    cross_csv: str
    spread_csv: str
    table_tex: str
    problem: str
    rows: Sequence[str]
    cells: Sequence[str]
    evaluation: str
    cross_evaluation: str
    head: str
    others_head: str
    comparison: Callable[[str], str]
    line: Callable[[str, dict, str], str] = cell_line
    label: str = ""


def row_name(cell: str) -> str:
    """A cell's row in the evaluation CSVs: ``<method>_s<N>`` -> ``<method>_seed<N>``."""
    method, seed = cell.rsplit("_s", 1)
    return f"{method}_seed{seed}"


def report(root: str, out: str, spec: Report) -> None:
    """Copy a study's rows into ``out`` with a provenance column: the port's rows
    (``<root>/reports/<rows_csv>``), their LaTeX table, the seed spread and, where
    present, the reference package's scores of the same checkpoints
    (``<root>/reports/<cross_csv>``); and the study's section of ``README.md``, one
    line per cell from ``<root>/cells.json``, the study's cells first, then any other
    run found there. What ``out`` already holds of a cell that ``<root>`` lacks (its
    rows, its scores, its line, the spread) is kept, so that a cell run later joins
    the report."""
    from fab_tpu_torch.experiments import latex_table

    with open(os.path.join(root, "cells.json")) as f:
        cells = json.load(f)
    by_row = {row_name(n): c for n, c in cells.items()}
    os.makedirs(out, exist_ok=True)
    rows = [r for r in read_csv(os.path.join(root, "reports", spec.rows_csv))
            if r["model_name"] in spec.rows]
    for r in rows:
        r["provenance"] = provenance(by_row[r["model_name"]], spec.evaluation)
    rows = merged(rows, os.path.join(out, spec.rows_csv), spec.rows)
    write_csv(os.path.join(out, spec.rows_csv), rows)
    with open(os.path.join(out, spec.table_tex), "w") as f:
        f.write(latex_table.table(rows, spec.problem))
    if os.path.exists(os.path.join(root, "reports", spec.spread_csv)):
        rows = read_csv(os.path.join(root, "reports", spec.spread_csv))
        kept = os.path.join(out, spec.spread_csv)
        new = {r["model_name"] for r in rows}
        rows = [r for r in (read_csv(kept) if os.path.exists(kept) else [])
                if r["model_name"] not in new] + rows
        write_csv(kept, rows)
    cross = os.path.join(root, "reports", spec.cross_csv)
    if os.path.exists(cross):
        rows = [r for r in read_csv(cross) if r["model_name"] in spec.rows]
        for r in rows:
            r["provenance"] = (f"{spec.cross_evaluation}, of the port's checkpoint "
                               f"{by_row[r['model_name']]['last_checkpoint']}")
        write_csv(os.path.join(out, spec.cross_csv),
                  merged(rows, os.path.join(out, spec.cross_csv), spec.rows))
    readme = os.path.join(out, "README.md")
    earlier = {}
    for ln in read_section(readme, spec.head.split("\n", 1)[0]).splitlines():
        m = re.match(r"- " + re.escape(spec.label) + r"`(\w+_s\d+)`: ", ln)
        if m:
            earlier[m.group(1)] = ln
    lines = {**earlier, **{name: spec.line(name, c, spec.label) for name, c in cells.items()}}
    study_lines = [lines.get(n, f"- {spec.label}`{n}`: not run.") for n in spec.cells]
    others = [lines[n] for n in sorted(lines) if n not in spec.cells]
    text = spec.head + "\n".join(study_lines)
    if others:
        text += "\n\n" + spec.others_head + "\n".join(others)
    write_section(readme, text.replace(sys.executable, "python3") + "\n"
                  + spec.comparison(out))
