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

The cells run one at a time on one card. ``run_gmm_method_study.sh`` ran two lanes
at once because its CPU host had two cores; that was a property of that host, not
of the study, so no study module takes a lane count.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import re
import subprocess
import sys
import time
from typing import Optional, Sequence

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
