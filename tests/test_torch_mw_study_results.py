"""ManyWell-32's FAB cells as the port trained and evaluated them on the card
(``fab_tpu_torch/reports/``, ``mw_fab_cells``), held against fab_tpu's rows
(``reports/mw_study_results.csv``: the method study at the same budget, f32, 20,480
samples).

- Provenance: every port row names the card and its power limit, and reached the
  iteration count ``get_n_iterations`` gives its method at the study's budget (4,963
  and 5,231), not stopped by the time limit and not resumed.
- Overflow: a port row whose flow's mean log q on the exact samples or on the mode
  test set lies below -1e6 or is not finite (``mw_fab_cells.overflows``) is a gap of
  its own (``OVERFLOWS``).
- Cross-evaluation: fab_tpu's evaluator scores each port checkpoint within twice the
  port's own evaluation-seed spread of that metric, or, for a metric no evaluation seed
  moves (the mode grid's mean log q), within f32 rounding (1e-5 relative). The spread is
  ``mw_fab_cells.seed_spread`` of ``mw_eval_seed_spread.csv``: per method, the widest
  max - min over one checkpoint's evaluations, among checkpoints whose test sets all
  stay finite.
- The rule between the packages: for each method and each metric both CSVs fill, the
  port's three-seed range [min, max] overlaps fab_tpu's; an overflowing row is left
  out of the test-set metrics' ranges.
- The paper's ordering: fab_buffer's mean beats fab_no_buffer's on ``eval_ess_flow``
  (higher), ``flow_forward_kl`` and ``ais_abs_MSE_log_Z_estimate`` (lower).
- The committed table and comparison are what ``mw_fab_cells`` makes of the rows.

A metric that breaks a rule is a gap, listed below with its ROADMAP Queue 3 entry and
held strictly: a listed gap that closes fails, and so does one that is not listed.
The test reads CSVs only.
"""
import math
import re
import statistics

import pytest

from fab_tpu_torch.experiments import latex_table, mw_fab_cells, study
from fab_tpu_torch.experiments.mw_fab_cells import F32_RTOL, TEST_SET, overflows, seed_spread
from fab_tpu_torch.experiments.setup_run import get_n_iterations

ROOT = mw_fab_cells.study.REPO
PORT = f"{ROOT}/fab_tpu_torch/reports"
METHODS = mw_fab_cells.METHODS
# fab_tpu's rows fill these nine columns, and so do the port's.
METRICS = ("ais_abs_MSE_log_Z_estimate", "ais_relative_MSE_Z_estimate", "eval_ess_ais",
           "eval_ess_flow", "flow_abs_MSE_log_Z_estimate", "flow_forward_kl",
           "flow_relative_MSE_Z_estimate", "flow_test_set_exact_mean_log_prob",
           "flow_test_set_modes_mean_log_prob")
BOTH_FILL = [(m, k) for m in METHODS for k in METRICS]
# Port rows whose flow overflows on a test set -> its ROADMAP Queue 3 entry.
OVERFLOWS = {}
# (method, metric) whose ranges do not overlap -> its ROADMAP Queue 3 entry.
Q3_ONE_SEED = "ROADMAP Queue 3: ManyWell-32's rows at one evaluation seed"
GAPS = {
    ("fab_buffer", "flow_test_set_exact_mean_log_prob"): Q3_ONE_SEED,
    ("fab_no_buffer", "eval_ess_flow"): Q3_ONE_SEED,
}
# (model_name, metric) where fab_tpu's score of a port flow is off the port's by more
# than twice the evaluation-seed spread (and by more than f32 rounding,
# ``mw_fab_cells.F32_RTOL``) -> its ROADMAP Queue 3 entry.
Q3_Z = "ROADMAP Queue 3: fab_no_buffer's relative Z errors in the cross-evaluation"
CROSS_GAPS = {key: Q3_Z for key in [
    ("fab_no_buffer_seed0", "ais_relative_MSE_Z_estimate"),
    ("fab_no_buffer_seed0", "flow_relative_MSE_Z_estimate"),
    ("fab_no_buffer_seed1", "ais_relative_MSE_Z_estimate"),
    ("fab_no_buffer_seed1", "flow_relative_MSE_Z_estimate"),
]}
# The paper's ordering: metric -> +1 where higher is better, -1 where lower is.
ORDER = {"eval_ess_flow": 1, "flow_forward_kl": -1, "ais_abs_MSE_log_Z_estimate": -1}
# Metrics on which fab_buffer's mean does not beat fab_no_buffer's -> Queue 3 entry.
ORDER_GAPS = {}
# The study's budget in iterations: an AIS pass is 5 x 4 + 1 flow evaluations a row, a
# buffer run adds one replay evaluation a row and its fill of 65,536 rows.
BUDGET = {m: get_n_iterations(None, 225_000_000, 2048, "fab_alpha_div", 5, 4, "hmc",
                              m == "fab_buffer", 65536) for m in METHODS}


def _rows(path):
    return {r["model_name"]: r for r in study.read_csv(path)}


def _method(name):
    return name.rsplit("_seed", 1)[0]


def _values(rows, method, metric):
    """The metric's values over the method's rows; an overflowing row's test-set
    metrics are left out."""
    return [float(r[metric]) for n, r in rows.items()
            if _method(n) == method and r.get(metric, "") != ""
            and not (metric in TEST_SET and overflows(r))]


@pytest.fixture(scope="module")
def tables():
    return {"port": _rows(f"{PORT}/mw_study_results.csv"),
            "fab_tpu": _rows(f"{ROOT}/reports/mw_study_results.csv"),
            "cross": _rows(f"{PORT}/mw_study_results_fab_tpu_eval.csv")}


def test_the_budget_is_the_studys():
    assert BUDGET == {"fab_buffer": 4963, "fab_no_buffer": 5231}


def test_port_rows_name_the_card_and_reach_the_budget(tables):
    port = tables["port"]
    assert set(port) == set(mw_fab_cells.STUDY_ROWS), sorted(port)
    for name, row in port.items():
        prov = row["provenance"]
        assert re.search(r"NVIDIA H100[^;]*, \d+\.\d+ W", prov), (name, prov)
        reached, budget = map(int, re.search(r"iterations=(\d+) of (\d+)", prov).groups())
        assert reached == budget == BUDGET[_method(name)], (name, prov)
        assert "resumed=no" in prov and "f32" in prov, (name, prov)
        assert all(r != "" for r in (row[m] for m in METRICS)), name


def test_the_readme_has_a_line_per_cell():
    text = study.read_section(f"{PORT}/README.md", mw_fab_cells.README_HEAD.split("\n")[0])
    for name in mw_fab_cells.CELLS:
        n = BUDGET[name.rsplit("_s", 1)[0]]
        start = f"- {mw_fab_cells.LABEL}`{name}`"
        (line,) = [ln for ln in text.splitlines() if ln.startswith(start)]
        for want in ("NVIDIA H100", f"{n} of {n} iterations", "step compiled", "TF32 off",
                     "final parameters finite: True", "stopped by training.tlimit: no",
                     "exit code 0"):
            assert want in line, (name, want, line)


def test_overflowing_flows_are_listed(tables):
    over = {n: [row[k] for k in mw_fab_cells.LOG_Q]
            for n, row in tables["port"].items() if overflows(row)}
    assert set(over) == set(OVERFLOWS), over


def _spread():
    rows = study.read_csv(f"{PORT}/mw_eval_seed_spread.csv")
    names = {r["model_name"] for r in rows}
    assert {_method(n) for n in names} == set(METHODS), names
    for name in names:
        seeds = [int(r["eval_seed"]) for r in rows if r["model_name"] == name]
        assert sorted(seeds) == list(mw_fab_cells.SPREAD_SEEDS), (name, seeds)
    spread = seed_spread(rows)
    assert set(spread) == set(METHODS), spread
    for method, by_metric in spread.items():
        finite = [r for r in rows if _method(r["model_name"]) == method and not overflows(r)]
        for metric in METRICS:
            median = statistics.median(abs(float(r[metric])) for r in finite)
            assert math.isfinite(by_metric[metric]), (method, metric, by_metric[metric])
            assert by_metric[metric] <= 10 * median, (method, metric, by_metric[metric],
                                                      median)
    return spread


def test_fab_tpus_scores_of_the_port_flows_are_within_twice_the_seed_spread(tables):
    port, cross, spread = tables["port"], tables["cross"], _spread()
    assert set(cross) == set(port)
    off = {}
    for name, row in cross.items():
        assert "fab_tpu's experiments/evaluate.py on the CPU" in row["provenance"], name
        for metric in METRICS:
            mine = float(port[name][metric])
            d = abs(float(row[metric]) - mine)
            if not d <= max(2 * spread[_method(name)][metric], F32_RTOL * abs(mine)):
                off[(name, metric)] = (float(port[name][metric]), float(row[metric]),
                                       2 * spread[_method(name)][metric])
    assert set(off) == set(CROSS_GAPS), off


@pytest.mark.parametrize("method, metric", BOTH_FILL, ids=[f"{a}-{b}" for a, b in BOTH_FILL])
def test_the_port_range_overlaps_fab_tpus(tables, method, metric):
    port = _values(tables["port"], method, metric)
    ref = _values(tables["fab_tpu"], method, metric)
    over = sum(_method(n) == method for n in OVERFLOWS) if metric in TEST_SET else 0
    assert len(ref) == 3 and len(port) == 3 - over
    overlap = min(port) <= max(ref) and min(ref) <= max(port)
    what = (f"{method} {metric}: port [{min(port)}, {max(port)}], "
            f"fab_tpu [{min(ref)}, {max(ref)}]; listed gap: {GAPS.get((method, metric))}")
    assert overlap != ((method, metric) in GAPS), what


@pytest.mark.parametrize("metric", sorted(ORDER))
def test_the_papers_ordering(tables, metric):
    mean = {m: statistics.mean(_values(tables["port"], m, metric)) for m in METHODS}
    beats = ORDER[metric] * (mean["fab_buffer"] - mean["fab_no_buffer"]) > 0
    assert beats != (metric in ORDER_GAPS), (metric, mean, ORDER_GAPS.get(metric))


def test_the_committed_table_and_comparison_are_the_drivers():
    rows = study.read_csv(f"{PORT}/mw_study_results.csv")
    with open(f"{PORT}/mw_study_table.tex") as f:
        assert f.read() == latex_table.table(rows, "many_well")
    text = study.read_section(f"{PORT}/README.md", mw_fab_cells.README_HEAD.split("\n")[0])
    assert text.endswith(mw_fab_cells.comparison(PORT))
