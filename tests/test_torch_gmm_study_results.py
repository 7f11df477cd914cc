"""GMM-40's FAB cells as the port trained and evaluated them on the card
(``fab_tpu_torch/reports/``), held against fab_tpu's rows (``reports/gmm_study_results.csv``).

- Provenance: every port row names the card and its power limit, and reached the
  iteration count ``get_n_iterations`` gives its method at gmm.yaml's budget.
- Cross-evaluation: fab_tpu's evaluator scores each port checkpoint within twice the
  port's own seed-to-seed spread of that metric (two evaluation seeds of one checkpoint
  per method), metric by metric.
- The rule between the packages: for each method and each metric both CSVs fill, the
  port's three-seed range [min, max] overlaps fab_tpu's.
- The paper's ordering: fab_buffer's mean ``eval_ess_flow`` above fab_no_buffer's.

A metric that breaks a rule is a gap, listed below with its ROADMAP Queue 3 entry and
held strictly: a listed gap that closes fails, and so does one that is not listed.
"""
import csv
import math
import pathlib
import re
import statistics

import pytest

from fab_tpu_torch.experiments.setup_run import get_n_iterations

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "fab_tpu_torch" / "reports"
METHODS = ("fab_no_buffer", "fab_buffer")
METRICS = ("ais_bias_no_correction", "ais_bias_normed", "eval_ess_ais", "eval_ess_flow",
           "flow_bias_no_correction", "flow_bias_normed", "flow_ess_over_p",
           "flow_kl_forward", "flow_test_set_mean_log_prob", "flow_test_set_n_nonfinite")
# fab_tpu's fab_buffer rows fill six columns; its fab_no_buffer rows fill all.
BOTH_FILL = [("fab_no_buffer", m) for m in METRICS] + [
    ("fab_buffer", m) for m in ("eval_ess_ais", "eval_ess_flow", "flow_bias_no_correction",
                                "flow_bias_normed", "flow_kl_forward",
                                "flow_test_set_mean_log_prob")]
# Cells the port has no row for, and why.
NOT_RUN = {"fab_buffer_seed2": "not run: the chip budget (ROADMAP Queue 1)"}
# (method, metric) whose ranges do not overlap -> its ROADMAP Queue 3 entry.
Q3_TAILS = "ROADMAP Queue 3: fab_no_buffer's unweighted biases"
Q3_ESS = "ROADMAP Queue 3: fab_buffer's eval_ess_flow at evaluation seed 0"
Q3_KL = "ROADMAP Queue 3: fab_buffer's forward KL, below fab_tpu's three seeds"
GAPS = {
    ("fab_no_buffer", "ais_bias_no_correction"): Q3_TAILS,
    ("fab_no_buffer", "flow_bias_no_correction"): Q3_TAILS,
    ("fab_buffer", "eval_ess_flow"): Q3_ESS,
    ("fab_buffer", "flow_kl_forward"): Q3_KL,
}
# (model_name, metric) where fab_tpu's score of a port flow is off the port's by more
# than twice the seed spread -> its ROADMAP Queue 3 entry.
Q3_CROSS = "ROADMAP Queue 3: the cross-evaluation against one pair of evaluation seeds"
CROSS_GAPS = {key: Q3_CROSS for key in [
    ("fab_no_buffer_seed1", "ais_bias_no_correction"),
    ("fab_no_buffer_seed1", "ais_bias_normed"),
    ("fab_no_buffer_seed1", "flow_bias_no_correction"),
    ("fab_no_buffer_seed1", "flow_kl_forward"),
    ("fab_no_buffer_seed1", "flow_test_set_mean_log_prob"),
    ("fab_no_buffer_seed2", "ais_bias_no_correction"),
    ("fab_no_buffer_seed2", "flow_bias_no_correction"),
    ("fab_buffer_seed0", "flow_ess_over_p"),
    ("fab_buffer_seed0", "flow_kl_forward"),
    ("fab_buffer_seed0", "flow_test_set_mean_log_prob"),
    ("fab_buffer_seed1", "ais_bias_no_correction"),
    ("fab_buffer_seed1", "flow_ess_over_p"),
    ("fab_buffer_seed1", "flow_test_set_mean_log_prob"),
]}
# gmm.yaml's budget in iterations: 2 flow evaluations per row without the buffer, 3
# with it after the buffer's fill (get_n_iterations).
BUDGET = {
    "fab_no_buffer": get_n_iterations(None, 20_000_000, 128, "fab_alpha_div", 1, 1,
                                      "metropolis", False, 1280),
    "fab_buffer": get_n_iterations(None, 20_000_000, 128, "fab_alpha_div", 1, 1,
                                   "metropolis", True, 1280),
}


def _rows(path):
    with open(path) as f:
        return {r["model_name"]: r for r in csv.DictReader(f)}


def _method(name):
    return name.rsplit("_seed", 1)[0]


def _values(rows, method, metric):
    return [float(r[metric]) for n, r in rows.items()
            if _method(n) == method and r.get(metric, "") != ""]


@pytest.fixture(scope="module")
def tables():
    return {"port": _rows(PORT / "gmm_study_results.csv"),
            "fab_tpu": _rows(ROOT / "reports" / "gmm_study_results.csv"),
            "cross": _rows(PORT / "gmm_study_results_fab_tpu_eval.csv")}


def test_the_budget_is_the_papers():
    assert BUDGET == {"fab_no_buffer": 78_125, "fab_buffer": 52_076}


def test_port_rows_name_the_card_and_reach_the_budget(tables):
    port = tables["port"]
    want = {f"{m}_seed{s}" for m in METHODS for s in range(3)} - set(NOT_RUN)
    assert set(port) == want, sorted(port)
    for name, row in port.items():
        prov = row["provenance"]
        assert re.search(r"NVIDIA H100[^;]*, \d+\.\d+ W", prov), (name, prov)
        reached, budget = map(int, re.search(r"iterations=(\d+) of (\d+)", prov).groups())
        assert reached == budget == BUDGET[_method(name)], (name, prov)
        assert "resumed=no" in prov, (name, prov)
        assert all(math.isfinite(float(row[m])) for m in METRICS), name


def test_the_readme_has_a_line_per_cell():
    text = (PORT / "README.md").read_text()
    for method in METHODS:
        for seed in range(3):
            (line,) = [ln for ln in text.splitlines() if ln.startswith(f"- `{method}_s{seed}`")]
            if f"{method}_seed{seed}" in NOT_RUN:
                assert "not run" in line
            else:
                assert "NVIDIA H100" in line and f"{BUDGET[method]} of {BUDGET[method]}" in line


def _spread():
    with open(PORT / "gmm_eval_seed_spread.csv") as f:
        rows = list(csv.DictReader(f))
    out = {}
    for method in METHODS:
        pair = [r for r in rows if _method(r["model_name"]) == method]
        assert sorted(int(r["eval_seed"]) for r in pair) == [0, 1], method
        out[method] = {m: abs(float(pair[0][m]) - float(pair[1][m])) for m in METRICS}
    return out


def test_fab_tpus_scores_of_the_port_flows_are_within_twice_the_seed_spread(tables):
    port, cross, spread = tables["port"], tables["cross"], _spread()
    assert set(cross) == set(port)
    off = {}
    for name, row in cross.items():
        for metric in METRICS:
            d = abs(float(row[metric]) - float(port[name][metric]))
            if not d <= 2 * spread[_method(name)][metric]:
                off[(name, metric)] = (float(port[name][metric]), float(row[metric]),
                                       2 * spread[_method(name)][metric])
    assert set(off) == set(CROSS_GAPS), off


@pytest.mark.parametrize("method, metric", BOTH_FILL, ids=[f"{a}-{b}" for a, b in BOTH_FILL])
def test_the_port_range_overlaps_fab_tpus(tables, method, metric):
    port = _values(tables["port"], method, metric)
    ref = _values(tables["fab_tpu"], method, metric)
    assert len(ref) == 3 and len(port) == 3 - sum(_method(n) == method for n in NOT_RUN)
    overlap = min(port) <= max(ref) and min(ref) <= max(port)
    what = (f"{method} {metric}: port [{min(port)}, {max(port)}], "
            f"fab_tpu [{min(ref)}, {max(ref)}]; listed gap: {GAPS.get((method, metric))}")
    assert overlap != ((method, metric) in GAPS), what


def test_both_fill_lists_every_shared_metric(tables):
    shared = {(m, k) for m in METHODS for k in METRICS
              if _values(tables["port"], m, k) and _values(tables["fab_tpu"], m, k)}
    assert shared == set(BOTH_FILL)


def test_the_buffer_beats_no_buffer_in_flow_ess(tables):
    mean = {m: statistics.mean(_values(tables["port"], m, "eval_ess_flow")) for m in METHODS}
    assert mean["fab_buffer"] > mean["fab_no_buffer"], mean
