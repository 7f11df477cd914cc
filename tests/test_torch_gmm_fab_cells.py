"""``gmm_fab_cells`` end to end on the CPU at a tiny size: two cells (one of each
method) run one after another as study cells, each summed up from its run; where
their flows put their mass (``--tails``); ``eval_gmm_study`` on
their runs, the seed spread, and the committed files and README that ``--report``
writes from them."""
import csv
import json

from fab_tpu_torch.experiments import eval_gmm_study, gmm_fab_cells
from torch_parity_utils import one_torch_thread  # noqa: F401

WIDTHS = ["flow.n_layers=2", "flow.layer_nodes_per_dim=4",
          "target.true_expectation_n_samples=1000"]
TINY = WIDTHS + ["training.batch_size=32", "training.n_flow_forward_pass=null",
                 "training.n_iterations=60", "evaluation.eval_batch_size=64",
                 "training.min_buffer_length=64", "training.maximum_buffer_length=256"]
CELLS = ["fab_no_buffer_s1", "fab_buffer_s0"]


def test_cells_run_as_processes_and_report(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = tmp_path / "torch"
    only = [a for name in CELLS for a in ("--only", name)]
    table = gmm_fab_cells.main(["--device", "cpu", "--results-root", str(root), *only,
                                "--commit", "REF", *TINY])
    assert sorted(table) == sorted(CELLS)
    for name, row in table.items():
        assert row["rc"] == 0 and row["compiled"] and not row["resumed"], row
        assert row["iterations"] == row["budget_iterations"] == 60, row
        assert row["logged_rows"] >= 3 and row["finite_params"], row
        assert row["median_step_ms"] is not None and row["run_wall_s"] > 0, row
        assert row["last_eval_step"] == 60 and row["last_eval_ess_flow"] > 0, row
        assert row["card"] == "cpu" and row["commit"] == "REF", row
        assert row["command"].startswith("python3 -u -m fab_tpu_torch.experiments.run_gmm "), row
        assert f"evaluation.save_path={root}/" in row["command"], row
    assert (root / "logs" / "gmm_study_fab_alpha_div_s1.log").exists()
    assert (root / "logs" / "gmm_buffer_f64_s0.log").exists()
    assert json.loads((root / "cells.json").read_text()) == table

    found = eval_gmm_study.main(["--device", "cpu", "--results-root", str(root), "500",
                                 *WIDTHS])
    assert [n for n, _ in found] == ["fab_no_buffer_seed1", "fab_buffer_seed0"]
    spread = gmm_fab_cells.main(["--device", "cpu", "--spread", "--num-samples", "500",
                                 "--results-root", str(root), *WIDTHS])
    assert [(r["model_name"], r["eval_seed"]) for r in spread] == [
        ("fab_no_buffer_seed1", 0), ("fab_no_buffer_seed1", 1), ("fab_buffer_seed0", 0),
        ("fab_buffer_seed0", 1)]

    tails = gmm_fab_cells.main(["--device", "cpu", "--num-samples", "500", *WIDTHS, "--tails",
                                *(f"{n}={root / r['last_checkpoint']}" for n, r in table.items())])
    for name in CELLS:
        (line,) = [ln for ln in tails.splitlines() if ln.startswith(f"| {name} |")]
        left_out, bias, far, far_sum, near_bias = (float(v) for v in line.split("|")[2:7])
        assert 0 <= left_out < 500 and 0 <= far <= 1 and bias >= 0 and near_bias >= 0, line

    out = tmp_path / "reports"
    gmm_fab_cells.main(["--summary", "--report", str(out), "--results-root", str(root)])
    with open(out / "gmm_study_results.csv") as f:
        rows = {r["model_name"]: r for r in csv.DictReader(f)}
    assert sorted(rows) == ["fab_buffer_seed0", "fab_no_buffer_seed1"]
    for name, row in rows.items():
        assert "iterations=60 of" in row["provenance"] and "resumed=no" in row["provenance"]
        assert row["eval_ess_flow"] == next(
            r for r in csv.DictReader(open(root / "reports" / "gmm_study_results.csv"))
            if r["model_name"] == name)["eval_ess_flow"]
    readme = (out / "README.md").read_text()
    assert readme.count(": not run.") == 4 and "| fab_buffer | `eval_ess_flow` |" in readme
    assert "fab\\_buffer" in (out / "gmm_study_table.tex").read_text()
    assert (out / "gmm_eval_seed_spread.csv").exists()


def _hist(path, rows):
    path.mkdir(parents=True)
    cols = ["ess_base", "ess_ais", "loss", "update_applied", "step", "eval_ess_flow",
            "flow_bias_no_correction", "flow_kl_forward"]
    with open(path / "logging_hist.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, restval="")
        writer.writeheader()
        writer.writerows(rows)


def test_trajectory_tables_runs_side_by_side(tmp_path):
    train = lambda step, ess, applied=1: dict(ess_base=ess, ess_ais=ess / 2, loss=1.0,
                                              update_applied=applied, step=step)
    evals = lambda step, ess: dict(step=step, eval_ess_flow=ess, flow_bias_no_correction=0.5,
                                   flow_kl_forward=2.0)
    _hist(tmp_path / "a", [train(10, 0.1), train(20, 0.3), train(30, float("nan")),
                           train(40, 0.5, 0), evals(40, 0.25)])
    _hist(tmp_path / "b", [train(10, 0.2), train(20, 0.2), evals(20, 0.125)])
    runs = [("a", str(tmp_path / "a")), ("b", str(tmp_path / "b"))]
    assert gmm_fab_cells.main(["--trajectory", *(f"{n}={p}" for n, p in runs)]) == \
        gmm_fab_cells.trajectory(runs)
    text = gmm_fab_cells.trajectory(runs, n_windows=2)
    # Two spans of 20 iterations; the NaN left out of the median; one skipped update.
    assert "| Iterations | a | b |" in text
    assert "| 1-20 | 0.2 | 0.2 |" in text and "| 21-40 | 0.5 | - |" in text
    assert "| 21-40 | 1 | 0 |" in text
    assert "| 20 | - | 0.125 / 0.5 / 2 |" in text and "| 40 | 0.25 / 0.5 / 2 | - |" in text
