"""``gmm_fab_cells`` end to end on the CPU at a tiny size: two cells (one of each
method) run one after another as study cells, each summed up from its run; where
their flows put their mass (``--tails``); ``eval_gmm_study`` on
their runs, the seed spread, and the committed files and README that ``--report``
writes from them."""
import csv
import json

from fab_tpu_torch.experiments import eval_gmm_study, gmm_fab_cells, study
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
    assert [(r["model_name"], r["eval_noise"], r["eval_seed"]) for r in spread] == [
        (name, noise, seed) for name in ("fab_no_buffer_seed1", "fab_buffer_seed0")
        for noise, seeds in (("device", range(5)), ("cpu", range(3))) for seed in seeds]
    # On the CPU, CPU-served evaluation noise is the device's.
    by = {(r["model_name"], r["eval_noise"], r["eval_seed"]): r for r in spread}
    for (name, noise, seed), r in by.items():
        assert r == dict(by[(name, "device", seed)], eval_noise=noise)

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


def test_a_later_cell_joins_the_report(tmp_path):
    """``--report`` from a root that holds one study cell and one noise-study run
    merges them into an earlier report: the cell's rows and scores replace its own,
    every other row, score and line stays as it was, and the noise run gets a line of
    its own but no study row. The root's seed spread replaces the rows of the
    checkpoint it evaluated and keeps the others."""
    import pathlib
    import shutil

    committed = pathlib.Path(__file__).resolve().parents[1] / "fab_tpu_torch" / "reports"
    out, root = tmp_path / "out", tmp_path / "root"
    shutil.copytree(committed, out)
    (root / "reports").mkdir(parents=True)
    before = {p.name: p.read_text() for p in out.iterdir()}
    rows = {r["model_name"]: r for r in csv.DictReader(open(out / "gmm_study_results.csv"))}
    cross = {r["model_name"]: r for r in csv.DictReader(
        open(out / "gmm_study_results_fab_tpu_eval.csv"))}
    new = lambda r, **kw: dict({k: v for k, v in r.items() if k != "provenance"}, **kw)
    study.write_csv(root / "reports" / "gmm_study_results.csv", [
        new(rows["fab_buffer_seed2"], eval_ess_flow="0.5"),
        new(rows["fab_buffer_seed2"], model_name="fab_no_buffer_seed3")])
    study.write_csv(root / "reports" / "gmm_study_results_fab_tpu_eval.csv",
                             [new(cross["fab_buffer_seed2"], eval_ess_flow="0.25")])
    spread = list(csv.DictReader(open(out / "gmm_eval_seed_spread.csv")))
    evaluated = [dict(r, eval_ess_flow="0.75") for r in spread
                 if r["model_name"] == "fab_buffer_seed2"][:2]
    assert evaluated and len(spread) > len(evaluated) + 2
    study.write_csv(root / "reports" / "gmm_eval_seed_spread.csv", evaluated)
    summary = dict(command="CMD", commit="REF", card="NVIDIA H100 80GB HBM3, 700.00 W",
                   iterations=52076, budget_iterations=52076, compiled=True,
                   nonfinite_losses=0, skipped_updates=0, logged_rows=5209, rc=0,
                   last_checkpoint="ck.pkl")
    (root / "cells.json").write_text(json.dumps(
        {"fab_buffer_s2": summary, "fab_no_buffer_s3": dict(summary, command="CMD3")}))
    gmm_fab_cells.report(str(root), str(out))
    got = {r["model_name"]: r for r in csv.DictReader(open(out / "gmm_study_results.csv"))}
    assert list(got) == list(rows) and got["fab_buffer_seed2"]["eval_ess_flow"] == "0.5"
    assert all(got[n] == rows[n] for n in rows if n != "fab_buffer_seed2")
    assert "commit REF" in got["fab_buffer_seed2"]["provenance"]
    scores = {r["model_name"]: r for r in csv.DictReader(
        open(out / "gmm_study_results_fab_tpu_eval.csv"))}
    assert list(scores) == list(cross) and scores["fab_buffer_seed2"]["eval_ess_flow"] == "0.25"
    assert all(scores[n] == cross[n] for n in cross if n != "fab_buffer_seed2")
    merged = list(csv.DictReader(open(out / "gmm_eval_seed_spread.csv")))
    assert merged == [r for r in spread if r["model_name"] != "fab_buffer_seed2"] + evaluated
    old = {ln.split(":")[0]: ln for ln in before["README.md"].splitlines() if ln.startswith("- `")}
    text = (out / "README.md").read_text()
    lines = {ln.split(":")[0]: ln for ln in text.splitlines() if ln.startswith("- `")}
    assert lines["- `fab_buffer_s2`"].startswith("- `fab_buffer_s2`: `CMD`; commit REF")
    assert lines["- `fab_no_buffer_s3`"].startswith("- `fab_no_buffer_s3`: `CMD3`")
    assert all(lines[k] == v for k, v in old.items()
               if k not in ("- `fab_buffer_s2`", "- `fab_no_buffer_s3`"))
    assert text.index("- `fab_buffer_s2`") < text.index("The noise study's runs") < \
        text.index("- `fab_no_buffer_s3`")


def test_fab_tpus_own_runs_get_their_provenance(tmp_path):
    """``--fab-tpu-report``: each scored row of fab_tpu's runs with the iterations its
    run logged last and its wall time, from the run directory's time stamp to its
    last checkpoint."""
    import os
    import time

    run = tmp_path / "seed1" / "2026-01-02_03-04-05"
    _hist(run, [dict(step=10, loss=1.0), dict(step=20, loss=2.0),
                dict(step=20, eval_ess_flow=0.5)])
    ckpt = run / "model_checkpoints" / "iter_20"
    ckpt.mkdir(parents=True)
    start = time.mktime(time.strptime("2026-01-02_03-04-05", "%Y-%m-%d_%H-%M-%S"))
    os.utime(ckpt, (start + 75, start + 75))
    scores = tmp_path / "scores.csv"
    study.write_csv(scores, [dict(model_name="fab_buffer_seed1", flow_kl_forward=0.5)])
    rows = gmm_fab_cells.main(["--fab-tpu-report", str(tmp_path / "out"), "--fab-tpu-eval",
                               str(scores), "--fab-tpu-run", f"fab_buffer_seed1={run}",
                               "--commit", "TREE"])
    (row,) = rows
    assert row["flow_kl_forward"] == "0.5" and "TREE" in row["provenance"]
    assert "iterations=20 of 52076; wall 75 s" in row["provenance"], row["provenance"]
    assert [r["model_name"] for r in csv.DictReader(
        open(tmp_path / "out" / gmm_fab_cells.FAB_TPU_CPU_CSV))] == ["fab_buffer_seed1"]


def test_the_committed_gmm_report_is_what_the_driver_makes_of_its_rows():
    """The committed table and the README section's comparison are what
    ``gmm_fab_cells`` writes from the committed rows (no drift since they were made)."""
    import pathlib

    from fab_tpu_torch.experiments import latex_table

    port = pathlib.Path(__file__).resolve().parents[1] / "fab_tpu_torch" / "reports"
    rows = study.read_csv(port / "gmm_study_results.csv")
    assert (port / "gmm_study_table.tex").read_text() == latex_table.table(rows, "gmm")
    section = study.read_section(str(port / "README.md"),
                                 gmm_fab_cells.README_HEAD.split("\n", 1)[0])
    assert section.startswith(gmm_fab_cells.README_HEAD)
    assert section.rstrip("\n").endswith(gmm_fab_cells.comparison(str(port)).rstrip("\n"))
