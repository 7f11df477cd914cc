"""The port's ManyWell and GMM analysis scripts, its demos and notebooks, and the
repository's JAX-free scripts on the port's outputs, on the CPU.

- ``sign_stats`` / ``report`` (ground_truth_marginals) and the GMM demo's
  ``mode_coverage`` against fab_tpu's scripts' functions on shared arrays (exact:
  the same numpy code on the same numbers); ``envelope_gap`` (rejection_sampling_vis)
  against fab_tpu's DoubleWell in float64, 1e-12;
- ``ground_truth_marginals.main`` with a port checkpoint; ``alpha_study.main`` beside
  fab_tpu's script on the same config: the same CSV columns and rows;
- the figures: each plotting script writes its PNG here (matplotlib is installed);
  with matplotlib hidden a figure-only script raises ImportError naming it, and the
  others print ``plots off`` and write none;
- the demos at a few iterations; ``make_notebooks`` reproduces the committed
  notebooks, whose code cells run on the CPU at a tiny budget;
- ``experiments/export_runs.py``, ``latex_table.py`` and ``summarize_ess_study.py``,
  unchanged, in subprocesses on a port runner's output (the last as a copy inside a
  temporary tree, so that it never writes the repository's ``reports/``).
"""
import csv
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from experiments import alpha_study as jax_alpha_study
from experiments import ground_truth_marginals as jax_gtm
from fab_tpu.targets import GMM as JaxGMM
from fab_tpu.targets.double_well import DoubleWellEnergy as JaxDoubleWell
from fab_tpu_torch.demo import gmm_demo, make_notebooks, many_well_demo
from fab_tpu_torch.experiments import (
    alpha_study,
    evaluate,
    ground_truth_marginals,
    rejection_sampling_vis,
    results_vis,
    run_gmm,
    run_many_well,
    visualise_marginal_pairs,
)
from fab_tpu_torch.targets import GMM
from fab_tpu_torch.targets.double_well import DoubleWellEnergy
from torch_parity_utils import assert_close, one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "experiments" / "configs"
DEMO = ROOT / "fab_tpu_torch" / "demo"


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.setitem(sys.modules, name, None)


# ----------------------------------------------------------------- shared helpers


def test_sign_stats_and_report_match_fab_tpu(capsys):
    x = np.random.default_rng(0).standard_normal((5000, 12)) + 0.3
    got, want = ground_truth_marginals.sign_stats(x, 6), jax_gtm.sign_stats(x, 6)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    got_r = ground_truth_marginals.report("x", x, 6)
    port_out = capsys.readouterr().out
    want_r = jax_gtm.report("x", x, 6)
    assert capsys.readouterr().out == port_out
    np.testing.assert_array_equal(got_r[0], want_r[0])
    assert got_r[1:] == want_r[1:]


def test_gmm_mode_coverage_matches_fab_tpu():
    from demo.gmm_demo import mode_coverage as jax_mode_coverage

    kw = dict(dim=2, n_mixes=40, loc_scaling=40.0, seed=0,
              true_expectation_estimation_n_samples=100)
    target_j, target = JaxGMM(**kw), GMM(**kw, device="cpu")
    x = np.random.default_rng(1).uniform(-45, 45, (3000, 2))
    x[::97] = np.inf
    assert gmm_demo.mode_coverage(target, x) == jax_mode_coverage(target_j, x)
    assert gmm_demo.mode_coverage(target, torch.tensor(x)) == jax_mode_coverage(target_j, x)
    assert gmm_demo.mode_coverage(target, np.full((3, 2), np.nan)) == 0


def test_envelope_gap_matches_fab_tpu():
    from fab_tpu.targets.double_well import DW_Z_DIM1

    xs = np.linspace(-4.0, 4.0, 1000)
    with jax.enable_x64():
        dw_j = JaxDoubleWell()
        x_j = jnp.asarray(xs)
        want = np.asarray(jnp.log(DW_Z_DIM1 * 3) + dw_j._proposal_log_prob(x_j)
                          + dw_j.energy_dim_1(x_j))
    _, _, gap = rejection_sampling_vis.envelope_gap(DoubleWellEnergy(), torch.tensor(xs))
    assert_close(gap, want, 1e-12, "log(kq / p)")
    assert float(gap.min()) > 0


# ----------------------------------------------------------------- scripts


MW_TINY = ["--device", "cpu", "training.n_iterations=1", "training.n_flow_forward_pass=null",
           "training.batch_size=32", "training.min_buffer_length=256",
           "training.maximum_buffer_length=512", "evaluation.n_eval=0", "evaluation.n_plots=0",
           "evaluation.n_checkpoints=1"]


@pytest.fixture(scope="module")
def mw_run(tmp_path_factory):
    """A ManyWell-32 run of many_well.yaml's flow (f64) by the port's runner."""
    root = tmp_path_factory.mktemp("mw")
    run_many_well.main(["--config", str(CONFIGS / "many_well.yaml"), *MW_TINY,
                        f"evaluation.save_path={root}"])
    (run_dir,) = root.iterdir()
    return run_dir


def test_ground_truth_marginals_with_a_checkpoint(mw_run, capsys):
    out = ground_truth_marginals.main(["--device", "cpu", "--n-samples", "20000", "--config",
                                       str(CONFIGS / "many_well.yaml"), "--checkpoint",
                                       str(mw_run)])
    printed = capsys.readouterr().out
    assert "== exact samples ==" in printed and "== flow samples ==" in printed
    assert out["pair_dev"] < 0.01 and out["triple_dev"] < 0.01
    assert out["flow_marginals"].shape == (16,) and 0 <= out["max_occupancy_gap"] <= 1
    # The exact sampler's well occupancy: P(x > 0) = 0.8455 (the envelope's mass).
    assert np.abs(out["marginals"] - 0.8455).max() < 0.02


GMM_TINY = ["flow.n_layers=2", "flow.layer_nodes_per_dim=4", "training.batch_size=32",
            "training.n_flow_forward_pass=null", "target.true_expectation_n_samples=1000",
            "training.n_iterations=2"]


def test_alpha_study_matches_fab_tpu_columns(tmp_path):
    args = ["--config", str(CONFIGS / "gmm_fast.yaml"), "--alphas", "1.0", "2.0", "--seeds",
            "0", "--num-samples", "64"]
    rows = alpha_study.main(args + ["--out", str(tmp_path / "port.csv"), "--device", "cpu",
                                    *GMM_TINY])
    jax_alpha_study.main(args + ["--out", str(tmp_path / "jax.csv"), *GMM_TINY])
    port, fab = _csv(tmp_path / "port.csv"), _csv(tmp_path / "jax.csv")
    assert list(port[0]) == list(fab[0])
    assert [(r["alpha"], r["seed"]) for r in port] == [(r["alpha"], r["seed"]) for r in fab]
    assert len(rows) == 2 and all(np.isfinite(v) for r in rows for v in r.values())


def test_plot_scripts_write_their_figures(mw_run, gmm_runs, tmp_path, capsys):
    png = tmp_path / "rs.png"
    out = rejection_sampling_vis.main(["--device", "cpu", "--n-samples", "2000", "--out",
                                       str(png)])
    assert png.stat().st_size > 0 and out["min_log_gap"] > 0
    assert "envelope OK" in capsys.readouterr().out
    png = tmp_path / "pairs.png"
    visualise_marginal_pairs.main(["--device", "cpu", "--checkpoint", str(mw_run),
                                   "--max-wells", "2", "--n-samples", "50", "--out", str(png)])
    assert png.stat().st_size > 0
    png = tmp_path / "mw_rows.png"
    results_vis.main(["--device", "cpu", "--config", str(CONFIGS / "many_well.yaml"),
                      "--run", f"FAB={mw_run}", "--n-samples", "50", "--out", str(png)])
    assert png.stat().st_size > 0
    png = tmp_path / "gmm_rows.png"
    results_vis.main(["--device", "cpu", "--config", str(CONFIGS / "gmm.yaml"), "--run",
                      f"FAB={gmm_runs['csv']}", "--run", f"KL={gmm_runs['csv']}", "--ais",
                      "--n-samples", "50", "--out", str(png), *GMM_TINY])
    assert png.stat().st_size > 0
    matplotlib.pyplot.close("all")


def test_without_matplotlib(no_matplotlib, mw_run, tmp_path, capsys):
    for main, args in ((visualise_marginal_pairs.main, ["--checkpoint", str(mw_run)]),
                       (results_vis.main, ["--config", str(CONFIGS / "gmm.yaml"), "--run",
                                           "a=b"])):
        with pytest.raises(ImportError, match="matplotlib"):
            main(args + ["--device", "cpu", "--out", str(tmp_path / "x.png")])
    out = rejection_sampling_vis.main(["--device", "cpu", "--n-samples", "100", "--out",
                                       str(tmp_path / "rs.png")])
    assert out["min_log_gap"] > 0
    gmm_demo.main(["--device", "cpu", "--iters", "1", "--out", str(tmp_path / "g.png")])
    printed = capsys.readouterr().out
    assert printed.count("plots off: matplotlib is not installed") == 2
    assert not list(tmp_path.glob("*.png"))


# ----------------------------------------------------------------- demos, notebooks


def test_demos_on_the_cpu(tmp_path, capsys):
    counts = many_well_demo.main(["--device", "cpu", "--iters", "2"])
    assert set(counts) == {"fab_alpha_div", "flow_reverse_kl"}
    for c in counts.values():
        assert sum(c.values()) == 4000 and all(len(m) == 3 for m in c)
    covered = gmm_demo.main(["--device", "cpu", "--iters", "2", "--out",
                             str(tmp_path / "gmm.png")])
    assert all(0 <= v <= 40 for v in covered.values())
    assert (tmp_path / "gmm.png").stat().st_size > 0
    assert "FAB covered" in capsys.readouterr().out


def test_make_notebooks_reproduces_the_committed_notebooks_and_their_cells_run(tmp_path,
                                                                              monkeypatch):
    paths = make_notebooks.main(str(tmp_path))
    assert [pathlib.Path(p).name for p in paths] == ["fab_gmm.ipynb", "fab_many_well.ipynb"]
    for p in paths:
        assert pathlib.Path(p).read_text() == (DEMO / pathlib.Path(p).name).read_text()
    monkeypatch.chdir(DEMO)
    for p in paths:
        cells = json.loads(pathlib.Path(p).read_text())["cells"]
        source = "\n".join("".join(c["source"]) for c in cells if c["cell_type"] == "code")
        assert 'DEVICE = "cuda"' in source
        source = source.replace('DEVICE = "cuda"', 'DEVICE = "cpu"')
        source = source.replace("N_ITERATIONS = 2000", "N_ITERATIONS = 2")
        source = source.replace("N_ITERATIONS = 500", "N_ITERATIONS = 2")
        exec(compile(source, p, "exec"), {"__name__": "notebook"})
    matplotlib.pyplot.close("all")


# ----------------------------------------------------------------- JAX-free scripts


@pytest.fixture(scope="module")
def gmm_runs(tmp_path_factory):
    """Port runs of GMM-40: gmm.yaml with the prioritised buffer, one eval and one
    checkpoint (a CSV log with the ``_p_target`` columns), and gmm_fast.yaml (a
    pickled ListLogger history)."""
    root = tmp_path_factory.mktemp("gmm_runs")
    common = ["--device", "cpu", *GMM_TINY, "evaluation.n_plots=0", "evaluation.n_eval=1",
              "evaluation.eval_batch_size=64", "evaluation.n_checkpoints=1"]
    run_gmm.main(["--config", str(CONFIGS / "gmm.yaml"), *common, "training.use_buffer=true",
                  "training.prioritised_buffer=true", "training.min_buffer_length=64",
                  "training.maximum_buffer_length=128",
                  f"evaluation.save_path={root / 'csv'}"])
    run_gmm.main(["--config", str(CONFIGS / "gmm_fast.yaml"), *common,
                  f"evaluation.save_path={root / 'pkl'}"])
    (csv_run,) = (root / "csv").iterdir()
    (pkl_run,) = (root / "pkl").iterdir()
    assert (csv_run / "logging_hist.csv").exists() and (pkl_run / "logging_hist.pkl").exists()
    return {"root": root, "csv": csv_run, "pkl": pkl_run}


def _script(args, cwd=ROOT):
    proc = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_export_runs_reads_port_histories(gmm_runs, tmp_path):
    out = tmp_path / "histories.csv"
    printed = _script(["experiments/export_runs.py", "--runs", str(gmm_runs["root"]), "--out",
                       str(out)])
    assert "2 runs" in printed
    rows = _csv(out)
    runs = {r["run"] for r in rows}
    assert len(runs) == 2 and {r["key"] for r in rows} >= {"loss", "ess_ais", "step"}
    assert all(np.isfinite(float(r["value"])) for r in rows if r["key"] == "loss")
    assert any(r["key"] == "eval_ess_flow_p_target" for r in rows)


def test_latex_table_reads_port_csvs(gmm_runs, tmp_path):
    eval_csv = tmp_path / "eval.csv"
    evaluate.main(["--config", str(CONFIGS / "gmm.yaml"), "--device", "cpu", "--run",
                   f"fab_seed0={gmm_runs['csv']}", "--run", f"fab_seed1={gmm_runs['pkl']}",
                   "--num-samples", "64", "--inner-batch", "32", "--out", str(eval_csv),
                   *GMM_TINY, "flow.layer_nodes_per_dim=4"])
    table = _script(["experiments/latex_table.py", "--csv", str(eval_csv), "--problem", "gmm"])
    lines = table.strip().splitlines()
    assert lines[0].startswith("Method & ESS (flow) & ESS (AIS)") and lines[1] == r"\midrule"
    assert lines[2].startswith("fab & $") and len(lines) == 3
    alpha_csv = tmp_path / "alpha.csv"
    with open(alpha_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["alpha", "seed", "eval_ess_flow",
                                               "eval_ess_ais", "flow_test_set_mean_log_prob",
                                               "flow_bias_normed"])
        writer.writeheader()
        for row in _csv(eval_csv):
            writer.writerow({"alpha": 2.0, "seed": row["model_name"][-1],
                             **{k: row[k] for k in writer.fieldnames[2:]}})
    table = _script(["experiments/latex_table.py", "--csv", str(alpha_csv), "--alpha-study"])
    assert r"$\alpha = 2$ & $" in table


def test_summarize_ess_study_on_a_port_run_in_a_temporary_tree(gmm_runs, tmp_path):
    tree = tmp_path / "tree"
    (tree / "experiments").mkdir(parents=True)
    shutil.copy(ROOT / "experiments" / "summarize_ess_study.py", tree / "experiments")
    for variant in ("no_buffer", "trajectory_2x"):
        run = tree / "results" / "gmm_ablation" / variant / "run0"
        run.mkdir(parents=True)
        shutil.copy(gmm_runs["csv"] / "logging_hist.csv", run)
    before = sorted(p.name for p in (ROOT / "reports").iterdir())
    printed = _script([str(tree / "experiments" / "summarize_ess_study.py")], cwd=tree)
    assert sorted(p.name for p in (ROOT / "reports").iterdir()) == before
    assert "1 variants" in printed and "1 eval points" in printed
    (ablation,) = _csv(tree / "reports" / "gmm_ess_ablation.csv")
    assert ablation["variant"] == "no_buffer" and ablation["iteration"] == "2"
    assert np.isfinite(float(ablation["eval_ess_flow_p_target"]))
    (trajectory,) = _csv(tree / "reports" / "gmm_ess_trajectory.csv")
    assert float(trajectory["iteration"]) == 2.0
