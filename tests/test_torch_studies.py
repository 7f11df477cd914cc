"""The study modules (``fab_tpu_torch/experiments/<stem>.py``) against the
``experiments/<stem>.sh`` scripts they port.

- Each training study's ``--dry-run`` lists exactly its script's cells: name,
  overrides in the script's order and save path, transcribed below from the script
  lines cited; trailing ``key=value`` arguments reach every cell.
- The skip guards, the ManyWell study's backstop (rc 124, a FAILURE line) and the
  cells' command lines, with the runner's subprocess replaced.
- One GMM cell and one ManyWell cell run end to end on the CPU at a tiny size (their
  CSVs finite); ``eval_gmm_study`` evaluates the GMM run and the unchanged
  ``experiments/latex_table.py`` writes its table; ``eval_lgcp_trajectory``
  evaluates a grid-8 LGCP run's checkpoints in one ``evaluate.main`` call, in
  numeric order.
- Without a card every study raises unless given ``--device cpu``.
"""
import csv
import math
import os
import pathlib
import shutil
import subprocess

import pytest
import torch

from fab_tpu_torch.experiments import (
    eval_gmm_study,
    eval_lgcp_trajectory,
    evaluate,
    run_gmm_ess_ablation,
    run_gmm_method_study,
    run_gmm_method_study_r3,
    run_init_parity_ab,
    run_lgcp,
    run_matmul_cells,
    run_mw_method_study,
    study,
)
from torch_parity_utils import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "experiments" / "configs"

# run_gmm_method_study.sh:10-17 (run) and :23-28 (fab_no_buffer), in the order its two
# lanes (:34-47) start them.
GMM_COMMON = "evaluation.n_plots=0 evaluation.n_eval=5 evaluation.n_checkpoints=2"
GMM_STUDY = [
    (f"{m}_s{s}",
     (f"fab.loss_type=fab_alpha_div training.seed={s} {GMM_COMMON} training.use_buffer=false"
      if m == "fab_no_buffer" else f"fab.loss_type={m} training.seed={s} {GMM_COMMON}"),
     f"gmm_study/{m}/seed{s}")
    for m, s in [("fab_no_buffer", 0), ("fab_no_buffer", 1), ("flow_reverse_kl", 0),
                 ("flow_reverse_kl", 1), ("flow_alpha_2_div_nis", 0),
                 ("flow_alpha_2_div_nis", 1), ("fab_no_buffer", 2), ("flow_reverse_kl", 2),
                 ("flow_alpha_2_div_nis", 2)]
]
# run_gmm_method_study_r3.sh:20-31, for the jobs "target_kld 0", "rsb 1", "snf 2".
R3_JOBS = ["target_kld 0", "rsb 1", "snf 2"]
R3 = [
    ("target_kld_s0", "fab.loss_type=target_forward_kl training.seed=0 evaluation.n_plots=0 "
     "evaluation.n_eval=2 evaluation.n_checkpoints=1", "gmm_study/target_kld/seed0"),
    ("rsb_s1", "fab.loss_type=flow_reverse_kl flow.resampled_base=true training.seed=1 "
     "evaluation.n_plots=0 evaluation.n_eval=2 evaluation.n_checkpoints=1",
     "gmm_study/rsb/seed1"),
    ("snf_s2", "fab.loss_type=flow_reverse_kl flow.use_snf=true training.seed=2 "
     "evaluation.n_plots=0 evaluation.n_eval=2 evaluation.n_checkpoints=1",
     "gmm_study/snf/seed2"),
]
# run_gmm_ess_ablation.sh:12, :22-28 and :33-42.
ABL_COMMON = ("fab.loss_type=fab_alpha_div training.use_buffer=true "
              "training.prioritised_buffer=true training.seed=0 "
              "training.n_flow_forward_pass=null training.n_iterations=13019 "
              "evaluation.eval_batch_size=512 evaluation.n_plots=0 evaluation.n_eval=1 "
              "evaluation.n_checkpoints=1")
ABL_EXTRA = {
    "control": "", "w_clip10": " training.w_adjust_max_clip=10", "lr5e-5": " training.lr=5e-5",
    "act_norm": " flow.act_norm=true", "scale_cap5": " flow.scale_cap=5.0",
    "buf_4x": " training.maximum_buffer_length=51200 training.min_buffer_length=5120",
    "step1": " fab.transition_operator.init_step_size=1.0",
}
ABLATION = [(v, ABL_COMMON + ABL_EXTRA[v], f"gmm_ablation/{v}")
            for v in ("control", "w_clip10", "lr5e-5", "act_norm", "scale_cap5")]
# run_init_parity_ab.sh:17-29 and :39-55.
INIT_COMMON = ("evaluation.eval_batch_size=512 evaluation.n_plots=0 evaluation.n_eval=1 "
               "evaluation.n_checkpoints=1")
INIT_AB = [
    ("snf_he", f"training.seed=0 training.tlimit=1.0 {INIT_COMMON} "
     "fab.loss_type=flow_reverse_kl flow.use_snf=true training.log_every=100",
     "init_ab/snf_he"),
    ("snf_torch", f"training.seed=0 training.tlimit=1.0 {INIT_COMMON} "
     "fab.loss_type=flow_reverse_kl flow.use_snf=true flow.init_mode=torch "
     "training.log_every=100", "init_ab/snf_torch"),
    ("rsb_torch", f"training.seed=0 training.tlimit=1.5 {INIT_COMMON} "
     "fab.loss_type=flow_reverse_kl flow.resampled_base=true flow.init_mode=torch "
     "training.log_every=100", "init_ab/rsb_torch"),
    ("fabbuf_torch", f"training.seed=0 training.tlimit=2.5 {INIT_COMMON} "
     "fab.loss_type=fab_alpha_div training.use_buffer=true training.prioritised_buffer=true "
     "training.n_flow_forward_pass=null training.n_iterations=13019 flow.init_mode=torch",
     "init_ab/fabbuf_torch"),
]
# run_mw_method_study.sh:17, :32-38 and :46-53.
MW_NO_BUFFER = "training.use_buffer=false training.prioritised_buffer=false"
MW_EXTRA = {
    "fab_buffer": "", "fab_no_buffer": f" {MW_NO_BUFFER}",
    "flow_reverse_kl": f" fab.loss_type=flow_reverse_kl {MW_NO_BUFFER} training.log_every=100",
    "flow_alpha_2_div_nis":
        f" fab.loss_type=flow_alpha_2_div_nis {MW_NO_BUFFER} training.log_every=100",
}


def mw_study(budget):
    return [(f"{m}_s{s}", f"training.seed={s} training.use_64_bit=false training.tlimit=0.66 "
             f"training.n_iterations=null training.n_flow_forward_pass={budget} "
             "evaluation.n_plots=0 evaluation.n_eval=1 evaluation.n_checkpoints=1" + MW_EXTRA[m],
             f"mw_study/{m}/seed{s}") for s in (0, 1, 2) for m in MW_EXTRA]


# run_matmul_cells.sh:10-25.
MATMUL = [(f"{p}_s{s}", f"training.seed={s} training.use_64_bit=false "
           f"training.matmul_precision={p} training.n_flow_forward_pass=null "
           "training.n_iterations=3000 evaluation.n_plots=0 evaluation.n_eval=2 "
           "evaluation.n_checkpoints=1", f"mw_matmul/{p}_s{s}")
          for s in (1, 2) for p in ("high", "highest")]

STUDIES = {
    "gmm_method_study": (run_gmm_method_study, [], GMM_STUDY),
    "gmm_method_study_r3": (run_gmm_method_study_r3, R3_JOBS, R3),
    "gmm_ess_ablation": (run_gmm_ess_ablation, [], ABLATION),
    "gmm_ess_ablation_named": (run_gmm_ess_ablation, ["buf_4x", "step1", "control"], [
        (v, ABL_COMMON + ABL_EXTRA[v], f"gmm_ablation/{v}") for v in ("buf_4x", "step1",
                                                                      "control")]),
    "init_parity_ab": (run_init_parity_ab, [], INIT_AB),
    "init_parity_ab_named": (run_init_parity_ab, ["rsb_torch"], INIT_AB[2:3]),
    "mw_method_study": (run_mw_method_study, [], mw_study(225000000)),
    "mw_method_study_budget": (run_mw_method_study, ["1000000"], mw_study(1000000)),
    "matmul_cells": (run_matmul_cells, [], MATMUL),
}
TRAINING_STUDIES = [run_gmm_method_study, run_gmm_method_study_r3, run_gmm_ess_ablation,
           run_init_parity_ab, run_mw_method_study, run_matmul_cells]
ALL_STUDIES = TRAINING_STUDIES + [eval_gmm_study, eval_lgcp_trajectory]
STUDY_IDS = [m.__name__.rsplit(".", 1)[-1] for m in ALL_STUDIES]


def _dry_run(module, argv, root, capsys):
    capsys.readouterr()
    module.main(["--device", "cpu", "--dry-run", "--results-root", str(root), *argv])
    lines = capsys.readouterr().out.splitlines()
    out = []
    for line in lines:
        name, rest = line.split(": ", 1)
        overrides, path = rest.rsplit(" -> ", 1)
        out.append((name, overrides, path))
    return out


@pytest.mark.parametrize("name", STUDIES)
def test_dry_run_lists_the_scripts_cells(name, tmp_path, capsys):
    module, argv, expected = STUDIES[name]
    listed = _dry_run(module, argv, tmp_path, capsys)
    assert listed == [(n, o, f"{tmp_path}/{p}/") for n, o, p in expected]
    assert not list(tmp_path.iterdir()), "a dry run wrote something"


def test_cell_counts():
    counts = {k: len(v[2]) for k, v in STUDIES.items()}
    assert (counts["gmm_method_study"], counts["gmm_ess_ablation"], counts["init_parity_ab"],
            counts["mw_method_study"], counts["matmul_cells"]) == (9, 5, 4, 12, 4)


@pytest.mark.parametrize("name", ["gmm_method_study", "gmm_method_study_r3",
                                  "gmm_ess_ablation", "init_parity_ab", "mw_method_study",
                                  "matmul_cells"])
def test_trailing_overrides_reach_every_cell(name, tmp_path, capsys):
    module, argv, expected = STUDIES[name]
    extra = ["training.n_iterations=2", "flow.n_layers=2"]
    listed = _dry_run(module, [*argv, *extra], tmp_path, capsys)
    assert len(listed) == len(expected)
    assert all(o.endswith(" ".join(extra)) for _, o, _ in listed)
    args = study.parse(study.parser(""), ["--device", "cpu", *argv, *extra])
    for cell in module.cells(args):
        cmd = study.command(cell, args)
        assert cmd[:4] == [cmd[0], "-u", "-m", f"fab_tpu_torch.experiments.{cell.runner}"]
        assert cmd[-3:] == [f"evaluation.save_path={study.save_dir(args, cell)}/", *extra]
        assert cmd[cmd.index("--device") + 1] == "cpu"


class _Runs:
    """Stands in for the runner subprocesses: records each command; a cell named in
    ``hang`` times out."""

    def __init__(self, hang=()):
        self.commands, self.hang = [], hang

    def __call__(self, cmd, **kwargs):
        self.commands.append((cmd, kwargs))
        save = [a for a in cmd if a.startswith("evaluation.save_path=")][-1]
        if any(save.rstrip("/").endswith(h) for h in self.hang):
            raise subprocess.TimeoutExpired(cmd, kwargs["timeout"])
        return subprocess.CompletedProcess(cmd, 0)

    def saves(self):
        return [[a for a in c if a.startswith("evaluation.save_path=")][-1].split("=", 1)[1]
                for c, _ in self.commands]


@pytest.mark.parametrize("module, cell, marker, guarded", [
    (run_gmm_ess_ablation, "gmm_ablation/lr5e-5", "stamp/model_checkpoints/iter_1/", True),
    (run_gmm_method_study_r3, "gmm_study/rsb/seed1", "stamp/model_checkpoints/iter_3/", True),
    (run_init_parity_ab, "init_ab/snf_torch", "stamp/model_checkpoints/iter_7/", True),
    (run_mw_method_study, "mw_study/fab_no_buffer/seed1", "stamp/model_checkpoints/iter_2/",
     True),
    (run_matmul_cells, "mw_matmul/high_s2", "logging_hist.csv", True),
    (run_matmul_cells, "mw_matmul/highest_s1", "run_metrics.txt", True),
    (run_matmul_cells, "mw_matmul/highest_s1", "stamp/model_checkpoints/iter_1/", False),
    (run_gmm_method_study, "gmm_study/flow_reverse_kl/seed1",
     "stamp/model_checkpoints/iter_1/", False),
], ids=["ablation", "r3", "init_ab", "mw_study", "matmul_csv", "matmul_metrics",
        "matmul_checkpoint_only", "gmm_study_has_no_guard"])
def test_skip_guard(module, cell, marker, guarded, tmp_path, monkeypatch, capsys):
    """A cell whose save path holds what the script's guard looks for is skipped;
    the others run."""
    path = tmp_path / cell / marker
    if marker.endswith("/"):
        path.mkdir(parents=True)
    else:
        path.parent.mkdir(parents=True)
        path.write_text("")
    runs = _Runs()
    monkeypatch.setattr(study.subprocess, "run", runs)
    argv = R3_JOBS if module is run_gmm_method_study_r3 else []
    results = module.main(["--device", "cpu", "--results-root", str(tmp_path), *argv])
    skipped = [c.save_path for c, rc in results if rc is None]
    assert skipped == ([cell] if guarded else [])
    assert (f"{tmp_path / cell}/" in runs.saves()) != guarded
    assert len(runs.commands) == len(results) - len(skipped)
    if guarded:
        assert "(exists)" in capsys.readouterr().out
    assert all(kw["cwd"] == study.REPO for _, kw in runs.commands)


def test_mw_backstop_records_a_failure(tmp_path, monkeypatch, capsys):
    runs = _Runs(hang=("flow_reverse_kl/seed2",))
    monkeypatch.setattr(study.subprocess, "run", runs)
    results = run_mw_method_study.main(["--device", "cpu", "--results-root", str(tmp_path),
                                        "--only", "flow_reverse_kl_s2", "--only",
                                        "fab_buffer_s0"])
    assert [(c.name, rc) for c, rc in results] == [("fab_buffer_s0", 0),
                                                   ("flow_reverse_kl_s2", 124)]
    assert {kw["timeout"] for _, kw in runs.commands} == {4800}
    failed = (tmp_path / "mw_study" / "FAILED").read_text().splitlines()
    assert failed == ["[mw-study] FAILURE: flow_reverse_kl_s2 KILLED by backstop timeout — "
                      "cell missing"]
    assert "done rc=124" in capsys.readouterr().out


def test_eval_gmm_study_picks_the_scripts_runs(tmp_path):
    """eval_gmm_study.sh:13-30: the newest run directory with a checkpoint per seed
    directory; gmm_buffer_f64 gives the fab_buffer rows and hides gmm_study/fab_buffer."""
    def run(rel, stamp, mtime, checkpoint=True):
        d = tmp_path / rel / stamp
        (d / "model_checkpoints" / ("iter_1" if checkpoint else "none")).mkdir(parents=True)
        os.utime(d, (mtime, mtime))
        return str(d)

    run("gmm_study/flow_reverse_kl/seed0", "old", 100)
    newest = run("gmm_study/flow_reverse_kl/seed0", "new", 200)
    run("gmm_study/snf/seed1", "only", 100, checkpoint=False)
    run("gmm_study/fab_buffer/seed0", "a", 100)
    f64 = run("gmm_buffer_f64/seed2", "b", 100)
    assert eval_gmm_study.runs(str(tmp_path)) == [("flow_reverse_kl_seed0", newest),
                                                  ("fab_buffer_seed2", f64)]
    shutil.rmtree(tmp_path / "gmm_buffer_f64")
    assert [n for n, _ in eval_gmm_study.runs(str(tmp_path))] == [
        "fab_buffer_seed0", "flow_reverse_kl_seed0"]


GMM_CUTS = ["training.n_iterations=1", "training.n_flow_forward_pass=null",
            "target.true_expectation_n_samples=1000", "flow.n_layers=2",
            "flow.layer_nodes_per_dim=2"]
MW_CUTS = ["training.n_iterations=1", "training.n_flow_forward_pass=null", "target.dim=4",
           "flow.n_layers=2", "flow.layer_nodes_per_dim=2", "training.batch_size=64",
           "training.min_buffer_length=128", "training.maximum_buffer_length=512",
           "evaluation.eval_batch_size=64"]


# Columns that may be infinite after one step of an untrained tiny flow, in fab_tpu
# too: the min / max of the replay weights over a batch with no valid row (+inf /
# -inf, train.py:727-728), and the Z errors of the min-variance AIS target
# p^2 / q, whose log-weights overflow in f32 for a flow this far from p.
MAY_BE_INFINITE = ("w_adjust_min", "w_adjust_max", "_MSE_Z_estimate_min_var_target",
                   "_MSE_log_Z_estimate_min_var_target")


def _finite_rows(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert rows
    for row in rows:
        for k, v in row.items():
            if k != "model_name" and not k.endswith(MAY_BE_INFINITE) and v != "":
                assert math.isfinite(float(v)), (path, k, v)
    return rows


@pytest.fixture(scope="module")
def runs_root(tmp_path_factory):
    """One GMM method-study cell and one ManyWell method-study cell, run end to end
    on the CPU through the study modules (one OpenMP thread per run)."""
    root = tmp_path_factory.mktemp("studies")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        gmm = run_gmm_method_study.main(["--device", "cpu", "--results-root", str(root),
                                         "--only", "flow_reverse_kl_s0", *GMM_CUTS])
        mw = run_mw_method_study.main(["--device", "cpu", "--results-root", str(root),
                                       "--only", "fab_buffer_s0", *MW_CUTS])
    return root, gmm + mw


def test_one_gmm_and_one_manywell_cell_run_end_to_end(runs_root):
    root, results = runs_root
    assert [(c.name, rc) for c, rc in results] == [("flow_reverse_kl_s0", 0), ("fab_buffer_s0", 0)]
    for cell, _ in results:
        (run_dir,) = (root / cell.save_path).iterdir()
        assert list((run_dir / "model_checkpoints").glob("iter_1/state.pkl"))
        rows = _finite_rows(run_dir / "logging_hist.csv")
        assert any(r.get("eval_ess_flow_p_target", r.get("eval_ess_flow", "")) for r in rows)
        assert (root / "logs" / f"{cell.log}.log").stat().st_size > 0


def test_eval_gmm_study_writes_its_csv_and_latex_table(runs_root, capsys):
    root, _ = runs_root
    found = eval_gmm_study.main(["--device", "cpu", "--results-root", str(root), "1000",
                                 *GMM_CUTS[2:]])
    assert [n for n, _ in found] == ["flow_reverse_kl_seed0"]
    (row,) = _finite_rows(root / "reports" / "gmm_study_results.csv")
    assert row["model_name"] == "flow_reverse_kl_seed0"
    table = (root / "reports" / "gmm_study_table.tex").read_text()
    assert "flow\\_reverse\\_kl" in table and "ESS (flow)" in table
    assert table in capsys.readouterr().out


LGCP_CUTS = ["target.grid_size=8", "target.dim=64", "flow.n_layers=1",
             "flow.layer_nodes_per_dim=2", "fab.n_intermediate_distributions=2"]


def test_eval_lgcp_trajectory_evaluates_every_checkpoint_in_one_process(tmp_path,
                                                                        monkeypatch):
    run_lgcp.main(["--config", str(CONFIGS / "lgcp.yaml"), "--device", "cpu", *LGCP_CUTS,
                   "training.batch_size=16", "training.n_iterations=2",
                   "training.min_buffer_length=32", "training.maximum_buffer_length=128",
                   "evaluation.n_eval=0", "evaluation.n_checkpoints=2",
                   f"evaluation.save_path={tmp_path / 'run'}/"])
    (run_dir,) = (tmp_path / "run").iterdir()
    ckpts = run_dir / "model_checkpoints"
    shutil.copytree(ckpts / "iter_2", ckpts / "iter_10")  # numeric, not lexical, order
    calls = []
    main = evaluate.main
    monkeypatch.setattr(evaluate, "main", lambda argv: calls.append(argv) or main(argv))
    found = eval_lgcp_trajectory.main(["--device", "cpu", "--results-root", str(tmp_path),
                                       str(run_dir), "512", *LGCP_CUTS])
    assert [n for n, _ in found] == ["lgcp_iter1", "lgcp_iter2", "lgcp_iter10"]
    (argv,) = calls
    assert "target.in_graph_kernel=true" in argv and argv[argv.index("--inner-batch") + 1] == "512"
    rows = _finite_rows(tmp_path / "reports" / "lgcp_trajectory.csv")
    assert [r["model_name"] for r in rows] == ["lgcp_iter1", "lgcp_iter2", "lgcp_iter10"]
    assert rows[1] == dict(rows[2], model_name="lgcp_iter2")  # the same checkpoint


@pytest.mark.parametrize("module", ALL_STUDIES, ids=STUDY_IDS)
def test_study_raises_without_a_card_unless_told_cpu(module, tmp_path):
    argv = ["--dry-run", "--results-root", str(tmp_path)]
    if module is eval_lgcp_trajectory:
        argv.append(str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(argv)
    module.main(["--device", "cpu", *argv])
