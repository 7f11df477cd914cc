"""A GMM-40 run whose every draw is made by a CPU generator and moved to the device
(``run_gmm_served``; ``gmm_fab_cells --only fab_no_buffer_served_s<N>``): on the CPU
it is the plain run, bit for bit (its checkpoints and its logged rows), and inside
``served()`` a draw is the one its generator makes on its own device. On the card the
served run computes on the CPU run's noise (``tests/test_torch_gpu.py``)."""
import csv
import glob
import os

import numpy as np
import pytest
import torch

from fab_tpu_torch import random
from fab_tpu_torch.checkpoint import load_checkpoint
from fab_tpu_torch.experiments import gmm_fab_cells, run_gmm, run_gmm_served, setup_run, study
from fab_tpu_torch.flows import coupling
from torch_parity_utils import one_torch_thread  # noqa: F401

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "experiments", "configs", "gmm.yaml")
TINY = ["fab.loss_type=fab_alpha_div", "training.use_buffer=false", "training.seed=1",
        "flow.n_layers=2", "flow.layer_nodes_per_dim=4", "training.batch_size=32",
        "training.n_flow_forward_pass=null", "training.n_iterations=12",
        "target.true_expectation_n_samples=1000", "evaluation.eval_batch_size=64",
        "evaluation.n_plots=0", "evaluation.n_eval=2", "evaluation.n_checkpoints=2"]


def _leaves(node, out):
    if isinstance(node, dict):
        for k in sorted(node):
            _leaves(node[k], out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _leaves(v, out)
    elif isinstance(node, np.ndarray):
        out.append(node)
    return out


def _run(main, root):
    main(["--config", CONFIG, "--device", "cpu", *TINY, f"evaluation.save_path={root}/"])
    (run,) = glob.glob(os.path.join(root, "*", ""))
    with open(os.path.join(run, "logging_hist.csv")) as f:
        rows = [{k: v for k, v in r.items() if "time" not in k} for r in csv.DictReader(f)]
    ckpts = sorted(glob.glob(os.path.join(run, "model_checkpoints", "iter_*", "state.pkl")))
    return rows, [_leaves(load_checkpoint(p), []) for p in ckpts]


def _patched():
    return ([getattr(random, k) for k in run_gmm_served.DRAWS] + [setup_run.make_generator]
            + [m.mlp_init for m in run_gmm_served.MLP_INIT_USERS])


def test_a_served_run_on_the_cpu_is_the_plain_run(tmp_path):
    before = _patched()
    plain_rows, plain = _run(run_gmm.main, tmp_path / "plain")
    served_rows, served = _run(run_gmm_served.main, tmp_path / "served")
    assert all(a is b for a, b in zip(_patched(), before))  # put back
    assert len(plain) == len(served) == 2 and len(plain_rows) >= 3
    assert served_rows == plain_rows
    for a, b in zip(plain, served):
        assert len(a) == len(b) and all(np.array_equal(x, y, equal_nan=True)
                                        for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["normal", "uniform", "exponential", "randint"])
def test_a_draw_is_made_on_its_generators_device(kind):
    """Outside ``served()`` a draw is the one torch makes (the main path as it was);
    inside, a CPU generator's draw for another device (``meta``: no card here) is made
    on the CPU, as the plain draw, and lands on that device."""
    args = lambda device: ({"randint": (0, 7, (5, 3), device)}
                           .get(kind, ((5, 3), torch.float64, device)))
    g = torch.Generator().manual_seed(3)
    want = {"normal": lambda: torch.randn(5, 3, generator=g, dtype=torch.float64),
            "uniform": lambda: torch.rand(5, 3, generator=g, dtype=torch.float64),
            "exponential": lambda: torch.empty(5, 3, dtype=torch.float64).exponential_(
                generator=g),
            "randint": lambda: torch.randint(0, 7, (5, 3), generator=g)}[kind]()
    assert torch.equal(getattr(random, kind)(torch.Generator().manual_seed(3), *args("cpu")),
                       want)
    plain, served = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    getattr(random, kind)(plain, *args("cpu"))
    with run_gmm_served.served():
        got = getattr(random, kind)(served, *args("meta"))
        assert torch.equal(getattr(random, kind)(torch.Generator().manual_seed(3),
                                                 *args("cpu")), want)
    assert got.device.type == "meta" and got.shape == want.shape
    assert torch.equal(served.get_state(), plain.get_state())


def test_a_served_mlp_init_draws_on_its_generators_device():
    sizes, f64 = (2, 8, 8, 4), torch.float64
    plain = coupling.mlp_init(sizes, torch.Generator().manual_seed(5), False, f64, "cpu")
    with run_gmm_served.served():
        on_meta = coupling.mlp_init(sizes, torch.Generator().manual_seed(5), False, f64, "meta")
        same = coupling.mlp_init(sizes, torch.Generator().manual_seed(5), False, f64, "cpu")
    assert all(w.device.type == b.device.type == "meta" for w, b in on_meta)
    assert all(torch.equal(a, b) for p, q in zip(plain, same) for a, b in zip(p, q))
    assert all(m.mlp_init is not run_gmm_served._served_mlp_init
               for m in run_gmm_served.MLP_INIT_USERS)


def test_served_cells_are_named_and_saved_apart(tmp_path, capsys):
    gmm_fab_cells.main(["--device", "cpu", "--dry-run", "--results-root", str(tmp_path),
                        "--only", "fab_no_buffer_served_s0",
                        "--only", "fab_no_buffer_served_s2"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["fab_no_buffer_served_s0",
                                                 "fab_no_buffer_served_s2"]
    assert lines[0].endswith(f"{tmp_path}/gmm_study/fab_no_buffer_served/seed0/")
    c = gmm_fab_cells.cell("fab_no_buffer_served_s1")
    assert c.runner == "run_gmm_served" and c.log == "gmm_study_served_s1"
    assert c.overrides == gmm_fab_cells.cell("fab_no_buffer_s1").overrides
    assert gmm_fab_cells.cell("fab_no_buffer_s4").save_path == "gmm_study/fab_no_buffer/seed4"
    with pytest.raises(ValueError, match="no cell named"):
        gmm_fab_cells.main(["--device", "cpu", "--dry-run", "--only", "fab_buffer_s3"])


def _rows(k, s, c):
    return ([{"group": "K", "flow_bias_no_correction": v} for v in k]
            + [{"group": "S", "flow_bias_no_correction": v} for v in s]
            + [{"group": "C", "flow_bias_no_correction": v} for v in c])


@pytest.mark.parametrize("k, s, c, outcome", [
    ([3, 4], [0.1, 0.3], [0.05, 0.2], "(i)"),
    ([3, 4], [2.0, 2.5], [0.05, 0.2], "(ii)"),
    ([3, 4], [2.0, 0.1], [0.05, 0.2], "(i)"),  # one S run high, but S's range meets C's
    ([1.5, 4], [2.0, 0.1], [0.05, 0.2], "(iii)"),
    ([0.1, 4], [0.1, 0.3], [0.05, 0.2], "(iii)"),
    ([0.01, 0.02], [0.1, 0.3], [0.05, 0.2], "none"),
])
def test_the_noise_rule(k, s, c, outcome):
    got = gmm_fab_cells.noise_outcome(_rows(k, s, c))
    assert got.startswith(outcome), got


@pytest.mark.parametrize("with_rerun", [False, True])
def test_the_noise_report_takes_each_runs_score_or_its_tails_bias(tmp_path, with_rerun):
    """Fourteen runs from three evaluation CSVs and two --tails tables; a run with no
    evaluation row (the port's CPU seed 0) is scored by its tails row. A re-run whose
    tails row is given joins the table after them, outside the rule and the ranking."""
    head = ("| Flow | Rows left out of 50000 | Unweighted bias | Share farther than 10 "
            "| Their share of the sum | Bias without them |\n|---|---|---|---|---|---|\n")
    runs = gmm_fab_cells.NOISE_RUNS + (gmm_fab_cells.NOISE_RERUNS if with_rerun else [])
    tails = [f"| {t} | {i} | {0.5 + i:.4g} | {i / 100:.4g} | 0.5 | 0.1 |"
             for i, (*_, t) in enumerate(runs)]
    (tmp_path / "a.md").write_text(head + "\n".join(tails[:7]) + "\n")
    (tmp_path / "b.md").write_text("# more\n\n" + head + "\n".join(tails[7:]) + "\n")
    evals = {}
    for i, (group, seed, source, name, tails_name) in enumerate(runs):
        if tails_name != "port_cpu_s0":
            evals.setdefault(source, []).append({"model_name": name,
                                                 "flow_bias_no_correction": 10 + i})
    specs = []
    for source, rows in evals.items():
        study.write_csv(tmp_path / f"{source}.csv", rows)
        specs.append(f"{source}={tmp_path / f'{source}.csv'}")
    out = tmp_path / "out"
    rows = gmm_fab_cells.main(["--noise-report", str(out), *sum(
        (["--noise-eval", s] for s in specs), []), "--noise-tails", str(tmp_path / "a.md"),
        "--noise-tails", str(tmp_path / "b.md")])
    assert [(r["group"], r["seed"]) for r in rows] == [(g, s) for g, s, *_ in runs]
    for i, r in enumerate(rows):
        cpu0 = r["run"] == "port_cpu_s0"
        assert r["flow_bias_no_correction"] == (0.5 + i if cpu0 else 10 + i), r
        assert r["scored_by"] == ("--tails (port_cpu_s0)" if cpu0 else f"{runs[i][2]}.csv")
        assert r["rows_left_out"] == i and r["far_share"] == pytest.approx(i / 100)
    md = (out / "gmm_fab_no_buffer_noise.md").read_text()
    assert md.count("\n| K |") == 5 and md.count("\n| S |") == 3 and md.count("\n| C |") == 6
    assert md.count("\n| K re-run |") == int(with_rerun)
    assert "Outcome by the rule: **(iii) chance**" in md  # the fab_tpu runs score highest
    ranked = [ln for ln in md.splitlines() if ln.startswith("Ranked")]
    assert len(ranked) == 1 and ranked[0].count(",") == 14  # "Ranked," and 13 between
    assert ("Re-runs (the same cell and seed at a later tree; not in the rule): "
            "port_card_s0_rerun 24 (card_rerun.csv)" in md) == with_rerun
    with open(out / "gmm_fab_no_buffer_noise.csv") as f:
        assert len(list(csv.DictReader(f))) == 14 + with_rerun


def test_the_committed_noise_report_is_its_inputs_table(tmp_path):
    """``fab_tpu_torch/reports/gmm_fab_no_buffer_noise.*`` are ``--noise-report`` of
    the committed inputs (README.md's command), and every run of the study is there,
    and the card's seed 0 run again at a later tree beside them."""
    reports = os.path.join(os.path.dirname(CONFIG), "..", "..", "fab_tpu_torch", "reports")
    path = lambda name: os.path.join(reports, name)
    evals = [f"card={path('gmm_study_results.csv')}",
             f"card={path('gmm_fab_no_buffer_noise_eval_card.csv')}",
             f"cpu={path('gmm_fab_no_buffer_noise_eval_cpu.csv')}",
             f"fab_tpu={path('gmm_fab_no_buffer_fab_tpu_cpu_eval.csv')}",
             f"card_rerun={path('gmm_fab_no_buffer_noise_eval_card_rerun.csv')}"]
    tails = [path("gmm_fab_no_buffer_tails.md"), path("gmm_fab_no_buffer_noise_tails.md")]
    rows = gmm_fab_cells.noise_report(evals, tails, str(tmp_path))
    for name in ("gmm_fab_no_buffer_noise.md", "gmm_fab_no_buffer_noise.csv"):
        with open(path(name)) as f, open(tmp_path / name) as g:
            assert f.read() == g.read(), name
    assert len(rows) == 15 and rows[-1]["run"] == "port_card_s0_rerun"
    assert all(r["scored_by"].endswith(".csv") for r in rows if r["run"] != "port_cpu_s0")
