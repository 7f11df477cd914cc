"""ManyWell-32's FAB cells (``fab_tpu_torch/experiments/mw_fab_cells.py``) against what
``experiments/run_mw_method_study.sh`` gives fab_tpu's ``experiments/run_many_well.py``,
on the CPU.

- The six cells: their overrides, read from the script, resolve to one configuration
  in both packages, and to the same iteration counts (4,963 and 5,231).
- The path the study trains, in f32: consecutive steps of the fab_buffer trainer,
  built by each package's runner set-up from many_well.yaml at the study's overrides,
  cut in width (target dim 4, coupling width 8), batch (64) and buffer (640 / 1024,
  so that all 8 replay batches hold finite rows) only, from fab_tpu's initial state
  (flow, step sizes, filled buffer) on shared noise. Tolerance, f32: each step's
  loss, ``ess_ais`` and mean log-weight and the buffer's weights to 1e-4 relative (a
  sum in another order is ~1e-7 off; the AIS weights' logsumexp over 4 x 5 leapfrog
  steps grows it: ``ess_ais`` lies ~1e-5 apart), and the flow's parameters to 1e-6
  absolute after each step (observed: 1.2e-7 after 3 steps of Adam at lr 3e-4).
- The driver end to end at a tiny size: two cells, their summaries, the evaluation,
  the evaluation seeds' spread, the slimmed checkpoints and the report.
"""
import csv
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.setup_run import get_n_iterations as jax_get_n_iterations
from experiments.setup_run import setup_model as jax_setup_model
from fab_tpu.buffer import PrioritisedReplayBuffer as JaxBuffer
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu.train import PrioritisedBufferTrainer as JaxTrainer
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu.utils.training import apply_overrides as jax_apply_overrides
from fab_tpu.utils.training import load_config as jax_load_config
from fab_tpu_torch.checkpoint import load_checkpoint
from fab_tpu_torch.convert import buffer_state_from_jax, from_jax_params, transition_state_from_jax
from fab_tpu_torch.experiments import mw_fab_cells, study
from fab_tpu_torch.experiments.setup_run import setup_trainer
from fab_tpu_torch.targets import ManyWellEnergy
from fab_tpu_torch.train import BufferTrainState
from fab_tpu_torch.utils.training import apply_overrides, load_config
from torch_parity_utils import NoiseReplay, ais_noise, one_torch_thread, to_np  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "experiments" / "configs" / "many_well.yaml"
SCRIPT = ROOT / "experiments" / "run_mw_method_study.sh"
CUTS = ["target.dim=4", "flow.layer_nodes_per_dim=2", "training.batch_size=64",
        "training.min_buffer_length=640", "training.maximum_buffer_length=1024"]


def _script_cells():
    """{cell name: overrides} of the script's fab_buffer and fab_no_buffer cells: its
    run() command's overrides (the save path left out) and each method's extras, with
    $seed and $BUDGET filled in."""
    text = SCRIPT.read_text().replace("\\\n", " ")
    command = re.search(r"timeout 4800 python -u experiments/run_many_well.py(.*?)\"\$@\"",
                        text, re.S).group(1)
    common = [a for a in command.split() if "=" in a and "save_path" not in a]
    budget = re.search(r"BUDGET=\$\{1:-(\d+)\}", text).group(1)
    cells = {}
    for line in text.splitlines():
        m = re.match(r"\s*run (fab_buffer|fab_no_buffer) \"\$seed\"(.*)", line)
        if m:
            for seed in (0, 1, 2):
                cells[f"{m.group(1)}_s{seed}"] = [
                    a.replace('"$seed"', str(seed)).replace('"$BUDGET"', budget)
                    for a in [*common, *m.group(2).split()]]
    return cells


def test_the_cells_resolve_as_the_script_gives_them_to_fab_tpu():
    script = _script_cells()
    assert sorted(script) == sorted(mw_fab_cells.CELLS)
    for name, overrides in script.items():
        jax_cfg = jax_apply_overrides(jax_load_config(str(CONFIG)), overrides)
        cfg = apply_overrides(load_config(str(CONFIG)), mw_fab_cells.cell(name).overrides)
        assert cfg == jax_cfg, name
        assert not cfg.training.use_64_bit and cfg.training.tlimit == 0.66, name
        t, to = jax_cfg.training, jax_cfg.fab.transition_operator
        want = jax_get_n_iterations(t.n_iterations, t.n_flow_forward_pass, t.batch_size,
                                    jax_cfg.fab.loss_type, to.n_inner_steps,
                                    jax_cfg.fab.n_intermediate_distributions, to.type,
                                    t.use_buffer, t.get("min_buffer_length"))
        assert mw_fab_cells.budget(name) == want == (
            4963 if name.startswith("fab_buffer") else 5231), name


N_STEPS = 3
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-6


def test_f32_fab_buffer_steps_at_the_studys_settings_match_fab_tpu(monkeypatch):
    cfg = apply_overrides(load_config(str(CONFIG)),
                          [*mw_fab_cells.cell("fab_buffer_s0").overrides, *CUTS])
    t, dim, batch = cfg.training, cfg.target.dim, cfg.training.batch_size
    n_dists = cfg.fab.n_intermediate_distributions
    model_j = jax_setup_model(cfg, JaxManyWell(dim))
    buffer_j = JaxBuffer(dim=dim, max_length=t.maximum_buffer_length,
                         min_sample_length=t.min_buffer_length)
    trainer_j = JaxTrainer(model_j, jax_make_optimizer(t.lr, t.max_grad_norm), buffer_j,
                           n_batches_buffer_sampling=t.n_batches_buffer_sampling,
                           w_adjust_max_clip=t.w_adjust_max_clip, dtype=jnp.float32)
    state_j = trainer_j.init_state(jax.random.key(t.seed), batch)
    step_j = jax.jit(trainer_j._train_step_fn(batch))

    trainer = setup_trainer(cfg, ManyWellEnergy(dim, device="cpu"), device="cpu")
    assert trainer.dtype == torch.float32 and type(trainer).__name__ == type(trainer_j).__name__
    flow = trainer.model.flow
    flow.load_state_dict(from_jax_params(to_np(state_j.params["flow"]), flow=flow))
    state = BufferTrainState(
        transition_state=transition_state_from_jax(to_np(state_j.params["transition"])),
        opt_state=trainer.optimizer.init(trainer.params),
        buffer_state=buffer_state_from_jax(to_np(state_j.buffer_state)), step=0)
    for k in range(N_STEPS):
        key = jax.random.fold_in(jax.random.key(5), k)
        key_ais, key_sample = jax.random.split(key)
        noise = ais_noise(key_ais, n_dists, 1, batch, dim, jnp.float32, flow=model_j.flow)
        noise["gumbel"] = [np.asarray(jax.random.gumbel(key_sample, (t.maximum_buffer_length,),
                                                        jnp.float32))]
        state_j, info_j = step_j(state_j, key)
        replay = NoiseReplay(monkeypatch, noise)
        state, info = trainer.train_step(state, None, batch)
        replay.assert_consumed()
        what = f"step {k + 1}"
        assert int(info["n_valid"]) == int(info_j["n_valid"]) > 0, what
        assert bool(info["update_applied"]) and bool(info_j["update_applied"]), what
        for name in ("loss", "ess_ais", "sampled_log_w_mean"):
            np.testing.assert_allclose(float(info[name]), float(info_j[name]),
                                       rtol=LOSS_RTOL, err_msg=f"{what}: {name}")
        expected = from_jax_params(to_np(state_j.params["flow"]))
        for name, value in flow.state_dict().items():
            np.testing.assert_allclose(value.numpy(), expected[name], rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{what}: {name}")
        buf, buf_j = state.buffer_state, to_np(state_j.buffer_state)
        assert int(buf.n_added) == int(buf_j.n_added), what
        fin = np.isfinite(np.asarray(buf_j.log_w))
        assert np.array_equal(torch.isfinite(buf.log_w).numpy(), fin), what
        np.testing.assert_allclose(buf.log_w.numpy()[fin], np.asarray(buf_j.log_w)[fin],
                                   rtol=LOSS_RTOL, atol=LOSS_RTOL, err_msg=what)
    for k in ("epsilons", "common_epsilon"):
        np.testing.assert_allclose(state.transition_state[k].numpy(),
                                   np.asarray(state_j.params["transition"][k]),
                                   rtol=LOSS_RTOL, err_msg=k)


WIDTHS = ["target.dim=4", "flow.n_layers=2", "flow.layer_nodes_per_dim=2"]
TINY = WIDTHS + ["training.batch_size=64", "training.min_buffer_length=128",
                 "training.maximum_buffer_length=512", "evaluation.eval_batch_size=64",
                 "training.n_flow_forward_pass=null", "training.n_iterations=20"]
ONE_EACH = ["fab_buffer_s0", "fab_no_buffer_s0"]


def test_the_driver_runs_evaluates_and_reports(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = tmp_path / "torch"
    only = [a for name in ONE_EACH for a in ("--only", name)]
    base = ["--device", "cpu", "--results-root", str(root)]
    table = mw_fab_cells.main([*base, *only, "--commit", "REF", *TINY])
    assert sorted(table) == sorted(ONE_EACH)
    for name, row in table.items():
        assert row["rc"] == 0 and row["compiled"] and not row["resumed"], row
        assert row["iterations"] == row["budget_iterations"] == 20, row
        assert row["finite_params"] and row["tf32"] == "off", row
        assert not row["tlimit_reached"] and row["median_step_ms"] is not None, row
        assert (row["fill_s"] is not None) == name.startswith("fab_buffer"), row
        assert row["card"] == "cpu" and row["commit"] == "REF", row
        assert "training.use_64_bit=false" in row["command"], row
    assert json.loads((root / "cells.json").read_text()) == table

    rows = mw_fab_cells.main([*base, "--evaluate", "--spread", "--slim", "--num-samples",
                              "2048", *WIDTHS])
    spread = [(r["model_name"], r["eval_seed"]) for r in rows]
    assert spread == [(n, s) for n in ("fab_buffer_seed0", "fab_no_buffer_seed0")
                      for s in mw_fab_cells.SPREAD_SEEDS]
    scored = study.read_csv(root / "reports" / "mw_study_results.csv")
    assert [r["model_name"] for r in scored] == ["fab_buffer_seed0", "fab_no_buffer_seed0"]
    assert set(mw_fab_cells.TEST_SET) <= set(scored[0])
    for name, row in table.items():
        state = load_checkpoint(str(root / row["last_checkpoint"]))
        assert sorted(state) == ["params", "step"], sorted(state)

    out = tmp_path / "reports"
    (out / "README.md").parent.mkdir()
    (out / "README.md").write_text("# Another study\n\ntext\n")
    mw_fab_cells.main(["--summary", "--report", str(out), "--results-root", str(root)])
    rows = {r["model_name"]: r for r in study.read_csv(out / "mw_study_results.csv")}
    assert sorted(rows) == ["fab_buffer_seed0", "fab_no_buffer_seed0"]
    for row in rows.values():
        assert "iterations=20 of 20" in row["provenance"] and "f32" in row["provenance"]
    readme = (out / "README.md").read_text()
    assert readme.startswith("# Another study\n\ntext\n\n# ManyWell-32's FAB cells")
    assert readme.count(": not run.") == 4 and "TF32 off" in readme
    assert "| fab_buffer | `eval_ess_flow` |" in readme
    assert "fab\\_no\\_buffer" in (out / "mw_study_table.tex").read_text()
    assert len(study.read_csv(out / "mw_eval_seed_spread.csv")) == 10
    # The report again leaves the file as it was.
    mw_fab_cells.main(["--summary", "--report", str(out), "--results-root", str(root)])
    assert (out / "README.md").read_text() == readme


def test_the_overflow_rule_reads_both_test_sets():
    row = {"flow_test_set_exact_mean_log_prob": "-28.5", "flow_test_set_modes_mean_log_prob": "-27"}
    assert not mw_fab_cells.overflows(row)
    for k in mw_fab_cells.LOG_Q:
        for bad in ("-2e6", "nan", "-inf"):
            assert mw_fab_cells.overflows(dict(row, **{k: bad})), (k, bad)
    assert not mw_fab_cells.overflows(dict(row, flow_test_set_modes_mean_log_prob=""))


def test_a_readme_section_is_replaced_in_place(tmp_path):
    path = tmp_path / "README.md"
    study.write_section(str(path), "# A\n\none\n")
    study.write_section(str(path), "# B\n\ntwo\n\n## B's part\n")
    study.write_section(str(path), "# A\n\nthree\n")
    assert path.read_text() == "# A\n\nthree\n\n# B\n\ntwo\n\n## B's part\n"
    assert study.read_section(str(path), "# B") == "# B\n\ntwo\n\n## B's part\n"
    with open(path, newline="") as f:
        assert csv.reader(f)
