"""The port's YAML configs and experiment runners (CPU).

- The port's YAML reader against ``yaml.safe_load`` on every config in
  ``experiments/configs`` (PyYAML is not on the card machine; the port reads the
  configs itself), and its dotted overrides against fab_tpu's.
- ``get_n_iterations`` against fab_tpu's on the configs ``setup_run`` reads, with
  the iteration budget and the flow-forward-pass budget.
- ``setup_model`` with ``flow.resampled_base`` and ``flow.use_snf`` building the
  layers fab_tpu's does.
- Each runner end to end at a tiny size via overrides: GMM (plain ``Trainer``;
  ``BufferTrainer``; the LARS base; SNF), ManyWell (prioritised buffer, pickle log) and LGCP
  (``flow.fused_coupling=true``, K2's plain version), each writing its log and a
  checkpoint, with finite eval columns, and resuming from the checkpoint.
"""
import csv
import math
import pathlib
import pickle

import jax
import pytest
import torch
import yaml

from experiments.setup_run import get_n_iterations as jax_get_n_iterations
from experiments.setup_run import setup_model as jax_setup_model
from fab_tpu.targets import GMM as JaxGMM
from fab_tpu.utils.training import apply_overrides as jax_apply_overrides
from fab_tpu.utils.training import load_config as jax_load_config
from fab_tpu_torch.experiments import run_gmm, run_lgcp, run_many_well
from fab_tpu_torch.experiments.setup_run import get_n_iterations, setup_model
from fab_tpu_torch.flows import ResampledGaussianBase, StochasticFlow, is_stochastic
from fab_tpu_torch.ops.coupling_kernel import FusedCoupling
from fab_tpu_torch.targets import GMM
from fab_tpu_torch.train import BufferTrainer, PrioritisedBufferTrainer, Trainer
from fab_tpu_torch.utils.training import apply_overrides, load_config, read_yaml

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "experiments" / "configs").glob("*.yaml"))
RUN_CONFIGS = [ROOT / "experiments" / "configs" / f"{n}.yaml"
               for n in ("gmm", "gmm_fast", "lgcp", "many_well", "many_well_fast")]


def test_every_config_is_read():
    assert len(CONFIGS) == 12


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_equals_safe_load(path):
    text = path.read_text()
    assert read_yaml(text, path.name) == yaml.safe_load(text)
    assert load_config(str(path)) == jax_load_config(str(path))


def test_overrides_read_values_as_fab_tpu_does():
    overrides = ["training.lr=1e-4", "training.seed=3", "training.n_iterations=null",
                 "flow.act_norm=true", "target.dim=6", "training.tlimit=1.5",
                 "evaluation.save_path=./r/x", "target.extra=1_000", "fab.alpha=-1.e+0"]
    path = str(ROOT / "experiments" / "configs" / "gmm.yaml")
    assert apply_overrides(load_config(path), overrides) == jax_apply_overrides(
        jax_load_config(path), overrides)


@pytest.mark.parametrize("path", RUN_CONFIGS, ids=lambda p: p.name)
@pytest.mark.parametrize("budget", ["config", "iterations", "forward_passes", "flow_loss"])
def test_get_n_iterations_matches_fab_tpu(path, budget, capsys):
    cfg = load_config(str(path))
    t, fab = cfg.training, cfg.fab
    n_iter, n_pass, loss = t.n_iterations, t.n_flow_forward_pass, fab.loss_type
    if budget == "iterations":
        n_iter, n_pass = 37, None
    elif budget in ("forward_passes", "flow_loss"):
        n_iter, n_pass = None, 10**9
    if budget == "flow_loss":
        loss = "flow_reverse_kl"
    args = dict(n_training_iter=n_iter, n_flow_forward_pass=n_pass, batch_size=t.batch_size,
                loss_type=loss,
                n_transition_operator_inner_steps=fab.transition_operator.n_inner_steps,
                n_intermediate_ais_dist=fab.n_intermediate_distributions,
                transition_operator_type=fab.transition_operator.type,
                use_buffer=t.use_buffer, min_buffer_length=t.min_buffer_length)
    assert get_n_iterations(**args) == jax_get_n_iterations(**args) > 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) % 2 == 0 and out[: len(out) // 2] == out[len(out) // 2:]


@pytest.mark.parametrize("key", ["resampled_base", "use_snf"])
def test_setup_model_builds_lars_and_snf_flows_as_fab_tpu(key):
    """gmm.yaml with the switch on: the same layers as fab_tpu's setup_model (15
    couplings; the LARS base 2 x 256, T 100, 1024 points; or 5 MH layers of one
    step of 5.0, every 3rd block)."""
    cfg = apply_overrides(load_config(str(RUN_CONFIGS[0])), [f"flow.{key}=true"])
    model = setup_model(cfg, GMM(true_expectation_estimation_n_samples=10, device="cpu"),
                        device="cpu")
    with jax.enable_x64():
        model_j = jax_setup_model(cfg, JaxGMM(true_expectation_estimation_n_samples=10))
    flow, flow_j = model.flow, model_j.flow
    layers_j = flow_j.layers if key == "use_snf" else flow_j.bijectors
    assert [type(b).__name__ for b in flow.bijectors] == [type(b).__name__ for b in layers_j]
    if key == "resampled_base":
        base, base_j = flow.base, flow_j.base
        assert isinstance(base, ResampledGaussianBase) and not is_stochastic(flow)
        assert (base.T, base.sizes, base.z_points.shape) == (
            base_j.T, [2, base_j.hidden_units, base_j.hidden_units, 1], (1024, 2))
        return
    mh = [(b.lam, b.n_steps, b.proposal_scale) for b in flow.bijectors if hasattr(b, "lam")]
    assert isinstance(flow, StochasticFlow) and len(mh) == 5
    assert mh == [(b.lam, b.n_steps, b.proposal_scale) for b in layers_j if hasattr(b, "lam")]
    assert mh[0] == (0.2, 1, 5.0)


@pytest.mark.parametrize("key", ["resampled_base", "use_snf"])
def test_gmm_runner_with_lars_and_snf_flows(key, tmp_path):
    """run_gmm with flow.resampled_base=true or flow.use_snf=true (an MH layer after
    each of the 2 blocks here): 2 iterations, an eval with finite columns and a
    checkpoint that restores the flow (the LARS base's proposal points included)."""
    extra = ["flow.snf.it_snf_layer=1"] if key == "use_snf" else []
    trainer, state = run_gmm.main(
        ["--config", str(RUN_CONFIGS[0]), "--device", "cpu", *GMM_TINY, *extra,
         "training.n_iterations=2", f"evaluation.save_path={tmp_path}", f"flow.{key}=true"])
    assert type(trainer) is Trainer and state.step == 2
    flow = trainer.model.flow
    assert isinstance(flow.base, ResampledGaussianBase) == (key == "resampled_base")
    assert sum(hasattr(b, "lam") for b in flow.bijectors) == (2 if key == "use_snf" else 0)
    rows = _rows(tmp_path)
    assert all(math.isfinite(float(r["loss"])) for r in rows if r.get("loss"))
    _finite_eval(rows[-1])
    (ckpt,) = pathlib.Path(tmp_path).glob("*/model_checkpoints/iter_2/state.pkl")
    saved = {k: v.clone() for k, v in flow.state_dict().items()}
    with torch.no_grad():
        for v in flow.state_dict().values():
            v.zero_()
    trainer.load_state(str(ckpt))
    for name, value in flow.state_dict().items():
        assert torch.equal(value, saved[name]), name


def test_runners_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_gmm.main(["--config", str(RUN_CONFIGS[0])])


def _rows(run_dir):
    with open(next(pathlib.Path(run_dir).glob("*/logging_hist.csv"))) as f:
        return list(csv.DictReader(f))


def _finite_eval(row, prefixes=("flow_", "ais_", "eval_")):
    cols = [k for k in row if k.startswith(prefixes) and row[k] != ""]
    assert cols and all(math.isfinite(float(row[k])) for k in cols), row
    return cols


GMM_TINY = ["flow.n_layers=2", "flow.layer_nodes_per_dim=4", "training.batch_size=32",
            "training.n_flow_forward_pass=null", "target.true_expectation_n_samples=1000",
            "evaluation.n_eval=1", "evaluation.eval_batch_size=64",
            "evaluation.n_checkpoints=1", "evaluation.n_plots=0", "training.log_every=2"]


def test_gmm_runner_trains_checkpoints_and_resumes(tmp_path, capsys):
    first = str(tmp_path / "first")
    trainer, state = run_gmm.main(
        ["--config", str(RUN_CONFIGS[0]), "--device", "cpu", *GMM_TINY,
         "training.n_iterations=4", f"evaluation.save_path={first}"])
    assert type(trainer) is Trainer and state.step == 4
    assert trainer.model.flow.bijectors[0].d_cond == 1 and trainer.dtype == torch.float64
    rows = _rows(first)
    assert [r["step"] for r in rows] == ["2.0", "4.0", "4.0"]
    assert {"test_set_mean_log_prob", "kl_forward", "bias_normed"} <= {
        k.removeprefix("flow_") for k in _finite_eval(rows[-1])}
    assert list(pathlib.Path(first).glob("*/model_checkpoints/iter_4/state.pkl"))
    second = str(tmp_path / "second")
    trainer, state = run_gmm.main(
        ["--config", str(RUN_CONFIGS[0]), "--device", "cpu", *GMM_TINY,
         "training.n_iterations=6", f"evaluation.save_path={second}",
         f"training.checkpoint_load_dir={first}"])
    assert "Resuming from" in capsys.readouterr().out and state.step == 6
    assert [r["step"] for r in _rows(second)] == ["6.0", "6.0"]


def test_gmm_runner_with_a_uniform_buffer(tmp_path):
    trainer, state = run_gmm.main(
        ["--config", str(RUN_CONFIGS[0]), "--device", "cpu", *GMM_TINY,
         "training.n_iterations=2", f"evaluation.save_path={tmp_path}",
         "training.use_buffer=true", "training.min_buffer_length=64",
         "training.maximum_buffer_length=256", "training.n_batches_buffer_sampling=2"])
    assert type(trainer) is BufferTrainer and state.step == 2
    assert int(state.buffer_state.n_added) == 64 + 2 * 32
    rows = _rows(tmp_path)
    assert all(math.isfinite(float(r["replay_loss"])) for r in rows if r["replay_loss"])
    _finite_eval(rows[-1])


def test_many_well_runner_with_a_pickle_log(tmp_path):
    """many_well.yaml's prioritised buffer at dim 4, logged by the list logger (a
    config file of the user's own)."""
    text = (ROOT / "experiments" / "configs" / "many_well.yaml").read_text()
    assert "  pandas_logger:\n    save_period: 1000\n" in text
    config = tmp_path / "mw.yaml"
    config.write_text(text.replace("  pandas_logger:\n    save_period: 1000\n",
                                   "  list_logger:\n"))
    args = ["--config", str(config), "target.dim=4", "flow.n_layers=2",
            "flow.layer_nodes_per_dim=2", "training.batch_size=64",
            "training.n_flow_forward_pass=null", "training.min_buffer_length=128",
            "training.maximum_buffer_length=512", "training.n_batches_buffer_sampling=2",
            "evaluation.n_eval=1", "evaluation.eval_batch_size=128",
            "evaluation.n_checkpoints=1", "training.n_iterations=2"]
    trainer, state = run_many_well.main(
        args[:2] + ["--device", "cpu"] + args[2:] + [f"evaluation.save_path={tmp_path / 'out'}"])
    assert type(trainer) is PrioritisedBufferTrainer and state.step == 2
    with open(next((tmp_path / "out").glob("*/logging_hist.pkl")), "rb") as f:
        history = pickle.load(f)
    for key in ("flow_forward_kl_p_target", "flow_test_set_exact_mean_log_prob_p_target",
                "ais_abs_MSE_log_Z_estimate_p_target", "eval_ess_ais_min_var_target"):
        assert len(history[key]) == 1 and math.isfinite(history[key][0]), key
    assert list((tmp_path / "out").glob("*/model_checkpoints/iter_2/state.pkl"))
    _, state = run_many_well.main(
        ["--config", str(config), "--device", "cpu", *args[2:-1], "training.n_iterations=3",
         f"evaluation.save_path={tmp_path / 'resumed'}",
         f"training.checkpoint_load_dir={tmp_path / 'out'}"])
    assert state.step == 3 and int(state.buffer_state.n_added) == 128 + 3 * 64


def test_lgcp_runner_through_the_fused_coupling(tmp_path):
    before = FusedCoupling.recomputes
    args = ["--config", str(RUN_CONFIGS[2]), "--device", "cpu", "target.grid_size=4",
            "target.dim=16", "flow.fused_coupling=true", "flow.n_layers=2",
            "flow.layer_nodes_per_dim=8",  # H = 128: K2 takes widths in 128s
            "fab.n_intermediate_distributions=2", "training.batch_size=32",
            "training.min_buffer_length=64", "training.maximum_buffer_length=256",
            "training.n_batches_buffer_sampling=2", "evaluation.n_eval=1",
            "evaluation.eval_batch_size=64", "evaluation.n_checkpoints=1"]
    trainer, state = run_lgcp.main(args + ["training.n_iterations=2",
                                           f"evaluation.save_path={tmp_path / 'out'}"])
    assert type(trainer.model.flow.bijectors[0]).__name__ == "LargeFusedCoupling"
    assert FusedCoupling.recomputes > before and state.step == 2
    rows = _rows(tmp_path / "out")
    _finite_eval(rows[-1], ("flow_", "ais_"))
    assert list((tmp_path / "out").glob("*/model_checkpoints/iter_2/state.pkl"))
    _, state = run_lgcp.main(args + ["training.n_iterations=3",
                                     f"evaluation.save_path={tmp_path / 'resumed'}",
                                     f"training.checkpoint_load_dir={tmp_path / 'out'}"])
    assert state.step == 3
