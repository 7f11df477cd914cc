"""The port's evaluation and sampling entry points against fab_tpu's, on the CPU.

- a checkpoint written by fab_tpu (its optimizer state pickled as its libraries'
  classes) evaluated by the port's ``evaluate_checkpoint`` (LGCP grid 8, the
  fused-coupling flow, HMC, float64) on replayed noise: the numbers of fab_tpu's
  ``get_eval_info``, 1e-8; the load imports neither JAX nor fab_tpu;
- ``evaluate.main`` and ``evaluate_expectation.main`` on a GMM checkpoint written by
  the port's runner, beside fab_tpu's scripts on the same checkpoint: the same CSV
  columns and rows;
- ``bias_pair`` on shared inputs (non-finite and underflowing weights), and
  ``evaluate_target`` / ``evaluate_model`` on replayed draws, float64: 1e-10;
- ``sample_aldp.main`` and ``reeval_aldp.main`` on an ALDP run directory whose
  checkpoint fab_tpu wrote: the ``.npz`` keys and shapes and the metrics CSV
  columns of fab_tpu's scripts, finite values, the plots.
"""
import csv
import inspect
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments import evaluate as jax_evaluate
from experiments import evaluate_expectation as jax_expectation
from experiments import reeval_aldp as jax_reeval
from experiments import sample_aldp as jax_sample
from experiments.make_aldp_model import make_aldp_model as jax_make_aldp_model
from experiments.setup_run import setup_model as jax_setup_model
from fab_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fab_tpu.targets import GMM as JaxGMM
from fab_tpu.targets import LogGaussianCoxProcess as JaxLGCP
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu_torch.experiments import (
    evaluate,
    evaluate_expectation,
    profile_aldp,
    reeval_aldp,
    run_gmm,
    sample_aldp,
)
from fab_tpu_torch.experiments.load_model_for_eval import load_model
from fab_tpu_torch.targets import GMM, LogGaussianCoxProcess
from fab_tpu_torch.utils.training import apply_overrides, load_config
from torch_parity_utils import (
    NoiseReplay,
    ais_noise,
    assert_close,
    flow_sample_noise,
    metropolis_ais_noise,
    perturbed_jax_flow_params,
    shared_noise_run,
    to_np,
    trained_state_steps,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "experiments" / "configs"
GOLDEN = ROOT / "tests" / "data" / "aldp_openmm_min_energy_nm.npy"
DT = torch.float64
LGCP_TINY = ["target.grid_size=8", "target.dim=64", "flow.n_layers=2",
             "flow.fused_coupling=true", "fab.n_intermediate_distributions=2",
             "fab.transition_operator.n_inner_steps=3",
             "fab.transition_operator.init_step_size=0.1", "training.use_64_bit=true"]


def _write_jax_checkpoint(path, model_j, seed, dtype):
    """fab_tpu's train-state layout: perturbed flow params, the transition state, an
    Adam state of its optimizer library, a step."""
    flow_params = to_np(perturbed_jax_flow_params(model_j.flow, seed, dtype))
    params = {"flow": flow_params,
              "transition": to_np(model_j.ais.transition_operator.init_state(
                  model_j.flow.dim, dtype))}
    jax_save_checkpoint(str(path), {
        "params": params, "opt_state": jax_make_optimizer(1e-3, 100.0).init(flow_params),
        "step": 3})


def test_fab_tpu_checkpoint_evaluates_to_fab_tpu_numbers(tmp_path, monkeypatch):
    cfg = apply_overrides(load_config(str(CONFIGS / "lgcp.yaml")), LGCP_TINY)
    run_dir = tmp_path / "run"
    outer, inner = 64, 32
    with jax.enable_x64():
        target_j = JaxLGCP(grid_size=8, dtype=jnp.float64)
        model_j = jax_setup_model(cfg, target_j)
        _write_jax_checkpoint(run_dir / "model_checkpoints" / "iter_3" / "state.pkl",
                              model_j, 11, jnp.float64)
        info_j = jax_evaluate.evaluate_checkpoint(cfg, target_j, str(run_dir), outer, inner)
        # get_eval_info's draws: chunk i runs on fold_in(key_data, i).
        key_data, _ = jax.random.split(jax.random.key(0))
        noise = {"normal": [], "exponential": []}
        for i in range(outer // inner):
            chunk = ais_noise(jax.random.fold_in(key_data, i), 2, 1, inner, 64, jnp.float64)
            for k in noise:
                noise[k] += chunk[k]
    target = LogGaussianCoxProcess(grid_size=8, dtype=DT, device="cpu")
    replay = NoiseReplay(monkeypatch, noise)
    info = evaluate.evaluate_checkpoint(cfg, target, str(run_dir), outer, inner, dtype=DT,
                                        device="cpu")
    replay.assert_consumed()
    assert set(info) == set(info_j) and info["eval_ess_ais"] > 0
    for k in info:
        assert_close(info[k], info_j[k], 1e-8, k)

    code = ("import sys; from fab_tpu_torch.checkpoint import load_checkpoint; "
            f"s = load_checkpoint({str(run_dir / 'model_checkpoints/iter_3/state.pkl')!r}); "
            "assert s['step'] == 3 and 'flow' in s['params']; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'fab_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


def test_evaluate_refuses_the_in_graph_kernel():
    """The option was refused until it was ported: ``build_target`` now passes
    ``target.in_graph_kernel`` through (fab_tpu's ``experiments/evaluate.py:66``), and
    the target keeps no f64 factor on the device (tests/test_torch_lgcp_in_graph.py
    holds its numbers)."""
    cfg = apply_overrides(load_config(str(CONFIGS / "lgcp.yaml")),
                          LGCP_TINY + ["target.in_graph_kernel=true"])
    target = evaluate.build_target(cfg, DT, "cpu")
    assert target.in_graph_kernel and target._chol_t is None
    cfg.target.in_graph_kernel = False
    assert not evaluate.build_target(cfg, DT, "cpu").in_graph_kernel


GMM_TINY = ["flow.n_layers=2", "flow.layer_nodes_per_dim=4", "training.batch_size=32",
            "training.n_flow_forward_pass=null", "target.true_expectation_n_samples=1000",
            "training.use_64_bit=false"]


@pytest.fixture(scope="module")
def gmm_run(tmp_path_factory):
    """A GMM-40 run directory written by the port's runner (2 iterations, one
    checkpoint)."""
    root = tmp_path_factory.mktemp("gmm")
    run_gmm.main(["--config", str(CONFIGS / "gmm.yaml"), "--device", "cpu", *GMM_TINY,
                  "training.n_iterations=2", "evaluation.n_eval=0",
                  "evaluation.n_checkpoints=1", "evaluation.n_plots=0",
                  f"evaluation.save_path={root}"])
    (run_dir,) = root.iterdir()
    return run_dir


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_port_gmm_checkpoint_evaluates_in_fab_tpu_to_the_ports_numbers(tmp_path, monkeypatch):
    """The other direction of the checkpoint test above: a float64 GMM-40 run of the
    port's runner with the prioritised buffer (2 iterations), its checkpoint scored by
    fab_tpu's ``evaluate_checkpoint`` and by the port's on replayed noise: every key to
    1e-8. fab_tpu's scores of the port's trained flows rest on this."""
    overrides = GMM_TINY[:-1] + [
        "training.use_64_bit=true", "training.use_buffer=true",
        "training.prioritised_buffer=true", "training.min_buffer_length=64",
        "training.maximum_buffer_length=256", "training.n_batches_buffer_sampling=2"]
    run_gmm.main(["--config", str(CONFIGS / "gmm.yaml"), "--device", "cpu", *overrides,
                  "training.n_iterations=2", "evaluation.n_eval=0",
                  "evaluation.n_checkpoints=1", "evaluation.n_plots=0",
                  f"evaluation.save_path={tmp_path}/"])
    (run_dir,) = [d for d in tmp_path.iterdir() if d.is_dir()]
    cfg = apply_overrides(load_config(str(CONFIGS / "gmm.yaml")),
                          overrides + ["fab.loss_type=fab_alpha_div"])
    kw = dict(dim=2, n_mixes=40, loc_scaling=40.0, log_var_scaling=1.0,
              true_expectation_estimation_n_samples=1000)
    outer, inner = 64, 32
    with jax.enable_x64():
        target_j = JaxGMM(**kw, dtype=jnp.float64)
        info_j = jax_evaluate.evaluate_checkpoint(cfg, target_j, str(run_dir), outer, inner)
        # get_eval_info(key): chunk i of the data on fold_in(key_data, i), one Metropolis
        # step of one distribution; the flow's test set on key_metrics.
        key_data, key_metrics = jax.random.split(jax.random.key(0))
        noise = {"normal": [], "uniform": []}
        for i in range(outer // inner):
            chunk = metropolis_ais_noise(jax.random.fold_in(key_data, i), 1, 1, inner, 2,
                                         jnp.float64)
            for k in noise:
                noise[k] += chunk[k]
        k_comp, k_eps = jax.random.split(key_metrics)
        noise["randint"] = [np.asarray(jax.random.randint(k_comp, (1000,), 0, 40))]
        noise["normal"].append(np.asarray(jax.random.normal(k_eps, (1000, 2), jnp.float64)))
    target = GMM(**kw, dtype=DT, device="cpu")
    target.true_expectation = torch.tensor(float(target_j.true_expectation), dtype=DT)
    replay = NoiseReplay(monkeypatch, noise)
    info = evaluate.evaluate_checkpoint(cfg, target, str(run_dir), outer, inner, dtype=DT,
                                        device="cpu")
    replay.assert_consumed()
    assert set(info) == set(info_j) and info["eval_ess_flow"] > 0
    for k in info:
        assert_close(info[k], info_j[k], 1e-8, k)


def test_evaluate_main_matches_fab_tpu_columns(gmm_run, tmp_path, capsys):
    args = ["--config", str(CONFIGS / "gmm.yaml"), "--run", f"fab_seed0={gmm_run}",
            "--run", f"fab_seed1={gmm_run}", "--num-samples", "128", "--inner-batch", "64"]
    rows = evaluate.main(args + ["--out", str(tmp_path / "port.csv"), "--device", "cpu",
                                 *GMM_TINY])
    assert "fab  eval_ess_flow=" in capsys.readouterr().out  # the mean (sem) table
    jax_evaluate.main(args + ["--out", str(tmp_path / "jax.csv"), *GMM_TINY])
    port, fab = _csv(tmp_path / "port.csv"), _csv(tmp_path / "jax.csv")
    assert list(port[0]) == list(fab[0]) and len(port) == len(fab) == len(rows) == 2
    assert [r["model_name"] for r in port] == ["fab_seed0", "fab_seed1"]
    assert all(np.isfinite(float(v)) for r in port for k, v in r.items() if k != "model_name")


def test_steps_from_a_port_checkpoint_match_fab_tpus(tmp_path):
    """``trained_state_steps`` (run by hand on the GMM-40 cells' trained flows) on a
    float64 checkpoint of the port's runner: both packages' steps from its flow agree
    to 1e-8 on shared noise, ``n_valid`` equal."""
    overrides = GMM_TINY[:-1] + ["training.use_64_bit=true"]
    run_gmm.main(["--config", str(CONFIGS / "gmm.yaml"), "--device", "cpu", *overrides,
                  "training.n_iterations=3", "evaluation.n_eval=0",
                  "evaluation.n_checkpoints=1", "evaluation.n_plots=0",
                  f"evaluation.save_path={tmp_path}/"])
    (ckpt,) = tmp_path.glob("*/model_checkpoints/iter_3/state.pkl")
    out = trained_state_steps(str(ckpt), n_steps=3, batch=32, overrides=overrides)
    assert len(out["param_rel_diff"]) == 3 and max(out["param_rel_diff"]) < 1e-8, out
    assert all(a == b > 0 for a, b in out["n_valid"]), out
    for a, b in out["loss"]:
        assert_close(a, b, 1e-8, "loss")


def test_shared_noise_run_keeps_both_packages_together_early(tmp_path):
    """``shared_noise_run`` (run by hand for the GMM-40 gap in ROADMAP Queue 3): from
    one initial float64 flow on shared noise, both packages' steps agree to 1e-8 over
    the first 30 steps, ``n_valid`` and the loss equal, and the two final states,
    written as checkpoints, give ``gmm_fab_cells --tails`` the same rows."""
    from fab_tpu_torch.experiments import gmm_fab_cells

    overrides = GMM_TINY[:-1] + ["training.use_64_bit=true"]
    out = shared_noise_run(30, str(tmp_path), every=10, batch=32, overrides=overrides)
    assert [r["step"] for r in out["records"]] == [10, 20, 30]
    for r in out["records"]:
        assert r["param_rel_diff"] < 1e-8 and r["n_valid"] == r["n_valid_j"] > 0, r
        assert_close(r["loss"], r["loss_j"], 1e-8, "loss")
    rows = [gmm_fab_cells.tails(
        [(name, str(tmp_path / name / "model_checkpoints" / "iter_30" / "state.pkl"))],
        torch.device("cpu"), 500, overrides).splitlines()[-1].split("|")[2:7]
        for name in ("port", "fab_tpu")]
    for a, b in zip(*rows):
        assert_close(float(a), float(b), 1e-6, "tails")


def test_bias_pair_matches_fab_tpu():
    rng = np.random.default_rng(1)
    kw = dict(dim=2, n_mixes=6, loc_scaling=4.0, true_expectation_estimation_n_samples=200)
    x = 5.0 * rng.standard_normal((300, 2))
    log_w = rng.standard_normal(300) * 3.0
    log_w[::13] = -np.inf
    log_w[5] = np.nan
    log_w[7] = -2000.0  # its normalised weight underflows to exactly 0
    with jax.enable_x64():
        target_j = JaxGMM(**kw, dtype=jnp.float64)
        want = [float(v) for v in jax_expectation.bias_pair(target_j, jnp.asarray(x),
                                                            jnp.asarray(log_w))]
    target = GMM(**kw, dtype=DT, device="cpu")
    target.true_expectation = torch.tensor(float(target_j.true_expectation), dtype=DT)
    got = evaluate_expectation.bias_pair(target, torch.tensor(x), torch.tensor(log_w))
    assert_close(torch.stack(got), want, 1e-12, "bias pair")


def test_expectation_estimates_match_fab_tpu_on_replayed_draws(tmp_path, monkeypatch):
    """On a float64 GMM checkpoint written by fab_tpu."""
    cfg = apply_overrides(load_config(str(CONFIGS / "gmm.yaml")),
                          GMM_TINY + ["training.use_64_bit=true"])
    n, repeats = 50, 3
    kw = dict(dim=2, n_mixes=40, loc_scaling=40.0, true_expectation_estimation_n_samples=1000)
    ckpt = tmp_path / "iter_1" / "state.pkl"
    with jax.enable_x64():
        target_j = JaxGMM(**kw, dtype=jnp.float64)
        _write_jax_checkpoint(ckpt, jax_setup_model(cfg, target_j), 4, jnp.float64)
        key_t, key_m = jax.random.split(jax.random.key(3))
        b_t, bu_t = jax_expectation.evaluate_target(target_j, key_t, n, repeats)
        b_m, bu_m = jax_expectation.evaluate_model(cfg, target_j, str(ckpt), key_m, n,
                                                   repeats)
        noise = {"randint": [], "normal": []}
        for k in jax.random.split(key_t, repeats):
            k_comp, k_eps = jax.random.split(k)
            noise["randint"].append(np.asarray(jax.random.randint(k_comp, (n,), 0, 40)))
            noise["normal"].append(np.asarray(jax.random.normal(k_eps, (n, 2), jnp.float64)))
        flow_j = jax_setup_model(cfg, target_j).flow
        for k in jax.random.split(key_m, repeats):
            noise["normal"] += flow_sample_noise(flow_j, k, n, 2, jnp.float64)["normal"]
    target = GMM(**kw, dtype=DT, device="cpu")
    target.true_expectation = torch.tensor(float(target_j.true_expectation), dtype=DT)
    replay = NoiseReplay(monkeypatch, noise)
    got_t = evaluate_expectation.evaluate_target(target, None, n, repeats)
    got_m = evaluate_expectation.evaluate_model(cfg, target, str(ckpt), None, n, repeats,
                                                dtype=DT, device="cpu")
    replay.assert_consumed()
    for got, want, what in zip(got_t + got_m, (b_t, bu_t, b_m, bu_m),
                               ("target", "target unweighted", "model", "model unweighted")):
        assert got.shape == (repeats,)
        assert_close(got, want, 1e-10, what)


def test_evaluate_expectation_main_matches_fab_tpu_columns(gmm_run, tmp_path):
    args = ["--config", str(CONFIGS / "gmm.yaml"), "--run", f"fab_seed0={gmm_run}",
            "--num-samples", "40", "--n-repeats", "3"]
    rows = evaluate_expectation.main(args + ["--out", str(tmp_path / "port.csv"),
                                             "--device", "cpu", *GMM_TINY])
    jax_expectation.main(args + ["--out", str(tmp_path / "jax.csv"), *GMM_TINY])
    port, fab = _csv(tmp_path / "port.csv"), _csv(tmp_path / "jax.csv")
    assert list(port[0]) == list(fab[0]) == evaluate_expectation.COLUMNS
    assert [r["model_name"] for r in port] == [r["model_name"] for r in fab] == [
        "target", "fab_seed0"]
    assert all(np.isfinite(r[k]) for r in rows for k in ("bias", "std", "bias_unweighted"))


ALDP_TINY = ["flow.blocks=2", "flow.hidden_units=16", "fab.n_int_dist=1", "fab.n_inner=1"]


@pytest.fixture(scope="module")
def aldp_run(tmp_path_factory):
    """An ALDP run directory with a checkpoint written by fab_tpu (tiny flow, the
    golden frame as data.transform) and an L-form test set near the minimum."""
    root = tmp_path_factory.mktemp("aldp")
    frame = root / "frame.npy"
    np.save(frame, np.load(GOLDEN).reshape(1, 66) * 10.0)
    overrides = ALDP_TINY + [f"data.transform={frame}"]
    cfg = apply_overrides(load_config(str(CONFIGS / "aldp.yaml")), overrides)
    model_j, target_j = jax_make_aldp_model(cfg)
    _write_jax_checkpoint(root / "model_checkpoints" / "iter_5" / "state.pkl", model_j, 2,
                          jnp.float32)
    z_min = np.asarray(target_j.transform.cartesian_to_flow(
        jnp.asarray(target_j.ref_cartesian))[0])
    rng = np.random.default_rng(0)
    np.save(root / "test_set.npy", z_min + 0.05 * rng.standard_normal((300, 60)))
    return root, overrides


def test_sample_aldp_main_matches_fab_tpu_keys(aldp_run, tmp_path):
    root, overrides = aldp_run
    args = ["--config", str(CONFIGS / "aldp.yaml"), "--run", str(root), "--n-samples", "32",
            "--batch", "16"]
    sample_aldp.main(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu",
                             *overrides])
    jax_sample.main(args + ["--out", str(tmp_path / "jax.npz"), *overrides])
    port, fab = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(port) == sorted(fab)
    for k in fab:
        assert port[k].shape == fab[k].shape and port[k].dtype == fab[k].dtype, k
        assert np.isfinite(port[k]).all(), k


def test_reeval_aldp_main_matches_fab_tpu_columns(aldp_run, tmp_path):
    root, overrides = aldp_run
    args = ["--config", str(CONFIGS / "aldp.yaml"), "--run", str(root), "--n-samples", "100",
            "--batch", "100"]
    metrics = reeval_aldp.main(args + ["--out-dir", str(tmp_path / "port"), "--device",
                                       "cpu", *overrides])
    jax_reeval.main(args + ["--out-dir", str(tmp_path / "jax"), *overrides])
    port = _csv(tmp_path / "port" / "metrics" / "metrics.csv")
    fab = _csv(tmp_path / "jax" / "metrics" / "metrics.csv")
    assert list(port[0]) == list(fab[0]) == list(metrics) and len(port) == 1
    assert port[0]["iter"] == fab[0]["iter"] == "5"
    assert all(np.isfinite(float(v)) for v in port[0].values())
    assert sorted(p.name for p in (tmp_path / "port" / "plots").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax" / "plots").iterdir())


@pytest.mark.parametrize("script", [evaluate, evaluate_expectation, sample_aldp, reeval_aldp,
                                    profile_aldp], ids=lambda m: m.__name__.split(".")[-1])
def test_scripts_default_to_the_card(script, gmm_run):
    """Without ``--device`` a script runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    config = "gmm.yaml" if script in (evaluate, evaluate_expectation) else "aldp.yaml"
    argv = ["--config", str(CONFIGS / config)]
    if script in (sample_aldp, reeval_aldp):
        argv += ["--run", str(gmm_run)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(argv)
    assert inspect.signature(load_model).parameters["device"].default == "cuda"
    assert inspect.signature(evaluate.evaluate_checkpoint).parameters["device"].default == "cuda"
