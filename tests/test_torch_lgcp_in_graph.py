"""LGCP's ``in_graph_kernel=True`` against fab_tpu's in-graph factor, on the CPU.

- The factor: the port's ``_chol(float64)`` against fab_tpu's ``_chol(jnp.float64)``
  under x64 at grid 40 (D = 1600), 1e-12 (both are LAPACK Cholesky factorisations of
  the same float64 matrix, built from the same float32 coordinates). It differs from
  the f64 factor of the exact coordinates (``chol_np``) by more than 1e-7 (~8.9e-7),
  so a port that reused ``chol_np`` fails here.
- ``log_prob`` and its gradient: float64 at grid 40, 1e-10; float32 at grid 8,
  1e-5 of the value's scale (64-term f32 sums and an f32 factorisation in another
  order; the f32 test of the default target uses the same bound).
- The factor is built once per (dtype, device) and no f64 device constant is kept.
- ``run_lgcp`` and ``evaluate`` with ``target.in_graph_kernel=true`` on the CPU.
"""
import csv
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.targets import LogGaussianCoxProcess as JaxLGCP
from fab_tpu_torch.experiments import evaluate, run_lgcp
from fab_tpu_torch.targets import LogGaussianCoxProcess
from torch_parity_utils import (  # noqa: F401 (one_torch_thread: autouse)
    JAX_DTYPE,
    NP_DTYPE,
    assert_close,
    assert_close_to_scale,
    one_torch_thread,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "experiments" / "configs"


def _pair(grid, dtype):
    with jax.enable_x64(dtype == torch.float64):
        target_j = JaxLGCP(grid_size=grid, in_graph_kernel=True, dtype=JAX_DTYPE[dtype])
    target = LogGaussianCoxProcess(grid_size=grid, in_graph_kernel=True, dtype=dtype,
                                   device="cpu")
    return target_j, target


@pytest.fixture(scope="module")
def grid40():
    return _pair(40, torch.float64)


def test_in_graph_factor_matches_fab_tpu_at_grid_40(grid40):
    target_j, target = grid40
    with jax.enable_x64():
        chol_j = np.asarray(target_j._chol(jnp.float64))
    chol = target._chol(torch.float64, torch.device("cpu")).numpy()
    assert chol.dtype == np.float64 and chol.shape == (1600, 1600)
    assert np.abs(chol - chol_j).max() <= 1e-12
    # The float32 coordinates move the factor off the exact-coordinate one.
    gap = np.abs(chol - target.chol_np).max()
    assert 1e-7 < gap < 2e-6, gap
    assert target._chol_t is None


def _value_and_grad(target, e):
    et = torch.tensor(e, requires_grad=True)
    lp = target.log_prob(et)
    (g,) = torch.autograd.grad(lp.sum(), et)
    return lp.detach().numpy(), g.numpy()


def _value_and_grad_j(target_j, e, dtype):
    with jax.enable_x64(dtype == torch.float64):
        lp, g = jax.vmap(jax.value_and_grad(lambda ei: target_j.log_prob(ei)))(e)
        return np.asarray(lp), np.asarray(g)


def test_in_graph_log_prob_matches_fab_tpu_f64_grid_40(grid40):
    target_j, target = grid40
    e = np.random.default_rng(40).standard_normal((8, 1600))
    lp_j, g_j = _value_and_grad_j(target_j, e, torch.float64)
    lp, g = _value_and_grad(target, e)
    assert_close(lp, lp_j, 1e-10, "log_prob")
    assert_close(g, g_j, 1e-10, "grad")
    # The default target (the f64 factor of the exact coordinates) is another
    # function: its log_prob differs from the in-graph one by more than rounding.
    default = LogGaussianCoxProcess(grid_size=40, dtype=torch.float64, device="cpu")
    lp_default = default.log_prob(torch.tensor(e)).numpy()
    assert np.abs(lp_default - lp).max() > 1e-8


def test_in_graph_log_prob_matches_fab_tpu_f32_grid_8():
    target_j, target = _pair(8, torch.float32)
    e = np.random.default_rng(8).standard_normal((16, 64)).astype(np.float32)
    lp_j, g_j = _value_and_grad_j(target_j, e, torch.float32)
    lp, g = _value_and_grad(target, e)
    assert lp.dtype == NP_DTYPE[torch.float32]
    assert_close_to_scale(lp, lp_j, 1e-5, "log_prob")
    assert_close_to_scale(g, g_j, 1e-5, "grad")
    metrics = target.performance_metrics(torch.tensor(e), torch.zeros(16))
    with jax.enable_x64(False):
        metrics_j = target_j.performance_metrics(jnp.asarray(e), jnp.zeros(16))
    for k in metrics_j:
        assert_close_to_scale(metrics[k], metrics_j[k], 1e-5, k)


def test_in_graph_factor_is_built_once_per_dtype(monkeypatch):
    calls = []
    cholesky = torch.linalg.cholesky
    monkeypatch.setattr(torch.linalg, "cholesky", lambda k: calls.append(k.dtype) or cholesky(k))
    target = LogGaussianCoxProcess(grid_size=4, in_graph_kernel=True, device="cpu")
    e = torch.randn(3, 16)
    for _ in range(3):
        target.log_prob(e)
    target.log_prob(e.double())
    assert calls == [torch.float32, torch.float64]


LGCP_TINY = ["target.grid_size=4", "target.dim=16", "flow.n_layers=2",
             "flow.layer_nodes_per_dim=2", "fab.n_intermediate_distributions=2",
             "fab.transition_operator.n_inner_steps=2", "training.batch_size=16",
             "training.min_buffer_length=32", "training.maximum_buffer_length=64",
             "training.n_iterations=2", "training.use_64_bit=true"]


def test_run_lgcp_and_evaluate_take_the_in_graph_kernel(tmp_path):
    run_lgcp.main(["--config", str(CONFIGS / "lgcp.yaml"), "--device", "cpu", *LGCP_TINY,
                   "target.in_graph_kernel=true", "evaluation.n_eval=1",
                   "evaluation.n_checkpoints=1", "evaluation.n_plots=0",
                   f"evaluation.save_path={tmp_path / 'run'}"])
    (run_dir,) = (tmp_path / "run").iterdir()
    rows = {}
    for flag in ("true", "false"):
        out = tmp_path / f"eval_{flag}.csv"
        evaluate.main(["--config", str(CONFIGS / "lgcp.yaml"), "--device", "cpu",
                       "--run", f"fab_seed0={run_dir}", "--num-samples", "64",
                       "--inner-batch", "32", "--out", str(out), *LGCP_TINY,
                       f"target.in_graph_kernel={flag}"])
        with open(out) as f:
            (rows[flag],) = list(csv.DictReader(f))
    assert set(rows["true"]) == set(rows["false"])
    for k, v in rows["true"].items():
        if k != "model_name":
            assert np.isfinite(float(v)), k
    # Same checkpoint, seed and draws; the two factors differ by f32 coordinate
    # rounding only (~1e-7 at grid 4), so the metrics agree closely.
    for k in ("eval_ess_flow", "eval_ess_ais"):
        assert abs(float(rows["true"][k]) - float(rows["false"][k])) < 1e-4, k
