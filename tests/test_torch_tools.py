"""The port's loggers, profiling helpers and plots against fab_tpu's, on the CPU.

- ``ChainLogger`` fans writes and closes out; ``WandbLogger`` against a stand-in
  ``wandb`` module (imported when the logger is made);
- ``trace`` writes a Chrome trace; ``ThroughputMeter`` on a patched clock, and
  without a card it wants a device count;
- ``plot_contours``, ``plot_marginal_pair`` and ``plot_history`` put the same data
  on their axes as fab_tpu's for the same inputs (grid, clipped log-probs, levels;
  clipped offsets; curves): 1e-12;
- the GMM and ManyWell runners' plotters draw flow and AIS samples over contours,
  the trainer saves them, and the training draws are the same with plots on and
  off; without matplotlib a runner prints ``plots off`` and ``evaluate_aldp`` with a
  ``plot_dir`` raises ``ImportError`` naming matplotlib.
"""
import csv
import json
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.targets import GMM as JaxGMM
from fab_tpu.utils import plotting as jax_plotting
from fab_tpu_torch.experiments import run_gmm, run_many_well
from fab_tpu_torch.experiments.setup_run import setup_model
from fab_tpu_torch.targets import GMM, ManyWellEnergy
from fab_tpu_torch.utils import plotting, profiling
from fab_tpu_torch.utils.aldp_eval import evaluate_aldp
from fab_tpu_torch.utils.logging import ChainLogger, CSVLogger, ListLogger, WandbLogger
from fab_tpu_torch.utils.training import apply_overrides, load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
GMM_CONFIG = str(ROOT / "experiments" / "configs" / "gmm.yaml")


def test_chain_logger_writes_and_closes_every_logger(tmp_path):
    listed, path = ListLogger(), tmp_path / "log.csv"
    chain = ChainLogger([listed, CSVLogger(str(path), save_period=100)])
    chain.write({"loss": torch.tensor(1.5), "step": 1})
    chain.write({"loss": 0.5, "step": 2, "ess": np.float64(0.25)})
    assert listed.history == {"loss": [1.5, 0.5], "step": [1.0, 2.0], "ess": [0.25]}
    assert not path.exists()  # nothing flushed before close
    chain.close()
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert rows == [{"loss": "1.5", "step": "1.0", "ess": ""},
                    {"loss": "0.5", "step": "2.0", "ess": "0.25"}]


def test_wandb_logger_imports_wandb_when_made(monkeypatch):
    logged = []
    run = types.SimpleNamespace(log=lambda data, step: logged.append((step, data)),
                                finish=lambda: logged.append("finished"))
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: logged.append(kw) or run
    monkeypatch.setitem(sys.modules, "wandb", fake)
    logger = WandbLogger(project="fab", mode="offline")
    logger.write({"loss": torch.tensor(2.0)})
    logger.write({"loss": 1.0})
    logger.close()
    assert logged == [{"project": "fab", "mode": "offline"}, (0, {"loss": 2.0}),
                      (1, {"loss": 1.0}), "finished"]
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError):
        WandbLogger()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_throughput_meter_on_a_patched_clock(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(profiling.time, "time", lambda: now[0])
    meter = profiling.ThroughputMeter(n_devices=4)
    meter.update(1000)
    now[0] = 102.0
    meter.update(600)
    assert meter.samples_per_s == 800.0 and meter.samples_per_s_per_chip == 200.0
    meter.reset()
    now[0] = 103.0
    assert meter.samples == 0 and meter.samples_per_s == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.ThroughputMeter()


class _Axes:
    """Records the calls made on it."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args, **kw: self.calls.append((name, args, kw))


def _same_calls(a, b, tol=1e-12):
    assert [(n, len(args), kw) for n, args, kw in a.calls] == [
        (n, len(args), kw) for n, args, kw in b.calls]
    for (_, args, _), (_, args_j, _) in zip(a.calls, b.calls):
        for x, y in zip(args, args_j):
            if isinstance(x, str):
                assert x == y
            else:
                np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=tol, atol=tol)


@pytest.mark.parametrize("levels", [None, 7])
def test_plot_contours_matches_fab_tpu(levels):
    kw = dict(dim=2, n_mixes=6, loc_scaling=4.0, true_expectation_estimation_n_samples=100)
    with jax.enable_x64():
        target_j = JaxGMM(**kw, dtype=jnp.float64)
        ax_j = _Axes()
        jax_plotting.plot_contours(target_j.log_prob, ax=ax_j, bounds=(-6.0, 6.0),
                                   grid_width_n_points=30, n_contour_levels=levels,
                                   log_prob_min=-15.0)
    ax = _Axes()
    target = GMM(**kw, dtype=torch.float64, device="cpu")
    assert plotting.plot_contours(target.log_prob, ax=ax, bounds=(-6.0, 6.0),
                                  grid_width_n_points=30, n_contour_levels=levels,
                                  log_prob_min=-15.0) is ax
    _same_calls(ax, ax_j)
    (_, (xx, yy, log_p), _), = ax.calls
    assert xx.shape == (30, 30) and log_p.min() == -15.0 and log_p.max() > -15.0


def test_plot_marginal_pair_and_history_match_fab_tpu():
    rng = np.random.default_rng(0)
    samples = 4.0 * rng.standard_normal((50, 4))
    ax_j, ax = _Axes(), _Axes()
    with jax.enable_x64():
        jax_plotting.plot_marginal_pair(jnp.asarray(samples), ax=ax_j, marginal_dims=(1, 3),
                                        bounds=(-3.0, 3.0), alpha=0.3)
    plotting.plot_marginal_pair(torch.tensor(samples), ax=ax, marginal_dims=(1, 3),
                                bounds=(-3.0, 3.0), alpha=0.3)
    _same_calls(ax, ax_j, tol=0.0)
    assert np.abs(ax.calls[0][1][0]).max() == 3.0

    plt = plotting.pyplot()
    history = {"loss": [3.0, 2.0, 1.5], "ess": [0.1, 0.2]}
    lines = []
    for plot_history in (jax_plotting.plot_history, plotting.plot_history):
        plot_history(history)
        fig = plt.gcf()
        lines.append([(a.get_title(), a.lines[0].get_xydata().tolist()) for a in fig.axes])
        plt.close(fig)
    assert lines[0] == lines[1] and [t for t, _ in lines[1]] == ["loss", "ess"]


GMM_TINY = ["--device", "cpu", "flow.n_layers=2", "flow.layer_nodes_per_dim=4",
            "training.batch_size=32", "training.n_flow_forward_pass=null",
            "target.true_expectation_n_samples=1000", "evaluation.n_eval=0",
            "evaluation.n_checkpoints=0", "evaluation.n_plots=1", "training.n_iterations=2"]


def _losses(run_dir):
    with open(next(pathlib.Path(run_dir).glob("*/logging_hist.csv"))) as f:
        return [r["loss"] for r in csv.DictReader(f)]


def test_gmm_runner_plots_without_changing_the_run(tmp_path, monkeypatch, capsys):
    """Plots on: one PNG of flow and AIS samples over contours; plots off (no
    matplotlib): the line ``plots off`` and no PNG; the same losses either way."""
    run_gmm.main(["--config", GMM_CONFIG, *GMM_TINY, f"evaluation.save_path={tmp_path / 'on'}"])
    (png,) = (tmp_path / "on").glob("*/plots/*.png")
    assert png.name == "0_iter_2.png" and png.stat().st_size > 10_000
    monkeypatch.setattr(plotting, "plots_available", lambda: False)
    run_gmm.main(["--config", GMM_CONFIG, *GMM_TINY, f"evaluation.save_path={tmp_path / 'off'}"])
    assert plotting.PLOTS_OFF in capsys.readouterr().out.splitlines()
    assert not list((tmp_path / "off").glob("*/plots/*.png"))
    assert _losses(tmp_path / "on") == _losses(tmp_path / "off")


def test_plotters_draw_flow_and_ais_samples():
    gen = torch.Generator().manual_seed(0)
    plt = plotting.pyplot()
    gmm = GMM(dim=2, n_mixes=4, loc_scaling=3.0, true_expectation_estimation_n_samples=100,
              device="cpu")
    many_well = ManyWellEnergy(dim=6, device="cpu")
    for target, plotter in ((gmm, run_gmm.make_plotter(gmm, plot_bound=4.0)),
                            (many_well, run_many_well.make_plotter(many_well))):
        cfg = apply_overrides(load_config(GMM_CONFIG), [
            f"target.dim={target.dim}", "flow.n_layers=2", "flow.layer_nodes_per_dim=2"])
        model = setup_model(cfg, target, device="cpu")
        (fig,) = plotter(model, model.init(gen), gen)
        axes = [a for a in fig.axes if a.lines]
        n_pairs = 1 if target is gmm else 2
        assert len(axes) == 2 * n_pairs
        for ax in axes:
            (points,) = ax.lines
            assert points.get_xydata().shape == (300, 2) and ax.collections  # contours
        plt.close(fig)


def test_evaluate_aldp_needs_matplotlib_for_plots(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not plotting.plots_available()
    with pytest.raises(ImportError, match="matplotlib"):
        evaluate_aldp(None, np.zeros((4, 60)), np.zeros((4, 60)), plot_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())
