"""The ALDP slice of the port against fab_tpu, on the CPU.

- One whole float64 ``PrioritisedBufferTrainer`` step on a tiny ALDP model (2 spline
  blocks, hidden 16, 4 bins; HMC; the chirality filter; cosine schedule with
  warm-up) on shared parameters and replayed noise: loss, flow parameters, Adam
  state and buffer to 1e-8; eager, and compiled (``make_train_step`` against
  ``fab_tpu``'s jitted step, ``make_scanned_train_step`` against its scan). The
  circular spline bound is set to fab_tpu's float32 pi for this comparison
  (``fab_tpu_torch/flows/splines.py`` says why they differ).
- One ``generate_test_set`` HMC sweep on replayed noise: 1e-8; the port's whole
  ``generate_test_set`` keeps L-form rows only.
- The LARS + SNF ALDP flow (``make_aldp_flow``, tiny) on replayed noise: 1e-8.
- ``run_aldp`` on all seven configs (aldp.yaml with a resume, aldp_fab_no_buff.yaml,
  aldp_kld.yaml, aldp_al2div.yaml, aldp_ml.yaml, aldp_rbd.yaml with the LARS base and
  aldp_snf.yaml with MH layers) at a tiny size: finite ``logging_hist.csv`` and
  ``metrics.csv`` columns.
"""
import csv
import math
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.make_aldp_model import make_aldp_flow as jax_make_aldp_flow
from fab_tpu.sampling import HamiltonianMonteCarlo as JaxHMC
from fab_tpu.sampling import create_point as jax_create_point
from fab_tpu.targets.aldp import AldpBoltzmann as JaxAldp
from fab_tpu.utils.aldp_eval import chirality_scale_shift as jax_scale_shift
from fab_tpu.utils.aldp_eval import make_chirality_filter_jax
from fab_tpu_torch import random as port_random
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.experiments import run_aldp
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_flow
from fab_tpu_torch.flows import ResampledGaussianBase, StochasticFlow, splines
from fab_tpu_torch.sampling import HamiltonianMonteCarlo, create_point
from fab_tpu_torch.targets.aldp import AldpBoltzmann
from fab_tpu_torch.train import PrioritisedBufferTrainer, Trainer
from fab_tpu_torch.utils.aldp_eval import (
    chirality_scale_shift,
    filter_chirality,
    make_chirality_filter,
)
from torch_parity_utils import (
    NoiseReplay,
    assert_close,
    check_train_step,
    flow_sample_noise,
    hmc_noise,
    snf_log_prob_noise,
    to_np,
)

DT = torch.float64
ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "experiments" / "configs"
GOLDEN = ROOT / "tests" / "data" / "aldp_openmm_min_energy_nm.npy"
F32_PI = float(np.float32(np.pi))


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("aldp") / "golden_angstrom.npy"
    np.save(path, np.load(GOLDEN).reshape(1, 66) * 10.0)
    return path


@pytest.fixture(scope="module")
def targets(ref_path):
    with jax.enable_x64():
        target_j = JaxAldp(data_path=str(ref_path), temperature=300.0, env="implicit")
    target = AldpBoltzmann(data_path=str(ref_path), temperature=300.0, env="implicit",
                           dtype=DT, device="cpu")
    return target_j, target


def _z_ref(target):
    ref = torch.as_tensor(target.ref_cartesian)
    return target.transform.cartesian_to_flow(ref)[0].numpy()


@pytest.mark.parametrize("compiled", [None, "step", "scanned"],
                         ids=["eager", "step", "scanned"])
def test_prioritised_trainer_step_on_aldp_matches(targets, monkeypatch, compiled):
    """Eager, through ``make_train_step`` against ``fab_tpu``'s jitted step, or
    through ``make_scanned_train_step`` against its ``lax.scan``."""
    target_j, target = targets
    monkeypatch.setattr(splines, "CIRCULAR_BOUND", F32_PI)  # fab_tpu's float32 pi
    circ = target.transform.circular_flow_dims
    kw = dict(n_blocks=2, hidden_units=16, n_bins=4, seed=0)
    jax_flow = jax_make_aldp_flow(60, circ, **kw)
    rng = np.random.default_rng(0)
    with jax.enable_x64():
        params = to_np(jax_flow.init(jax.random.key(0), jnp.float64))
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape), params)
    flow = make_aldp_flow(60, circ, dtype=DT, device="cpu", **kw)
    flow.load_state_dict(from_jax_params(params))
    scale, shift = chirality_scale_shift(target.transform)
    assert (scale, shift) == jax_scale_shift(target_j.transform)
    filters = (make_chirality_filter_jax(scale=scale, shift=shift),
               make_chirality_filter(scale=scale, shift=shift))
    hmc_kw = dict(n_ais_intermediate_distributions=2, n_outer=1, n_leapfrog=2, epsilon=0.1)
    info, new, _, _ = check_train_step(
        monkeypatch, (jax_flow, params, flow), targets, 60, 64, 2, n_batches=2,
        hmc_kw=hmc_kw, filters=filters,
        optimizer_kw=dict(schedule="cosine", total_steps=10, warmup_steps=3),
        compiled=compiled,
    )
    assert 0.0 < float(info["frac_filter_pass"]) < 1.0
    assert int(new.opt_state.count) == 2


def test_lars_snf_aldp_flow_matches(targets, monkeypatch):
    """make_aldp_flow with the LARS base and an MH layer (lam 1/2, 1) after each of 2
    blocks, on the implicit-solvent target: the layers at fab_tpu's indexes, a
    replayed draw and a keyed log q."""
    target_j, target = targets
    monkeypatch.setattr(splines, "CIRCULAR_BOUND", F32_PI)  # fab_tpu's float32 pi
    circ = target.transform.circular_flow_dims
    kw = dict(n_blocks=2, hidden_units=16, n_bins=4, seed=0, base_type="resampled",
              snf_every=1, snf_steps=2, snf_proposal_scale=0.05)
    n, key = 16, jax.random.key(4)
    rng = np.random.default_rng(1)
    jax_flow = jax_make_aldp_flow(60, circ, target_log_prob=target_j.log_prob, **kw)
    with jax.enable_x64():
        params = to_np(jax_flow.init(jax.random.key(0), jnp.float64))
        params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape), params)
        x_in = _z_ref(target) + 0.02 * rng.standard_normal((n, 60))
        # Jitted: eager dispatch of the force field inside the MH layers is slow.
        x_j, lq_j, lp_j = to_np(jax.jit(lambda p, k, x: (
            *jax_flow.sample_and_log_prob(p, k, n), jax_flow.log_prob(p, x, key=k)
        ))(params, key, jnp.asarray(x_in)))
        sample_noise = flow_sample_noise(jax_flow, key, n, 60, jnp.float64)
        lp_noise = snf_log_prob_noise(jax_flow, key, (n, 60), jnp.float64)
    flow = make_aldp_flow(60, circ, target_log_prob=target.log_prob, dtype=DT, device="cpu",
                          **kw)
    assert [type(b).__name__ for b in flow.bijectors] == [
        type(b).__name__ for b in jax_flow.layers]
    assert [b.lam for b in flow.bijectors if hasattr(b, "lam")] == [0.5, 1.0]
    flow.load_state_dict(from_jax_params(params))
    replay = NoiseReplay(monkeypatch, sample_noise, keys=[lp_noise])
    with torch.no_grad():
        x, lq = flow.sample_and_log_prob(n, None)
        lp = flow.log_prob(torch.tensor(x_in), port_random.split(None))
    replay.assert_consumed()
    assert_close(x, x_j, 1e-8, "x")
    assert_close(lq, lq_j, 1e-8, "sample log q")
    assert_close(lp, lp_j, 1e-8, "log_prob")


def test_generate_test_set_sweep_matches(targets, monkeypatch):
    """One sweep as generate_test_set makes it (HMC at beta = 1 with the target
    alone, 10 leapfrog steps of 0.05, tuning on) from the reference plus noise."""
    target_j, target = targets
    n_chains, dim = 16, 60
    rng = np.random.default_rng(5)
    z = _z_ref(target) + 0.01 * rng.standard_normal((n_chains, dim))
    key = jax.random.key(3)
    kw = dict(n_ais_intermediate_distributions=1, n_outer=1, n_leapfrog=10, epsilon=0.05)
    with jax.enable_x64():
        op_j = JaxHMC(**kw)
        log_q_j = lambda x: jnp.zeros(x.shape[:-1])  # noqa: E731
        mask_j = jnp.ones(n_chains, bool)

        @jax.jit
        def sweep(z):
            point = jax_create_point(z, log_q_j, target_j.log_prob, with_grad=True)
            return op_j.transition(op_j.init_state(dim), key, point, jnp.asarray(1.0),
                                   jnp.asarray(0), log_q_j, target_j.log_prob, 1.0,
                                   mask_j, True)

        point_j, state_j, _ = to_np(sweep(jnp.asarray(z)))
        noise = hmc_noise(key, 1, (n_chains, dim), jnp.float64)
    op = HamiltonianMonteCarlo(**kw)
    log_q = lambda x: (x * 0.0).sum(-1)  # noqa: E731
    point = create_point(torch.tensor(z), log_q, target.log_prob, with_grad=True)
    replay = NoiseReplay(monkeypatch, noise)
    # float32 step sizes, as generate_test_set keeps them in both packages.
    point, state, _ = op.transition(op.init_state(dim, torch.float32), None, point, 1.0, 0, log_q,
                                    target.log_prob, 1.0, torch.ones(n_chains, dtype=bool),
                                    True)
    replay.assert_consumed()
    for name in ("x", "log_p", "grad_log_p"):
        assert_close(getattr(point, name), getattr(point_j, name), 1e-8, name)
    for k in ("epsilons", "common_epsilon"):
        assert_close(state[k], state_j[k], 1e-12, k)
    assert 0 < int((np.abs(point_j.x - z) > 0).any(-1).sum()) <= n_chains  # moves made


def test_generate_test_set_keeps_l_form_rows(targets, monkeypatch):
    """The port's whole generate_test_set: burn-in, the L-form filter, the cut
    (chunks of 5 sweeps here, not 20, to save time)."""
    _, target = targets
    monkeypatch.setattr(run_aldp, "SWEEPS_PER_CHUNK", 5)
    gen = torch.Generator().manual_seed(0)
    data = run_aldp.generate_test_set(target, gen, n_samples=40, n_steps=10, n_chains=16)
    assert data.shape == (40, 60) and np.isfinite(data).all()
    scale, shift = chirality_scale_shift(target.transform)
    assert filter_chirality(data, scale=scale, shift=shift).all()
    # 2 chunks, the second kept: 16 rows, tiled to 40.
    np.testing.assert_array_equal(data[16:32], data[:16])


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _finite(rows, names):
    for row in rows:
        for name in names:
            if row.get(name):
                assert math.isfinite(float(row[name])), (name, row[name])


TINY = ["flow.blocks=2", "flow.hidden_units=16", "flow.num_bins=4", "fab.n_int_dist=2",
        "fab.n_inner=2", "training.batch_size=32", "training.eval_batch_size=32",
        "training.n_test_samples=200", "training.test_mcmc_steps=20",
        "training.final_eval_samples=1000", "training.n_eval=1", "training.n_checkpoints=1",
        "training.log_every=1", "training.log_iter=1", "training.warmup_iter=2"]
TINY_BUFFER = ["training.replay_buffer.min_length=2", "training.replay_buffer.max_length=8",
               "training.replay_buffer.n_updates=2"]


def _run(config, save_root, ref_path, *extra):
    tiny = TINY + (TINY_BUFFER if config in ("aldp.yaml", "aldp_rbd.yaml", "aldp_snf.yaml")
                   else [])
    return run_aldp.main(["--config", str(CONFIGS / config), "--device", "cpu",
                          f"data.transform={ref_path}", f"training.save_root={save_root}",
                          *tiny, *extra])


def test_runner_aldp_yaml_runs_and_resumes(tmp_path, ref_path):
    root = tmp_path / "aldp"
    trainer, state, metrics = _run("aldp.yaml", root, ref_path, "training.max_iter=2")
    assert isinstance(trainer, PrioritisedBufferTrainer) and state.step == 2
    assert trainer.model.sample_filter is not None and trainer.model.target.env == "implicit"
    assert trainer.optimizer.lr.schedule == "cosine" and trainer.optimizer.lr.warmup_steps == 2
    assert all(math.isfinite(v) for v in metrics.values())
    rows = _rows(root / "logging_hist.csv")
    assert [r["step"] for r in rows if r.get("loss")] == ["1.0", "2.0"]
    _finite(rows, ("loss", "frac_filter_pass", "eval_ess_ais_p_target"))
    assert all(r.get("frac_filter_pass") for r in rows if r.get("loss"))
    assert (root / "test_set.npy").exists() and len(_rows(root / "metrics" / "metrics.csv")) == 1
    # Resume from the checkpoint at iteration 2 for one more iteration.
    trainer, state, _ = _run("aldp.yaml", root, ref_path, "training.max_iter=3")
    assert state.step == 3
    rows = _rows(root / "logging_hist.csv")
    assert [r["step"] for r in rows if r.get("loss")] == ["1.0", "2.0", "3.0"]
    assert len(_rows(root / "metrics" / "metrics.csv")) == 2


# The SNF variant at the tiny depth: an MH layer of 2 steps after each of the 2
# blocks (aldp_snf.yaml: after every 4th of 12, 10 steps).
VARIANT_EXTRA = {"aldp_snf.yaml": ["flow.snf.every=1", "flow.snf.steps=2"]}


@pytest.mark.parametrize("config,trainer_type", [
    ("aldp_fab_no_buff.yaml", Trainer), ("aldp_kld.yaml", Trainer),
    ("aldp_al2div.yaml", Trainer), ("aldp_ml.yaml", None),
    ("aldp_rbd.yaml", PrioritisedBufferTrainer), ("aldp_snf.yaml", PrioritisedBufferTrainer),
])
def test_runner_variants_run(config, trainer_type, tmp_path, ref_path):
    root = tmp_path / "run"
    root.mkdir()
    # A test set (and ML's training set) made once, as the runner caches them.
    target = AldpBoltzmann(data_path=str(ref_path), device="cpu")
    z = _z_ref(target) + 0.02 * np.random.default_rng(0).standard_normal((200, 60))
    np.save(root / "test_set.npy", z)
    shutil.copy(root / "test_set.npy", root / "train_set.npy")
    trainer, state, metrics = _run(config, root, ref_path, "training.max_iter=2",
                                   "training.n_train_samples=200",
                                   *VARIANT_EXTRA.get(config, []))
    assert all(math.isfinite(v) for v in metrics.values())
    assert len(_rows(root / "metrics" / "metrics.csv")) == 1
    if trainer_type is None:
        assert trainer is None and (root / "model_checkpoints" / "iter_2" / "state.pkl").exists()
        return
    assert type(trainer) is trainer_type and state.step == 2
    rows = _rows(root / "logging_hist.csv")
    _finite(rows, ("loss", "grad_norm", "eval_ess_flow", "eval_ess_ais_p_target",
                   "frac_filter_pass"))
    assert [r["step"] for r in rows if r.get("loss")] == ["1.0", "2.0"]
    flow = trainer.model.flow
    assert isinstance(flow.base, ResampledGaussianBase) == (config == "aldp_rbd.yaml")
    assert isinstance(flow, StochasticFlow) == (config == "aldp_snf.yaml")
    if config == "aldp_snf.yaml":
        assert [b.n_steps for b in flow.bijectors if hasattr(b, "lam")] == [2, 2]

