"""The port's data parallelism against ``fab_tpu`` and through its runners, on the
CPU over gloo (ranks spawned by ``tests/torch_parallel_workers.py``, which loads no
JAX; ``tests/test_torch_parallel.py`` holds the set-up helpers and the ranks against
one process).

- A 4-rank port step against ``fab_tpu``'s step on a 4-device mesh (the virtual CPU
  devices of ``tests/test_sharding.py``), on replayed noise, at f64 to 1e-8; the
  compiled step on 2 ranks against eager steps (bitwise) and against ``fab_tpu``'s
  step on a 2-device mesh (1e-8).
- ``run_gmm`` / ``run_many_well`` with ``mesh.n_data=2`` under a launcher's
  variables for 2 iterations: only rank 0 writes, and its checkpoint resumes in one
  process to the 2-rank run's next step.
- Checkpoints across packages: the 2-rank run's checkpoint resumes in ``fab_tpu``
  to the port's next step, and a ``fab_tpu`` checkpoint resumes on 2 ranks to
  ``fab_tpu``'s next step, on replayed noise at f64 to 1e-8.
"""
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from experiments.setup_run import setup_model as jax_setup_model
from fab_tpu.buffer import PrioritisedBufferState as JaxBufferState
from fab_tpu.buffer import PrioritisedReplayBuffer as JaxBuffer
from fab_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fab_tpu.parallel.mesh import use_mesh as jax_use_mesh
from fab_tpu.sampling import HamiltonianMonteCarlo as JaxHMC
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu.train import BufferTrainState as JaxBufferTrainState
from fab_tpu.train import PrioritisedBufferTrainer as JaxTrainer
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu_torch.checkpoint import load_checkpoint
from fab_tpu_torch.convert import from_jax_params, to_jax_params
from fab_tpu_torch.experiments import run_gmm
from fab_tpu_torch.experiments.setup_run import setup_trainer
from fab_tpu_torch.targets import ManyWellEnergy
from fab_tpu_torch.utils.training import apply_overrides, load_config
from torch_parity_utils import (
    NoiseReplay,
    ais_noise,
    make_flow_pair,
    random_buffer_inputs,
    to_np,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                 "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


@pytest.fixture
def no_launcher(monkeypatch):
    for name in LAUNCHER_VARS:
        monkeypatch.delenv(name, raising=False)


# ------------------------------------------- 4 ranks against fab_tpu's mesh


REPLAY = dict(dim=4, batch=64, n_layers=2, nodes=2, n_dists=2, n_batches=2,
              hmc=dict(n_ais_intermediate_distributions=2, n_leapfrog=3, epsilon=0.3))


def _fab_tpu_setup():
    """fab_tpu's f64 PrioritisedBufferTrainer on ManyWell-4 and a state (perturbed
    flow, a buffer of 192 rows with dead ones), the noise of one step at key 5 (in
    the port's draw order) and the port flow's trainable names. Call under x64."""
    dim, batch, n_dists = REPLAY["dim"], REPLAY["batch"], REPLAY["n_dists"]
    rng = np.random.default_rng(9)
    jax_flow, params, flow = make_flow_pair(dim, REPLAY["n_layers"], REPLAY["nodes"],
                                            torch.float64, seed=2)
    model_j = JaxFABModel.create(jax_flow, JaxManyWell(dim),
                                 transition_operator=JaxHMC(**REPLAY["hmc"]),
                                 n_intermediate_distributions=n_dists)
    buf_j = JaxBuffer(dim=dim, max_length=512, min_sample_length=128)
    trainer_j = JaxTrainer(model_j, jax_make_optimizer(1e-2, 100.0), buf_j,
                           n_batches_buffer_sampling=REPLAY["n_batches"],
                           w_adjust_max_clip=10.0, dtype=jnp.float64)
    buffer_j = buf_j.init(jnp.float64)
    for _ in range(3):
        buffer_j = buf_j.add(buffer_j, *random_buffer_inputs(rng, batch, dim))
    trans_j = to_np(model_j.ais.transition_operator.init_state(dim, jnp.float64))
    state_j = JaxBufferTrainState(
        params={"flow": params, "transition": trans_j},
        opt_state=trainer_j.optimizer.init(params), buffer_state=buffer_j,
        step=jnp.zeros((), jnp.int32))
    key = jax.random.key(5)
    key_ais, key_sample = jax.random.split(key)
    noise = ais_noise(key_ais, n_dists, 1, batch, dim, jnp.float64, flow=jax_flow)
    noise["gumbel"] = [np.asarray(jax.random.gumbel(key_sample, (512,), jnp.float64))]
    names = [n for n, p in flow.named_parameters() if p.requires_grad]
    return trainer_j, state_j, key, noise, names


def _check_against_fab_tpu(results, new_j, info_j, names):
    """Flow, Adam, HMC state, buffer and info of each port result against fab_tpu's
    step, to 1e-8."""
    expected_flow = from_jax_params(new_j.params["flow"])
    adam_j = new_j.opt_state[1][0]
    mu_j, nu_j = from_jax_params(adam_j.mu), from_jax_params(adam_j.nu)
    for result in results:
        for name, value in expected_flow.items():
            workers.close(result["flow"][name], value.numpy(), 1e-8, name)
        assert result["count"] == int(adam_j.count)
        for name, mu, nu in zip(names, result["mu"], result["nu"]):
            workers.close(mu, mu_j[name].numpy(), 1e-8, "mu " + name)
            workers.close(nu, nu_j[name].numpy(), 1e-8, "nu " + name)
        for k in ("epsilons", "common_epsilon", "mass"):
            workers.close(result["transition"][k], new_j.params["transition"][k], 1e-8, k)
        for field, value in new_j.buffer_state._asdict().items():
            workers.close(result["buffer"][field], value, 1e-8, "buffer " + field)
        for k in ("loss", "grad_norm", "n_valid", "w_adjust_mean", "sampled_log_w_mean",
                  "sampled_log_w_std", "ess_ais"):
            workers.close(result["info"][k], info_j[k], 1e-8, k)
        assert result["info"]["update_applied"] == 1.0


def test_four_rank_step_equals_fab_tpu_on_a_four_device_mesh(tmp_path):
    """One f64 PrioritisedBufferTrainer step: fab_tpu's, jitted over a ("data",
    "model") = (4, 1) mesh of virtual CPU devices, and the port's on 4 gloo ranks,
    from the same parameters and buffer (192 rows, some dead) on the same noise (the
    ranks replay it at the global shape). Flow, Adam, HMC state, buffer and info
    agree to 1e-8."""
    with jax.enable_x64():
        trainer_j, state_j, key, noise, names = _fab_tpu_setup()
        with jax_use_mesh(jax_make_mesh(4, 1, devices=jax.devices("cpu")[:4])):
            new_j, info_j = to_np(jax.jit(trainer_j._train_step_fn(REPLAY["batch"]))(
                state_j, key))
    params, buffer_j = state_j.params, state_j.buffer_state
    args = dict(REPLAY, noise=noise, transition=dict(params["transition"]),
                flow={k: v.numpy() for k, v in from_jax_params(params["flow"]).items()},
                buffer=to_np(buffer_j)._asdict())
    _check_against_fab_tpu(workers.run_ranks("replayed_step", 4, args, str(tmp_path)),
                           new_j, info_j, names)


def test_two_rank_compiled_step_equals_fab_tpu_on_a_two_device_mesh(tmp_path):
    """The compiled step under a 2-rank gloo data mesh (no CUDA graph on the CPU: the
    program's static tensors and noise tape, its collectives run in each call). On
    the ranks, 3 ``make_train_step`` calls and one ``make_scanned_train_step(b, 3)``
    equal 3 eager steps from one seed bit for bit; one ``make_train_step`` call on
    replayed noise equals ``fab_tpu``'s jitted step on a (2, 1) mesh to 1e-8."""
    with jax.enable_x64():
        trainer_j, state_j, key, noise, names = _fab_tpu_setup()
        with jax_use_mesh(jax_make_mesh(2, 1, devices=jax.devices("cpu")[:2])):
            new_j, info_j = to_np(jax.jit(trainer_j._train_step_fn(REPLAY["batch"]))(
                state_j, key))
    params, buffer_j = state_j.params, state_j.buffer_state
    args = dict(REPLAY, noise=noise, transition=dict(params["transition"]),
                flow={k: v.numpy() for k, v in from_jax_params(params["flow"]).items()},
                buffer=to_np(buffer_j)._asdict())
    results = workers.run_ranks("compiled_step", 2, args, str(tmp_path))
    for result in results:
        assert result["bitwise"] == {"step": True, "scanned": True}, result["bitwise"]
        supported, reason = result["supported"]
        assert supported and "gloo collectives over 2 data ranks" in reason, reason
        assert result["replays"] == 1 and not result["has_graph"]
    _check_against_fab_tpu(results, new_j, info_j, names)


def test_fab_tpu_checkpoint_resumes_on_two_ranks(tmp_path):
    """A checkpoint of fab_tpu's trainer (its optimizer library's Adam state, its
    buffer named tuple) loads on 2 ranks (the buffer scattered), and their next step
    on replayed noise is fab_tpu's, to 1e-8."""
    ckpt = str(tmp_path / "fab_tpu_state.pkl")
    with jax.enable_x64():
        trainer_j, state_j, key, noise, names = _fab_tpu_setup()
        jax_save_checkpoint(ckpt, state_j._asdict())
        new_j, info_j = to_np(jax.jit(trainer_j._train_step_fn(REPLAY["batch"]))(
            state_j, key))
    args = dict(REPLAY, noise=noise, checkpoint=ckpt)
    _check_against_fab_tpu(workers.run_ranks("replayed_step", 2, args, str(tmp_path)),
                           new_j, info_j, names)


# ---------------------------------------------------- the runners on 2 ranks

RUNNERS = {
    "run_gmm": ["--config", str(ROOT / "experiments" / "configs" / "gmm.yaml"),
                "--device", "cpu", "flow.n_layers=2", "flow.layer_nodes_per_dim=4",
                "training.batch_size=32", "training.n_flow_forward_pass=null",
                "target.true_expectation_n_samples=1000", "evaluation.eval_batch_size=64"],
    "run_many_well": ["--config", str(ROOT / "experiments" / "configs" / "many_well.yaml"),
                      "--device", "cpu", "target.dim=4", "flow.n_layers=2",
                      "flow.layer_nodes_per_dim=2", "training.batch_size=64",
                      "training.n_flow_forward_pass=null", "training.min_buffer_length=128",
                      "training.maximum_buffer_length=512",
                      "training.n_batches_buffer_sampling=2",
                      "evaluation.eval_batch_size=128"],
}


@pytest.fixture(scope="module")
def runner_runs(tmp_path_factory):
    """Each runner with mesh.n_data=2 under a launcher's variables for 2 iterations
    (one eval, one checkpoint), then one more step on each rank from a fixed
    generator: {runner: (rank results, save_path, argv, batch)}."""
    runs = {}
    for runner in sorted(RUNNERS):
        tmp = tmp_path_factory.mktemp(runner)
        out = tmp / "out"
        argv = RUNNERS[runner] + ["mesh.n_data=2", "training.n_iterations=2",
                                  "evaluation.n_eval=1", "evaluation.n_checkpoints=1",
                                  "evaluation.n_plots=0", f"evaluation.save_path={out}"]
        batch = int(next(a for a in argv
                         if a.startswith("training.batch_size=")).split("=")[1])
        ranks = workers.run_ranks(
            "runner", 2, {"runner": runner, "argv": argv, "batch": batch,
                          "launcher_env": True},
            str(tmp / "ranks"), launcher_env=True)
        runs[runner] = (ranks, out, argv, batch)
    return runs


@pytest.mark.parametrize("runner", sorted(RUNNERS))
def test_runner_on_two_ranks_resumes_in_one_process(runner, runner_runs, no_launcher):
    """Only rank 0 opens a file for writing and logs a row. Rank 0's checkpoint,
    loaded in one process, takes the ranks' next step to 1e-8."""
    ranks, out, argv, batch = runner_runs[runner]
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[1]["writes"] == [] and ranks[1]["logger_rows"] == 0
    assert any(p.endswith("state.pkl.tmp") for p in ranks[0]["writes"])
    assert ranks[0]["logger_rows"] > 0
    (run_dir,) = out.iterdir()  # one time-stamped directory: rank 0's stamp
    ckpt = run_dir / "model_checkpoints" / "iter_2" / "state.pkl"
    assert ckpt.exists() and (run_dir / "logging_hist.csv").exists()

    cfg = apply_overrides(load_config(argv[1]), argv[4:])
    target = (run_gmm.make_target(cfg, torch.device("cpu")) if runner == "run_gmm"
              else ManyWellEnergy(dim=cfg.target.dim, device="cpu"))
    trainer = setup_trainer(cfg, target, device="cpu")
    state, step = trainer.load_state(str(ckpt))
    assert step == 2
    state, info = trainer.train_step(state, torch.Generator().manual_seed(99), batch)
    expected = workers.summary(trainer, state, info)
    for rank, result in enumerate(ranks):
        workers.check_summary(result["next"], expected, f"{runner} rank {rank}",
                              ["loss", "ess_ais"])
    assert os.path.getsize(ckpt) > 0


def test_two_rank_checkpoint_resumes_in_fab_tpu(runner_runs, monkeypatch, no_launcher):
    """run_many_well's 2-rank checkpoint (f64) into fab_tpu's trainer (its Adam state
    rebuilt from the checkpoint's moments): fab_tpu's next step on a key and the
    port's from the same checkpoint on that key's noise agree to 1e-8."""
    _, out, argv, batch = runner_runs["run_many_well"]
    (run_dir,) = out.iterdir()
    ckpt = str(run_dir / "model_checkpoints" / "iter_2" / "state.pkl")
    cfg = apply_overrides(load_config(argv[1]), argv[4:])
    t, dim = cfg.training, cfg.target.dim
    raw = load_checkpoint(ckpt)
    with jax.enable_x64():
        model_j = jax_setup_model(cfg, JaxManyWell(dim))
        optimizer_j = jax_make_optimizer(t.lr, t.get("max_grad_norm"))
        flow_params = raw["params"]["flow"]
        fresh = optimizer_j.init(flow_params)
        n_layers = len(flow_params["layers"])
        moments = [to_jax_params(dict(from_jax_params(getattr(fresh[1][0], name)), **{
            k: torch.as_tensor(v) for k, v in raw["opt_state"][name].items()}), n_layers)
            for name in ("mu", "nu")]
        adam = fresh[1][0]._replace(count=jnp.asarray(raw["opt_state"]["count"]),
                                    mu=moments[0], nu=moments[1])
        state_j = JaxBufferTrainState(
            params=raw["params"], opt_state=(fresh[0], (adam,) + tuple(fresh[1][1:])),
            buffer_state=JaxBufferState(**{k: jnp.asarray(v) for k, v in
                                           raw["buffer_state"].items()}),
            step=jnp.asarray(raw["step"], jnp.int32))
        trainer_j = JaxTrainer(
            model_j, optimizer_j,
            JaxBuffer(dim=dim, max_length=t.maximum_buffer_length,
                      min_sample_length=t.min_buffer_length),
            n_batches_buffer_sampling=t.n_batches_buffer_sampling,
            w_adjust_max_clip=t.get("w_adjust_max_clip"), dtype=jnp.float64)
        key = jax.random.key(11)
        key_ais, key_sample = jax.random.split(key)
        noise = ais_noise(key_ais, cfg.fab.n_intermediate_distributions, 1, batch, dim,
                          jnp.float64, flow=model_j.flow)
        noise["gumbel"] = [np.asarray(jax.random.gumbel(
            key_sample, (t.maximum_buffer_length,), jnp.float64))]
        new_j, info_j = to_np(jax.jit(trainer_j._train_step_fn(batch))(state_j, key))
    trainer = setup_trainer(cfg, ManyWellEnergy(dim=dim, device="cpu"), device="cpu")
    state, _ = trainer.load_state(ckpt)
    replay = NoiseReplay(monkeypatch, noise)
    state, info = trainer.train_step(state, None, batch)
    replay.assert_consumed()
    names = trainer._param_names()
    _check_against_fab_tpu([workers.summary(trainer, state, info)], new_j, info_j, names)
