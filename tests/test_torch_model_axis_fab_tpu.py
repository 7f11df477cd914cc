"""The port's model axis against ``fab_tpu`` and through a runner, on the CPU over
gloo (ranks spawned by ``tests/torch_parallel_workers.py``, which loads no JAX;
``tests/test_torch_model_axis.py`` holds the runs against one process).

- A 4-rank (2, 2) port step against ``fab_tpu``'s step on a (2, 2) mesh over 4 of
  the virtual CPU devices, its flow placed by ``fab_tpu``'s ``shard_flow_params``
  (coupling MLPs split column / row over "model"), on replayed noise, at f64 to
  1e-8.
- Checkpoints across packages on (2, 2): the port's checkpoint (written by the
  split ranks in the one-process layout) resumed in ``fab_tpu`` on its (2, 2) mesh,
  and a ``fab_tpu`` checkpoint resumed on 4 split ranks, each to the other's next
  step on replayed noise, 1e-8.
- ``run_many_well`` with ``mesh.n_model=2`` on 2 ranks under a launcher's variables
  for 2 iterations: only rank 0 writes, and its checkpoint resumes in one process to
  the ranks' next step.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from fab_tpu.buffer import PrioritisedBufferState as JaxBufferState
from fab_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fab_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fab_tpu.parallel.mesh import shard_flow_params as jax_shard_flow_params
from fab_tpu.parallel.mesh import use_mesh as jax_use_mesh
from fab_tpu.train import BufferTrainState as JaxBufferTrainState
from fab_tpu_torch.checkpoint import load_checkpoint
from fab_tpu_torch.convert import from_jax_params, to_jax_params
from fab_tpu_torch.experiments.setup_run import setup_trainer
from fab_tpu_torch.targets import ManyWellEnergy
from fab_tpu_torch.utils.training import apply_overrides, load_config
from test_torch_parallel_fab_tpu import (
    REPLAY,
    RUNNERS,
    _check_against_fab_tpu,
    _fab_tpu_setup,
    no_launcher,  # noqa: F401 (fixture)
)
from torch_parity_utils import ais_noise, to_np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_mesh():
    return jax_make_mesh(2, 2, devices=jax.devices("cpu")[:4])


def _split_state(trainer_j, state_j):
    """fab_tpu's state with its flow placed on the active mesh (model-split) and
    Adam's state made from the placed parameters."""
    flow = jax_shard_flow_params(trainer_j.model.flow, state_j.params["flow"])
    return state_j._replace(params=dict(state_j.params, flow=flow),
                            opt_state=trainer_j.optimizer.init(flow))


def _step_noise(trainer_j, key):
    """One step's noise at ``key``, in the port's draw order."""
    key_ais, key_sample = jax.random.split(key)
    noise = ais_noise(key_ais, REPLAY["n_dists"], 1, REPLAY["batch"], REPLAY["dim"],
                      jnp.float64, flow=trainer_j.model.flow)
    noise["gumbel"] = [np.asarray(jax.random.gumbel(key_sample, (512,), jnp.float64))]
    return noise


def _state_from_port_checkpoint(trainer_j, raw):
    """fab_tpu's trainer state from a port checkpoint: parameters and buffer as
    written, its optimizer library's Adam state rebuilt from the moments."""
    flow_params = raw["params"]["flow"]
    fresh = trainer_j.optimizer.init(flow_params)
    n_layers = len(flow_params["layers"])
    moments = [to_jax_params(dict(from_jax_params(getattr(fresh[1][0], name)), **{
        k: torch.as_tensor(v) for k, v in raw["opt_state"][name].items()}), n_layers)
        for name in ("mu", "nu")]
    adam = fresh[1][0]._replace(count=jnp.asarray(raw["opt_state"]["count"]),
                                mu=moments[0], nu=moments[1])
    return JaxBufferTrainState(
        params=raw["params"], opt_state=(fresh[0], (adam,) + tuple(fresh[1][1:])),
        buffer_state=JaxBufferState(**{k: jnp.asarray(v) for k, v in
                                       raw["buffer_state"].items()}),
        step=jnp.asarray(raw["step"], jnp.int32))


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    """fab_tpu's (2, 2) step from a shared state and the port's on 4 ranks (which
    save a checkpoint after it); fab_tpu's checkpoint of the shared state resumed on
    4 ranks; the port's checkpoint resumed in fab_tpu and on 4 ranks at key 6."""
    tmp = tmp_path_factory.mktemp("model_axis_fab_tpu")
    fab_ckpt, port_dir = str(tmp / "fab_tpu_state.pkl"), str(tmp / "port")
    with jax.enable_x64():
        trainer_j, state_j, key, noise, names = _fab_tpu_setup()
        jax_save_checkpoint(fab_ckpt, state_j._asdict())
        step = jax.jit(trainer_j._train_step_fn(REPLAY["batch"]))
        with jax_use_mesh(_jax_mesh()):
            split = _split_state(trainer_j, state_j)
            assert split.params["flow"]["layers"][0]["mlp"][0]["w"].sharding.spec[1] == "model"
            new_j, info_j = to_np(step(split, key))
    params, buffer_j = state_j.params, state_j.buffer_state
    args = dict(REPLAY, noise=noise, transition=dict(params["transition"]), mesh=(2, 2),
                flow={k: v.numpy() for k, v in from_jax_params(params["flow"]).items()},
                buffer=to_np(buffer_j)._asdict(), save=port_dir)
    port_step = workers.run_ranks("replayed_step", 4, args, str(tmp / "step"))
    from_fab = workers.run_ranks("replayed_step", 4,
                                 dict(REPLAY, noise=noise, checkpoint=fab_ckpt, mesh=(2, 2)),
                                 str(tmp / "from_fab_tpu"))

    port_ckpt = f"{port_dir}/iter_1/state.pkl"
    with jax.enable_x64():
        key2 = jax.random.key(6)
        noise2 = _step_noise(trainer_j, key2)
        resumed_j = _state_from_port_checkpoint(trainer_j, load_checkpoint(port_ckpt))
        with jax_use_mesh(_jax_mesh()):
            resumed_j = resumed_j._replace(params=dict(
                resumed_j.params, flow=jax_shard_flow_params(
                    trainer_j.model.flow, resumed_j.params["flow"])))
            next_j, next_info_j = to_np(step(resumed_j, key2))
    from_port = workers.run_ranks("replayed_step", 4,
                                  dict(REPLAY, noise=noise2, checkpoint=port_ckpt, mesh=(2, 2)),
                                  str(tmp / "from_port"))
    return {"names": names, "step": (port_step, new_j, info_j),
            "from_fab_tpu": (from_fab, new_j, info_j),
            "from_port": (from_port, next_j, next_info_j)}


def test_two_by_two_step_equals_fab_tpu_on_a_two_by_two_mesh(two_by_two):
    """One f64 PrioritisedBufferTrainer step: fab_tpu's, jitted over a ("data",
    "model") = (2, 2) mesh of virtual CPU devices with its coupling MLPs split over
    "model", and the port's on 4 gloo ranks (each holding its data rows and its
    shard of w1, b1, w2), from the same parameters and buffer on the same noise.
    Flow, Adam, HMC state, buffer and info agree to 1e-8."""
    _check_against_fab_tpu(*two_by_two["step"], two_by_two["names"])


def test_fab_tpu_checkpoint_resumes_on_a_two_by_two_mesh(two_by_two):
    """fab_tpu's checkpoint (whole arrays, its optimizer library's Adam state) cut to
    the shards of 4 ranks: their next step on replayed noise is fab_tpu's (2, 2)
    step, to 1e-8."""
    _check_against_fab_tpu(*two_by_two["from_fab_tpu"], two_by_two["names"])


def test_two_by_two_checkpoint_resumes_in_fab_tpu(two_by_two):
    """The port's checkpoint written by the (2, 2) ranks (shards gathered into the
    one-process layout) resumed in fab_tpu on its (2, 2) mesh and on 4 port ranks:
    the next steps, at key 6 and on its replayed noise, agree to 1e-8."""
    _check_against_fab_tpu(*two_by_two["from_port"], two_by_two["names"])


# ---------------------------------------------------- run_many_well on (1, 2)


@pytest.fixture(scope="module")
def many_well_on_a_model_mesh(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run_many_well_model")
    out = tmp / "out"
    argv = RUNNERS["run_many_well"] + [
        "mesh.n_model=2", "training.n_iterations=2", "evaluation.n_eval=1",
        "evaluation.n_checkpoints=1", "evaluation.n_plots=0",
        f"evaluation.save_path={out}"]
    ranks = workers.run_ranks("runner", 2, {"runner": "run_many_well", "argv": argv,
                                            "batch": 64, "launcher_env": True},
                              str(tmp / "ranks"), launcher_env=True)
    return ranks, out, argv


def test_run_many_well_on_a_model_mesh(many_well_on_a_model_mesh, no_launcher):  # noqa: F811
    """mesh.n_model=2 on 2 processes: the (1, 2) grid, both ranks step to 2, rank 0
    alone writes and logs; its checkpoint, loaded in one process, takes the ranks'
    next step to 1e-8."""
    ranks, out, argv = many_well_on_a_model_mesh
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[1]["writes"] == [] and ranks[1]["logger_rows"] == 0
    assert any(p.endswith("state.pkl.tmp") for p in ranks[0]["writes"])
    (run_dir,) = out.iterdir()
    ckpt = run_dir / "model_checkpoints" / "iter_2" / "state.pkl"
    cfg = apply_overrides(load_config(argv[1]), argv[4:])
    trainer = setup_trainer(cfg, ManyWellEnergy(dim=cfg.target.dim, device="cpu"),
                            device="cpu")
    state, step = trainer.load_state(str(ckpt))
    assert step == 2
    state, info = trainer.train_step(state, torch.Generator().manual_seed(99), 64)
    expected = workers.summary(trainer, state, info)
    for rank, result in enumerate(ranks):
        workers.check_summary(result["next"], expected, f"rank {rank}",
                              ["loss", "ess_ais", "grad_norm"])
