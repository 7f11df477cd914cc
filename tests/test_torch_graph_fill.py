"""The compiled fill pass and the compiled ALDP ML step (``graph.Program``) against
``fab_tpu``'s jitted ones on the CPU, f64, on shared noise (``NoiseReplay``).

(c) ``init_state`` of a ``BufferTrainer`` (uniform buffer, GMM-shaped, Metropolis
    AIS) and of a ``PrioritisedBufferTrainer`` (ManyWell-4, HMC AIS): every fill pass
    one call of the fill program, the buffer and transition state equal to
    ``fab_tpu``'s ``init_state`` (its jitted ``fill_step``, ``fab_tpu/train.py:441-452``
    and ``:603-620``) to 1e-8, and to the eager fill bit for bit.
(d) ``run_ml_training`` on aldp_ml.yaml at a small size (2 spline blocks of width 16,
    4 bins, batch 16, 3 iterations): the flow after the compiled ML steps equals the
    checkpoint of ``experiments/run_aldp.py``'s ``run_ml_training`` (its jitted
    ``step``, :148-167) to 1e-8, and the eager loop's bit for bit.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.run_aldp as jax_run_aldp
from experiments.make_aldp_model import make_aldp_flow as jax_make_aldp_flow
from fab_tpu.buffer import PrioritisedReplayBuffer as JaxPrioritisedBuffer
from fab_tpu.buffer import ReplayBuffer as JaxReplayBuffer
from fab_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from fab_tpu.flows import make_realnvp as jax_make_realnvp
from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.sampling import HamiltonianMonteCarlo as JaxHMC
from fab_tpu.sampling import Metropolis as JaxMetropolis
from fab_tpu.targets import GMM as JaxGMM
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu.targets.aldp import AldpBoltzmann as JaxAldp
from fab_tpu.train import BufferTrainer as JaxBufferTrainer
from fab_tpu.train import PrioritisedBufferTrainer as JaxPrioritisedTrainer
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu.utils.training import apply_overrides as jax_apply_overrides
from fab_tpu.utils.training import load_config as jax_load_config
from fab_tpu_torch import graph
from fab_tpu_torch.buffer import PrioritisedReplayBuffer, ReplayBuffer
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.experiments import run_aldp
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_flow
from fab_tpu_torch.flows import make_realnvp, splines
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.sampling import HamiltonianMonteCarlo, Metropolis
from fab_tpu_torch.targets import GMM, ManyWellEnergy
from fab_tpu_torch.targets.aldp import AldpBoltzmann
from fab_tpu_torch.train import BufferTrainer, PrioritisedBufferTrainer, make_optimizer
from fab_tpu_torch.utils.training import apply_overrides, load_config
from torch_parity_utils import (
    NoiseReplay,
    ais_noise,
    assert_close,
    metropolis_ais_noise,
    one_torch_thread,  # noqa: F401  (module-scoped fixture)
    perturbed_jax_flow_params,
    to_np,
)

DT = torch.float64
ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "aldp_openmm_min_energy_nm.npy"
F32_PI = float(np.float32(np.pi))
BATCH, N_PASSES = 32, 3

# ------------------------------------------------------------------------- (c)


def _fill_pair(kind):
    """fab_tpu's buffer trainer of ``kind`` and the port's, on one flow; (fab_tpu's
    trainer, the port's trainer, the noise of one fill pass on a key)."""
    dim = 2 if kind == "uniform" else 4
    with jax.enable_x64():
        if kind == "uniform":
            target_j = JaxGMM(n_mixes=8, loc_scaling=5.0, dtype=jnp.float64,
                              true_expectation_estimation_n_samples=1000)
            target = GMM(n_mixes=8, loc_scaling=5.0, dtype=DT, device="cpu",
                         true_expectation_estimation_n_samples=1000)
            mh = dict(n_ais_intermediate_distributions=1, n_updates=2, max_step_size=3.0,
                      min_step_size=1.0)
            op_j, op, n_dists = JaxMetropolis(**mh), Metropolis(**mh), 1
            noise = lambda key: metropolis_ais_noise(key, 1, 2, BATCH, dim, jnp.float64)
        else:
            target_j, target = JaxManyWell(dim), ManyWellEnergy(dim, device="cpu")
            hmc = dict(n_ais_intermediate_distributions=2, n_leapfrog=2, epsilon=0.3)
            op_j, op, n_dists = JaxHMC(**hmc), HamiltonianMonteCarlo(**hmc), 2
            noise = lambda key: ais_noise(key, 2, 1, BATCH, dim, jnp.float64)
        flow_j = jax_make_realnvp(dim, n_flow_layers=2, layer_nodes_per_dim=4, act_norm=False)
        model_j = JaxFABModel.create(flow_j, target_j, op_j, n_dists)
    flow = make_realnvp(dim, 2, 4, dtype=DT, device="cpu")
    model = FABModel.create(flow, target, op, n_dists)
    length, min_length = BATCH * 8, BATCH * N_PASSES
    opt_j, opt = jax_make_optimizer(1e-2, 100.0), make_optimizer(1e-2, 100.0)
    if kind == "uniform":
        trainer_j = JaxBufferTrainer(model_j, opt_j, JaxReplayBuffer(dim, length, min_length, 1.0),
                                     dtype=jnp.float64)
        trainer = BufferTrainer(model, opt, ReplayBuffer(dim, length, min_length, 1.0),
                                dtype=DT, device="cpu")
    else:
        trainer_j = JaxPrioritisedTrainer(
            model_j, opt_j, JaxPrioritisedBuffer(dim=dim, max_length=length,
                                                 min_sample_length=min_length),
            dtype=jnp.float64)
        trainer = PrioritisedBufferTrainer(
            model, opt, PrioritisedReplayBuffer(dim=dim, max_length=length,
                                                min_sample_length=min_length),
            dtype=DT, device="cpu")
    return trainer_j, trainer, noise


@pytest.mark.parametrize("kind", ["uniform", "prioritised"])
def test_compiled_fill_matches_fab_tpu_and_the_eager_fill(kind, monkeypatch, capsys):
    trainer_j, trainer, pass_noise = _fill_pair(kind)
    key = jax.random.key(3)
    with jax.enable_x64():
        # fab_tpu's init_state: model.init on one half of the key, then a fill_step
        # on each key split from the other.
        state_j = to_np(trainer_j.init_state(key, batch_size=BATCH))
        rest, key_init = jax.random.split(key)
        params_j = to_np(trainer_j.model.init(key_init, jnp.float64))
        noises = []
        for _ in range(N_PASSES):
            rest, key_fill = jax.random.split(rest)
            noises.append(pass_noise(key_fill))
    merged = {}
    for noise in noises:
        for name, values in noise.items():
            merged.setdefault(name, []).extend(values)

    def init(self, generator):
        """fab_tpu's initial flow and transition state in place of the port's draw."""
        self.flow.load_state_dict(from_jax_params(params_j["flow"]))
        return {k: torch.tensor(v) for k, v in params_j["transition"].items()}

    monkeypatch.setattr(FABModel, "init", init)
    states = {}
    for mode in ("compiled", "eager"):
        if mode == "eager":
            monkeypatch.setattr(graph, "graph_supported", lambda t: (False, "for the test"))
        replay = NoiseReplay(monkeypatch, merged)
        states[mode] = trainer.init_state(None, batch_size=BATCH)
        replay.assert_consumed()
        if mode == "compiled":
            assert trainer.fill_program.replays == N_PASSES
            assert trainer.fill_program.graph is None
        else:
            assert trainer.fill_program is None
    out = capsys.readouterr().out
    assert "buffer fill: compiled (no CUDA graph on cpu" in out
    assert "buffer fill: eager (for the test)" in out
    compiled, eager = states["compiled"], states["eager"]
    for a, b in zip(compiled.buffer_state, eager.buffer_state):
        assert torch.equal(a, b)
    for name, value in compiled.transition_state.items():
        assert torch.equal(value, eager.transition_state[name])
    assert int(compiled.buffer_state.n_added) == N_PASSES * BATCH
    for name, a, b in zip(compiled.buffer_state._fields, compiled.buffer_state,
                          state_j.buffer_state):
        assert_close(a, b, 1e-8, name)
    for name, value in compiled.transition_state.items():
        assert_close(value, state_j.params["transition"][name], 1e-8, name)
    assert int(compiled.opt_state.count) == 0 and compiled.step == 0


# ------------------------------------------------------------------------- (d)

ML_SMALL = ["flow.blocks=2", "flow.hidden_units=16", "flow.num_bins=4",
            "training.batch_size=16", "training.max_iter=3", "training.warmup_iter=1",
            "training.final_eval_samples=1000", "training.log_every=1"]


class _F64Init:
    """fab_tpu's model with its init giving ``params`` (f64): its
    ``run_ml_training`` initialises the flow in float32 whatever the precision."""

    def __init__(self, model, params):
        self.model, self.flow, self.params = model, model.flow, params

    def init(self, key):
        return {"flow": self.params}

    def forward_kl_loss(self, *args, **kwargs):
        return self.model.forward_kl_loss(*args, **kwargs)


def test_compiled_ml_step_matches_fab_tpus_jitted_step(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(splines, "CIRCULAR_BOUND", F32_PI)  # fab_tpu's float32 pi
    frame = tmp_path / "golden_angstrom.npy"
    np.save(frame, np.load(GOLDEN).reshape(1, 66) * 10.0)
    config = str(ROOT / "experiments" / "configs" / "aldp_ml.yaml")
    target = AldpBoltzmann(data_path=str(frame), dtype=DT, device="cpu")
    circ = target.transform.circular_flow_dims
    rng = np.random.default_rng(0)
    ref = torch.as_tensor(target.ref_cartesian)
    z_train = (target.transform.cartesian_to_flow(ref)[0].numpy()
               + 0.02 * rng.standard_normal((64, 60)))
    kw = dict(n_blocks=2, hidden_units=16, n_bins=4, seed=0)
    with jax.enable_x64():
        target_j = JaxAldp(data_path=str(frame))
        flow_j = jax_make_aldp_flow(60, circ, **kw)
        params = to_np(perturbed_jax_flow_params(flow_j, 1, jnp.float64))
        model_j = JaxFABModel.create(flow_j, target_j, JaxHMC(n_ais_intermediate_distributions=2),
                                     2, loss_type="forward_kl")
        cfg_j = jax_apply_overrides(jax_load_config(config), ML_SMALL + [
            f"training.save_root={tmp_path / 'fab_tpu'}"])
        monkeypatch.setattr(jax_run_aldp, "evaluate_aldp", lambda *a, **k: {})
        key = jax.random.key(7)
        jax_run_aldp.run_ml_training(cfg_j, _F64Init(model_j, params), target_j,
                                     jnp.asarray(z_train), None, key)
        saved = jax_load_checkpoint(str(tmp_path / "fab_tpu" / "model_checkpoints" / "iter_3"
                                        / "state.pkl"))
        idx = []
        for _ in range(3):
            key, sub = jax.random.split(key)
            idx.append(np.asarray(jax.random.randint(sub, (16,), 0, len(z_train))))
    expected = from_jax_params(saved["params"]["flow"])
    assert capsys.readouterr().out.count("ml iter ") == 3  # fab_tpu's log

    def init(self, generator):
        self.flow.load_state_dict(from_jax_params(params))
        return {}

    monkeypatch.setattr(FABModel, "init", init)
    monkeypatch.setattr(run_aldp, "evaluate_aldp", lambda *a, **k: {})
    monkeypatch.setattr(run_aldp, "sample_flow", lambda *a, **k: np.zeros((1, 60)))
    flows = {}
    for mode in ("compiled", "eager"):
        if mode == "eager":
            monkeypatch.setattr(graph, "supported", lambda m, d: (False, "for the test"))
        flow = make_aldp_flow(60, circ, dtype=DT, device="cpu", **kw)
        model = FABModel.create(flow, target, HamiltonianMonteCarlo(
            n_ais_intermediate_distributions=2), 2, loss_type="forward_kl")
        cfg = apply_overrides(load_config(config), ML_SMALL + [
            f"training.save_root={tmp_path / mode}"])
        replay = NoiseReplay(monkeypatch, {"randint": list(idx)})
        run_aldp.run_ml_training(cfg, model, target, torch.as_tensor(z_train), None, None)
        replay.assert_consumed()
        flows[mode] = {k: v.clone() for k, v in flow.state_dict().items()}
    out = capsys.readouterr().out
    assert "ml step: compiled (no CUDA graph on cpu" in out
    assert "ml step: eager (for the test)" in out
    assert out.count("ml iter ") == 6
    for name, value in flows["compiled"].items():
        assert torch.equal(value, flows["eager"][name]), name
        assert_close(value, expected[name], 1e-8, name)
    moved = max(float((flows["compiled"][k] - v).abs().max())
                for k, v in from_jax_params(params).items())
    assert moved > 1e-6  # the steps trained
