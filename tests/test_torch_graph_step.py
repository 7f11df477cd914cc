"""The compiled train step (``Trainer.make_train_step``, ``make_scanned_train_step``,
``fab_tpu_torch/graph.py``) on the CPU, where it runs the eager step through the same
static tensors and noise tape as on the card, without a CUDA graph.

(a) ``make_train_step`` equals the eager ``train_step`` bit for bit: a GMM-shaped
    ``Trainer`` and ``BufferTrainer`` (Metropolis AIS, f64) and a small ManyWell
    ``PrioritisedBufferTrainer`` with the fused flow (K1's plain version), 3 steps.
(b) ``make_scanned_train_step(b, 3)`` equals 3 single steps bit for bit, and returns
    the last step's info.
(c) On shared noise (``NoiseReplay``), the compiled and the scanned steps equal
    ``fab_tpu``'s ``jax.jit`` and ``lax.scan`` steps to 1e-8 in f64.
(d) The tape is static (steps keep one tape; a step whose draws change raises), and
    a split key draws through the tape what it draws eagerly.
(e) ``make_train_step`` and one call move the state by exactly one step: the warm-up
    leaks nothing into the flow, the state passed in or the next steps.
(f) ``graph_supported`` gives its reason for each configuration outside the compiled
    path (the model axis, gloo on the card), admits the rest (the spline flows, the
    LARS base, an SNF, a data mesh, the host C++ server, the wrappers,
    rejection-sampled ``target_forward_kl``), and ``run`` of a refused one takes the
    eager step.
(g) ``run(log_every=3)`` writes ``fab_tpu``'s log rows on shared noise.
(h) ``collector_paused``, which holds Python's cyclic collector off during a capture,
    restores the collector as it found it, also when the capture raises.

The same steps replayed as CUDA graphs against eager are card tests in
``test_torch_gpu.py`` (that file imports no JAX, so it runs on the card).
"""
import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils import _pytree as pytree

from fab_tpu.buffer import ReplayBuffer as JaxReplayBuffer
from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.sampling import Metropolis as JaxMetropolis
from fab_tpu.targets import GMM as JaxGMM
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu.train import BufferTrainer as JaxBufferTrainer
from fab_tpu.train import BufferTrainState as JaxBufferTrainState
from fab_tpu.train import Trainer as JaxTrainer
from fab_tpu.train import TrainState as JaxTrainState
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu.utils.logging import ListLogger as JaxListLogger
from fab_tpu_torch import graph, random
from fab_tpu_torch.buffer import PrioritisedReplayBuffer, ReplayBuffer
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.flows import make_realnvp
from fab_tpu_torch.flows.fused import FusedRealNVPFlow
from fab_tpu_torch.flows.resampled import ResampledGaussianBase
from fab_tpu_torch.flows.splines import PeriodicShift
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.sampling import HamiltonianMonteCarlo, Metropolis
from fab_tpu_torch.targets import GMM, ManyWellEnergy
from fab_tpu_torch.train import (
    BufferTrainer,
    BufferTrainState,
    PrioritisedBufferTrainer,
    Trainer,
    TrainState,
    make_optimizer,
)
from fab_tpu_torch.utils.logging import ListLogger
from fab_tpu_torch.wrappers.module import WrappedModuleFlow
from torch_parity_utils import (
    NoiseReplay,
    assert_close,
    check_train_step,
    make_flow_pair,
    metropolis_ais_noise,
    one_torch_thread,  # noqa: F401  (module-scoped fixture)
    to_np,
)

DT = torch.float64
DIM, BATCH, N_DISTS, N_UPDATES = 2, 64, 1, 2
MH_KW = dict(n_ais_intermediate_distributions=N_DISTS, n_updates=N_UPDATES,
             max_step_size=3.0, min_step_size=1.0)
KINDS = ["trainer", "buffer", "prioritised"]


def _gmm():
    return GMM(n_mixes=8, loc_scaling=5.0, dtype=DT, device="cpu",
               true_expectation_estimation_n_samples=1000)


def _trainer(kind):
    """A small trainer of ``kind`` with a fixed initial flow, and its init kwargs."""
    if kind == "prioritised":
        flow = make_realnvp(4, 2, 2, fused=True, generator=torch.Generator().manual_seed(0),
                            device="cpu")
        hmc = HamiltonianMonteCarlo(n_ais_intermediate_distributions=2, n_outer=1,
                                    n_leapfrog=2, epsilon=1.0)
        model = FABModel.create(flow, ManyWellEnergy(4, device="cpu"), hmc, 2)
        return PrioritisedBufferTrainer(
            model, make_optimizer(3e-4, 100.0),
            PrioritisedReplayBuffer(dim=4, max_length=256, min_sample_length=128),
            n_batches_buffer_sampling=2, w_adjust_max_clip=10.0, device="cpu"), {"batch_size": 64}
    flow = make_realnvp(DIM, 3, 8, generator=torch.Generator().manual_seed(0), dtype=DT,
                        device="cpu")
    model = FABModel.create(flow, _gmm(), Metropolis(**MH_KW), N_DISTS)
    if kind == "trainer":
        return Trainer(model, make_optimizer(1e-2, 100.0), dtype=DT, device="cpu"), {}
    return BufferTrainer(model, make_optimizer(1e-2, 100.0),
                         ReplayBuffer(DIM, 512, 128, temperature=1.0),
                         clip_ais_weights_frac=0.1, dtype=DT, device="cpu"), {"batch_size": 64}


def _leaves(state):
    return pytree.tree_leaves(tuple(state)[:-1])


def _assert_same(trainer_a, state_a, trainer_b, state_b, info_a=None, info_b=None):
    for (name, a), b in zip(trainer_a.model.flow.state_dict().items(),
                            trainer_b.model.flow.state_dict().values()):
        assert torch.equal(a, b), name
    assert state_a.step == state_b.step
    for a, b in zip(_leaves(state_a), _leaves(state_b)):
        assert torch.equal(a, b)
    if info_a is not None:
        leaves_a, spec_a = pytree.tree_flatten(info_a)
        leaves_b, spec_b = pytree.tree_flatten(info_b)
        assert spec_a == spec_b
        for a, b in zip(leaves_a, leaves_b):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _pair(kind):
    """Two trainers of ``kind`` from one initial state (a buffer trainer's filled)."""
    (a, kw), (b, _) = _trainer(kind), _trainer(kind)
    state_a = a.init_state(torch.Generator().manual_seed(1), **kw)
    state_b = b.init_state(torch.Generator().manual_seed(1), **kw)
    _assert_same(a, state_a, b, state_b)
    return a, state_a, b, state_b


# ------------------------------------------------------------------ (a), (b), (e)


@pytest.mark.parametrize("kind", KINDS)
def test_compiled_step_equals_eager_bitwise(kind):
    eager, state_e, compiled, state_c = _pair(kind)
    assert isinstance(compiled.model.flow, FusedRealNVPFlow) == (kind == "prioritised")
    gen_e, gen_c = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    step = compiled.make_train_step(BATCH)
    for _ in range(3):
        state_e, info_e = eager.train_step(state_e, gen_e, BATCH)
        state_c, info_c = step(state_c, gen_c)
        _assert_same(eager, state_e, compiled, state_c, info_e, info_c)
    assert torch.equal(gen_e.get_state(), gen_c.get_state())
    program = compiled._program(BATCH)
    assert program.graph is None and program.replays == 3


@pytest.mark.parametrize("kind", KINDS)
def test_scanned_step_equals_single_steps_bitwise(kind):
    single, state_1, scanned, state_s = _pair(kind)
    gen_1, gen_s = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    step = single.make_train_step(BATCH)
    for _ in range(3):
        state_1, info_1 = step(state_1, gen_1)
    state_s, info_s = scanned.make_scanned_train_step(BATCH, 3)(state_s, gen_s)
    _assert_same(single, state_1, scanned, state_s, info_1, info_s)
    assert state_s.step == 3
    # Both share one program per batch size.
    assert scanned._program(BATCH) is scanned._program(BATCH)
    assert scanned.make_train_step(BATCH)(state_s, gen_s)[0].step == 4


@pytest.mark.parametrize("kind", KINDS)
def test_make_train_step_then_one_call_takes_exactly_one_step(kind):
    eager, state_e, compiled, state_c = _pair(kind)
    before = [t.clone() for t in _leaves(state_c)]
    step = compiled.make_train_step(BATCH)
    _assert_same(eager, state_e, compiled, state_c)  # nothing runs before the call
    new_c, _ = step(state_c, torch.Generator().manual_seed(5))
    # The warm-up trained and was undone: one step, the input state untouched.
    new_e, _ = eager.train_step(state_e, torch.Generator().manual_seed(5), BATCH)
    _assert_same(eager, new_e, compiled, new_c)
    for a, b in zip(before, _leaves(state_c)):
        assert torch.equal(a, b)
    program = compiled._program(BATCH)
    assert program.replays == 1 and program.tape.recorded
    # The returned state is the program's: the next step starts from it, no copy (its
    # dicts in the step's own key order, the program's tensors in sorted-key order).
    assert sorted(map(id, _leaves(new_c))) == sorted(map(id, program.static))
    new_e, _ = eager.train_step(new_e, torch.Generator().manual_seed(6), BATCH)
    new_c, _ = step(new_c, torch.Generator().manual_seed(6))
    _assert_same(eager, new_e, compiled, new_c)


def test_a_replaced_parameter_raises():
    trainer, kw = _trainer("trainer")
    state = trainer.init_state(torch.Generator().manual_seed(1), **kw)
    step = trainer.make_train_step(BATCH)
    state, _ = step(state, torch.Generator().manual_seed(2))
    layer = trainer.model.flow.bijectors[0].mlp[0]
    layer.w = nn.Parameter(layer.w.detach().clone())
    with pytest.raises(RuntimeError, match="replaced"):
        step(state, torch.Generator().manual_seed(2))


# ------------------------------------------------------------------------- (c)


def _gmm_pair(kind, seed):
    with jax.enable_x64():
        target_j = JaxGMM(n_mixes=8, loc_scaling=5.0, dtype=jnp.float64,
                          true_expectation_estimation_n_samples=1000)
        jax_flow, params, flow = make_flow_pair(DIM, 3, 8, DT, seed=seed)
        model_j = JaxFABModel.create(jax_flow, target_j, JaxMetropolis(**MH_KW), N_DISTS)
        trans_j = to_np(model_j.ais.transition_operator.init_state(DIM, jnp.float64))
    model = FABModel.create(flow, _gmm(), Metropolis(**MH_KW), N_DISTS)
    transition = {"noise_scalings": torch.tensor(trans_j["noise_scalings"])}
    if kind == "trainer":
        trainer_j = JaxTrainer(model_j, jax_make_optimizer(1e-2, 100.0), dtype=jnp.float64)
        with jax.enable_x64():
            state_j = JaxTrainState({"flow": params, "transition": trans_j},
                                    trainer_j.optimizer.init(params), jnp.zeros((), jnp.int32))
        trainer = Trainer(model, make_optimizer(1e-2, 100.0), dtype=DT, device="cpu")
        state = TrainState(transition, trainer.optimizer.init(trainer.params), 0)
        return trainer_j, state_j, trainer, state
    buf_j, buf = JaxReplayBuffer(DIM, 256, 64, 1.0), ReplayBuffer(DIM, 256, 64, 1.0)
    rng = np.random.default_rng(5)
    with jax.enable_x64():
        buffer_j, buffer = buf_j.init(jnp.float64), buf.init(DT)
        for _ in range(2):
            x, log_w = rng.standard_normal((BATCH, DIM)), rng.standard_normal(BATCH) * 2
            buffer_j = buf_j.add(buffer_j, jnp.asarray(x), jnp.asarray(log_w))
            buffer = buf.add(buffer, torch.tensor(x), torch.tensor(log_w))
        trainer_j = JaxBufferTrainer(model_j, jax_make_optimizer(1e-2, 100.0), buf_j,
                                     n_batches_buffer_sampling=2, clip_ais_weights_frac=0.25,
                                     dtype=jnp.float64)
        state_j = JaxBufferTrainState({"flow": params, "transition": trans_j},
                                      trainer_j.optimizer.init(params), buffer_j,
                                      jnp.zeros((), jnp.int32))
    trainer = BufferTrainer(model, make_optimizer(1e-2, 100.0), buf,
                            n_batches_buffer_sampling=2, clip_ais_weights_frac=0.25,
                            dtype=DT, device="cpu")
    state = BufferTrainState(transition, trainer.optimizer.init(trainer.params), buffer, 0)
    return trainer_j, state_j, trainer, state


def _gmm_step_noise(kind, key):
    """The port's draws of one GMM step of ``kind`` on fab_tpu's key."""
    if kind == "trainer":
        return metropolis_ais_noise(key, N_DISTS, N_UPDATES, BATCH, DIM, jnp.float64)
    key_ais, key_sample = jax.random.split(key)
    noise = metropolis_ais_noise(key_ais, N_DISTS, N_UPDATES, BATCH, DIM, jnp.float64)
    noise["gumbel"] = [np.asarray(jax.random.gumbel(k, (BATCH, 256), jnp.float32))
                       for k in jax.random.split(key_sample, 2)]
    return noise


def _merged(noises):
    merged = {}
    for noise in noises:
        for kind, values in noise.items():
            merged.setdefault(kind, []).extend(values)
    return merged


@pytest.mark.parametrize("mode", ["step", "scanned"])
@pytest.mark.parametrize("kind", ["trainer", "buffer"])
def test_gmm_compiled_steps_match_fab_tpu(kind, mode, monkeypatch):
    """``make_train_step`` (2 calls) or ``make_scanned_train_step(b, 3)`` against
    ``fab_tpu``'s jitted step (2 calls) or its ``lax.scan`` of 3 steps."""
    trainer_j, state_j, trainer, state = _gmm_pair(kind, seed=1)
    key = jax.random.key(2)
    with jax.enable_x64():
        if mode == "step":
            keys = [key, jax.random.fold_in(key, 1)]
            step_j = trainer_j.make_train_step(BATCH)
            for k in keys:
                state_j, info_j = step_j(state_j, k)
        else:
            keys = list(jax.random.split(key, 3))
            state_j, info_j = trainer_j.make_scanned_train_step(BATCH, 3)(state_j, key)
        new_j, info_j = to_np((state_j, info_j))
        noise = _merged(_gmm_step_noise(kind, k) for k in keys)
    replay = NoiseReplay(monkeypatch, noise)
    if mode == "step":
        step = trainer.make_train_step(BATCH)
        for _ in keys:
            state, info = step(state, None)
    else:
        state, info = trainer.make_scanned_train_step(BATCH, 3)(state, None)
    replay.assert_consumed()
    assert state.step == len(keys) == int(new_j.step)
    expected = from_jax_params(new_j.params["flow"])
    for name, value in trainer.model.flow.state_dict().items():
        assert_close(value, expected[name], 1e-8, name)
    adam_j = new_j.opt_state[1][0]
    assert int(state.opt_state.count) == int(adam_j.count)
    names = [n for n, p in trainer.model.flow.named_parameters() if p.requires_grad]
    mu_j, nu_j = from_jax_params(adam_j.mu), from_jax_params(adam_j.nu)
    for name, mu, nu in zip(names, state.opt_state.mu, state.opt_state.nu):
        assert_close(mu, mu_j[name], 1e-8, "mu " + name)
        assert_close(nu, nu_j[name], 1e-8, "nu " + name)
    assert_close(state.transition_state["noise_scalings"],
                 new_j.params["transition"]["noise_scalings"], 1e-12)
    if kind == "buffer":
        for name, a, b in zip(state.buffer_state._fields, state.buffer_state,
                              new_j.buffer_state):
            assert_close(a, b, 1e-8, name)
    for k in ("loss", "grad_norm", "ess_ais", "n_valid"):
        assert_close(info[k], info_j[k], 1e-8, k)


@pytest.mark.parametrize("mode,n_steps", [("step", 2), ("scanned", 3)])
def test_prioritised_compiled_steps_match_fab_tpu(mode, n_steps, monkeypatch):
    """The ManyWell prioritised step of ``check_train_step`` through
    ``make_train_step`` (each step compared) or one ``make_scanned_train_step``."""
    dim, batch, n_dists = 4, 64, 2
    with jax.enable_x64():
        flow_pair = make_flow_pair(dim, 2, 2, DT, seed=2)
        target_j = JaxManyWell(dim)
    check_train_step(
        monkeypatch, flow_pair, (target_j, ManyWellEnergy(dim, device="cpu")), dim, batch,
        n_dists, n_batches=2,
        hmc_kw=dict(n_ais_intermediate_distributions=n_dists, n_leapfrog=3, epsilon=0.3),
        n_steps=n_steps, compiled=mode,
    )


# ------------------------------------------------------------------------- (d)


def _draws(generator):
    """Draws of every kind, and from a split key's two restarts."""
    out = [random.normal(generator, (3,), DT, "cpu")]
    key = random.split(generator)
    out += [random.uniform(random.restart(key), (2,), DT, "cpu") for _ in range(2)]
    out += [random.gumbel(generator, (4,), DT, "cpu"),
            random.categorical(generator, torch.zeros(5, dtype=DT), 3),
            random.randint(generator, 0, 7, (2,), "cpu"),
            random.exponential(generator, (2,), torch.float32, "cpu"),
            random.bernoulli(generator, 0.3, (3,), DT, "cpu")]
    return out


def test_tape_replays_eager_draws_and_split_keys():
    tape = random.Tape()
    with random.taped(tape) as key:
        _draws(key)
    ops = list(tape.ops)
    assert [op[0] for op in ops] == ["normal", "split", "restart", "uniform", "restart",
                                     "uniform", "gumbel", "gumbel", "randint",
                                     "exponential", "uniform"]
    eager_gen, taped_gen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for _ in range(2):
        eager = _draws(eager_gen)
        random.noise_pass(tape, taped_gen)
        with random.taped(tape) as key:
            taped = _draws(key)
        assert all(torch.equal(a, b) for a, b in zip(eager, taped))
        assert torch.equal(taped[1], taped[2])  # one key, the same noise each restart
        assert tape.ops == ops
    assert torch.equal(eager_gen.get_state(), taped_gen.get_state())


def test_tape_refuses_a_changed_draw_and_a_foreign_generator():
    tape = random.Tape()
    with random.taped(tape) as key:
        random.normal(key, (3,), DT, "cpu")
    with pytest.raises(RuntimeError, match="draws changed"):
        with random.taped(tape) as key:
            random.normal(key, (4,), DT, "cpu")
    with pytest.raises(RuntimeError, match="made 0 draws"):
        with random.taped(tape):
            pass
    with pytest.raises(RuntimeError, match="not from its own generator"):
        with random.taped(tape):
            random.normal(torch.Generator(), (3,), DT, "cpu")
    # The module's own functions are back after each block.
    assert random.normal(torch.Generator(), (3,), DT, "cpu").shape == (3,)


@pytest.mark.parametrize("kind", KINDS)
def test_consecutive_steps_keep_one_tape(kind):
    trainer, kw = _trainer(kind)
    state = trainer.init_state(torch.Generator().manual_seed(1), **kw)
    step = trainer.make_train_step(BATCH)
    gen = torch.Generator().manual_seed(2)
    state, _ = step(state, gen)
    tape = trainer._program(BATCH).tape
    ops, noise = list(tape.ops), list(tape.noise)
    for _ in range(2):
        state, _ = step(state, gen)
    assert tape.ops == ops and all(a is b for a, b in zip(tape.noise, noise))
    assert {op[0] for op in ops} <= set(random.KINDS) | {"split", "restart"}


# ------------------------------------------------------------------------- (f)


def _stub_trainer(flow=None, target=None, loss_type="fab_alpha_div", device="cpu"):
    flow = flow if flow is not None else make_realnvp(DIM, 2, 2, device="cpu")
    model = types.SimpleNamespace(flow=flow, target=target if target is not None else _gmm(),
                                  loss_type=loss_type)
    return types.SimpleNamespace(model=model, device=torch.device(device))


class _StochasticFlow(nn.Module):
    is_stochastic = True


def _spline_flow():
    return nn.ModuleList([PeriodicShift(DIM, [0], 0.5, device="cpu")])


def _lars_flow():
    return nn.ModuleList([ResampledGaussianBase(DIM, hidden_units=8, T=4, n_z_points=8,
                                                device="cpu")])


def _on_mesh(monkeypatch, n_model, backend):
    """An active (1 or 2) x ``n_model`` mesh whose process group runs ``backend``."""
    monkeypatch.setattr(mesh, "active_mesh", lambda: mesh.Mesh(2 // n_model, 0, n_model))
    monkeypatch.setattr(graph.dist, "get_backend", lambda group=None: backend)


def _refused(reason, monkeypatch):
    if reason == "model_axis":
        _on_mesh(monkeypatch, 2, "gloo")
        return _stub_trainer()
    _on_mesh(monkeypatch, 1, "gloo")
    return _stub_trainer(device="cuda")


@pytest.mark.parametrize("reason", ["model_axis", "gloo_on_card"])
def test_graph_supported_gives_each_refusal_its_reason(reason, monkeypatch):
    trainer = _refused(reason, monkeypatch)
    assert graph.graph_supported(trainer) == (False, graph.REFUSED[reason])
    with pytest.raises(ValueError, match="no compiled step"):
        graph.StepProgram(trainer, BATCH)


@pytest.mark.parametrize("case", ["gmm", "many_well", "forward_kl", "splines", "lars", "snf",
                                  "data_mesh_gloo_cpu", "data_mesh_nccl_card", "host_cpp",
                                  "wrappers", "rejection"])
def test_graph_supported_admits_the_slices_paths(case, monkeypatch):
    """The plain, ManyWell and forward-KL paths, the spline flows, the LARS base, an
    SNF, a data mesh (n_model 1) under gloo on the CPU or NCCL on the card, the host
    C++ server, a wrapped module flow and rejection-sampled ``target_forward_kl`` on
    ManyWell."""
    if case.startswith("data_mesh"):
        card = case.endswith("card")
        _on_mesh(monkeypatch, 1, "nccl" if card else "gloo")
        trainer = _stub_trainer(device="cuda" if card else "cpu")
    else:
        trainer = {
            "gmm": lambda: _stub_trainer(),
            "many_well": lambda: _stub_trainer(target=ManyWellEnergy(4, device="cpu")),
            "forward_kl": lambda: _stub_trainer(loss_type="target_forward_kl"),
            "splines": lambda: _stub_trainer(flow=_spline_flow()),
            "lars": lambda: _stub_trainer(flow=_lars_flow()),
            "snf": lambda: _stub_trainer(flow=_StochasticFlow()),
            "host_cpp": lambda: _stub_trainer(target=types.SimpleNamespace(backend="host_cpp")),
            "wrappers": lambda: _stub_trainer(flow=WrappedModuleFlow(nn.Linear(DIM, DIM), DIM)),
            "rejection": lambda: _stub_trainer(target=ManyWellEnergy(4, device="cpu"),
                                               loss_type="target_forward_kl"),
        }[case]()
    supported, reason = graph.graph_supported(trainer)
    assert supported
    if case == "data_mesh_nccl_card":
        assert reason == ("captured as a CUDA graph on cuda, its nccl collectives over 2 "
                          "data ranks within, replayed")
    else:
        assert "no CUDA graph on cpu" in reason
        assert ("gloo collectives" in reason) == case.startswith("data_mesh")


def test_run_of_a_refused_configuration_takes_the_eager_step(monkeypatch, capsys):
    trainer, _ = _trainer("trainer")
    monkeypatch.setattr(graph, "graph_supported", lambda t: (False, "a stated reason"))
    monkeypatch.setattr(type(trainer), "make_train_step", None)
    monkeypatch.setattr(type(trainer), "make_scanned_train_step", None)
    state = trainer.run(torch.Generator().manual_seed(1), 4, BATCH, save=False, log_every=2)
    assert state.step == 4
    assert "train step: eager (a stated reason)" in capsys.readouterr().out


# ------------------------------------------------------------------------- (g)


def test_run_log_rows_match_fab_tpu(monkeypatch, capsys):
    """5 iterations at log_every=3 (chunks of 3 and 2 steps) from one state, on
    fab_tpu's keys: the same two log rows, to 1e-8."""
    trainer_j, state_j, trainer, state = _gmm_pair("trainer", seed=3)
    trainer_j.logger, trainer.logger = JaxListLogger(), ListLogger()
    key = jax.random.key(4)
    with jax.enable_x64():
        trainer_j.run(key, 5, BATCH, save=False, state=state_j, log_every=3)
        keys, rest = [], key
        for k in (3, 2):
            rest, key_step = jax.random.split(rest)
            keys += list(jax.random.split(key_step, k))
        noise = _merged(_gmm_step_noise("trainer", k) for k in keys)
    replay = NoiseReplay(monkeypatch, noise)
    trainer.run(None, 5, BATCH, save=False, state=state, log_every=3)
    replay.assert_consumed()
    assert "train step: compiled" in capsys.readouterr().out
    rows_j, rows = trainer_j.logger.history, trainer.logger.history
    assert rows["step"] == [3, 5] == [int(v) for v in rows_j["step"]]
    assert set(rows) == set(rows_j)
    for name, values in rows.items():
        assert_close(np.asarray(values, dtype=np.float64),
                     np.asarray(rows_j[name], dtype=np.float64), 1e-8, name)


@pytest.mark.parametrize("enabled", [True, False], ids=["collector_on", "collector_off"])
def test_collector_paused_restores_the_collector(enabled):
    """(h)"""
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with graph.collector_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError, match="a capture that fails"):
            with graph.collector_paused():
                raise RuntimeError("a capture that fails")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()
