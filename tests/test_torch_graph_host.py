"""Compiled programs of the configurations that draw or call on the host
(``fab_tpu_torch/graph.py``, ``random.host_draw``, ``native.HostCalls``), on the CPU,
where a ``Program`` runs its function eagerly through the same static tensors, noise
tape and host-call plan as on the card, without a CUDA graph.

(a) The taped host draw: the noise pass equals the eager draws bit for bit (a
    rejection loop whose number of rounds varies from step to step, among primitive
    draws and a split key); a changed order or result shape raises; a shared-noise
    replacement of ``random.uniform`` reaches the recorded function, and the
    recording run does not consume it.
(b) ManyWell-4 ``target_forward_kl`` (exact draws by rejection sampling): three
    ``make_train_step`` calls equal three eager steps bit for bit (the plain flow in
    f64; the fused flow in f32, with K1's backward recomputes per call equal; and
    the 2-D DoubleWell in f64); one step against ``fab_tpu``'s jitted step on shared
    rejection draws in f64, 1e-8 (its exact sample first, to 1e-12).
(c) The wrappers: a ``WrappedTorchDist`` target's program and a program that samples
    a ``WrappedTorchDist`` (``wrap`` and ``from_callables``) equal their eager twins;
    a ``WrappedModuleFlow`` whose module draws through ``random`` equals its eager
    twin; a module that calls ``torch.randn`` raises ``ValueError`` naming it at
    build, with the flow and the global generator left as they were; a validating
    distribution (its own ``validate_args`` or a component's) keeps the eager step
    on the card (``graph.VALIDATING``) and compiles on the CPU.
(d) ``host_cpp``: ``aldp_energy_host_fn`` through ctypes on a ``HostArgs`` struct
    equals ``energy_and_force`` bit for bit; the plan gives one set of buffers per
    call site in call order, reuses them, and raises on a changed call or a second
    server; aldp.yaml on the host server: the compiled fill and three compiled steps
    equal the eager ones bit for bit, with as many server calls per call; one
    compiled step against ``fab_tpu``'s jitted host_cpp step on shared noise, 1e-8.
"""
import ctypes
import math
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils import _pytree as pytree

from experiments.make_aldp_model import make_aldp_flow as jax_make_aldp_flow
from fab_tpu.model import FABModel as JaxFABModel
from fab_tpu.targets import ManyWellEnergy as JaxManyWell
from fab_tpu.targets.aldp import AldpBoltzmann as JaxAldp
from fab_tpu.train import Trainer as JaxTrainer
from fab_tpu.train import TrainState as JaxTrainState
from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu.utils.aldp_eval import make_chirality_filter_jax
from fab_tpu_torch import graph, native, random
from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.experiments import run_aldp
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_flow, make_aldp_model
from fab_tpu_torch.flows import make_realnvp, splines
from fab_tpu_torch.flows.fused import FusedPass
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.sampling import Metropolis
from fab_tpu_torch.sampling.rejection import rejection_sampling
from fab_tpu_torch.targets import GMM, ManyWellEnergy
from fab_tpu_torch.targets.aldp import AldpBoltzmann
from fab_tpu_torch.targets.aldp_ff import build_tables
from fab_tpu_torch.targets.double_well import DW_Z_DIM1, DoubleWellEnergy
from fab_tpu_torch.train import PrioritisedBufferTrainer, Trainer, TrainState, make_optimizer
from fab_tpu_torch.utils.aldp_eval import chirality_scale_shift, make_chirality_filter
from fab_tpu_torch.utils.training import apply_overrides, load_config
from fab_tpu_torch.wrappers import WrappedModuleFlow, WrappedTorchDist
from torch_parity_utils import (
    NoiseReplay,
    assert_close,
    check_train_step,
    make_flow_pair,
    one_torch_thread,  # noqa: F401  (module-scoped fixture)
    to_np,
)

DT = torch.float64
ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "aldp_openmm_min_energy_nm.npy"
F32_PI = float(np.float32(np.pi))
BATCH = 32
MH_KW = dict(n_ais_intermediate_distributions=1, n_updates=2, max_step_size=3.0,
             min_step_size=1.0)


def _leaves(state):
    return pytree.tree_leaves(tuple(state)[:-1])


def _assert_same(a, state_a, b, state_b, info_a=None, info_b=None):
    named = lambda t: [*t.model.flow.named_parameters(), *t.model.flow.named_buffers()]
    for (name, x), (_, y) in zip(named(a), named(b)):
        assert torch.equal(x, y), name
    assert state_a.step == state_b.step
    for x, y in zip(_leaves(state_a), _leaves(state_b)):
        assert torch.equal(x, y)
    if info_a is not None:
        leaves_a, spec_a = pytree.tree_flatten(info_a)
        leaves_b, spec_b = pytree.tree_flatten(info_b)
        assert spec_a == spec_b
        for x, y in zip(leaves_a, leaves_b):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def _steps_equal(make, n_steps=3, batch=BATCH, init_kw=None, per_call=None):
    """Two trainers from ``make()``, one initial state: ``n_steps`` eager steps
    against ``n_steps`` calls of ``make_train_step``, bit for bit after each, and the
    generators' states after. ``per_call()`` (a counter) moves as much per call as per
    eager step, after the first call (its build runs the step once more)."""
    eager, compiled = make(), make()
    init_kw = init_kw or {}
    state_e = eager.init_state(torch.Generator().manual_seed(1), **init_kw)
    state_c = compiled.init_state(torch.Generator().manual_seed(1), **init_kw)
    _assert_same(eager, state_e, compiled, state_c)
    gen_e, gen_c = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    step = compiled.make_train_step(batch)
    for i in range(n_steps):
        before = per_call() if per_call else None
        state_e, info_e = eager.train_step(state_e, gen_e, batch)
        mid = per_call() if per_call else None
        state_c, info_c = step(state_c, gen_c)
        if per_call and i:
            assert per_call() - mid == mid - before > 0
        _assert_same(eager, state_e, compiled, state_c, info_e, info_c)
    assert torch.equal(gen_e.get_state(), gen_c.get_state())
    program = compiled._program(batch)
    assert program.graph is None and program.replays == n_steps
    return compiled, program


# ------------------------------------------------------------------------- (a)

ROUNDS = []


def _normal_rejection(generator, n):
    """N(0, 1) draws under a 2 N(0, 1) envelope (k 2.5), one proposal of n a round:
    its number of rounds depends on the draws."""

    def proposal(g, m):
        ROUNDS.append(m)
        return 2 * random.normal(g, (m,), DT, "cpu")

    return rejection_sampling(generator, n, proposal,
                              lambda x: -0.5 * (x / 2) ** 2 - math.log(2.0),
                              lambda x: -0.5 * x**2, 2.5, batch_multiplier=1)


def _step_draws(generator):
    """A step's draws: primitives, a rejection loop, a split key, another host draw."""
    out = [random.normal(generator, (3,), DT, "cpu"), _normal_rejection(generator, 40)]
    key = random.split(generator)
    out.append(random.uniform(random.restart(key), (2,), DT, "cpu"))
    out.append(random.host_draw(key, lambda g, n: random.gumbel(g, (n,), DT, "cpu"), 4))
    out.append(random.bernoulli(generator, 0.3, (5,), DT, "cpu"))
    return out


def test_host_draw_noise_pass_equals_eager_draws():
    tape = random.Tape()
    with random.taped(tape) as key:
        _step_draws(key)
    kinds = [op[0] for op in tape.ops]
    assert kinds == ["normal", "host", "split", "restart", "uniform", "host", "uniform"]
    assert tape.ops[1][2] == ((40,), DT, torch.device("cpu"))
    ops = list(tape.ops)
    eager_gen, taped_gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    rounds = []
    for _ in range(6):
        ROUNDS.clear()
        eager = _step_draws(eager_gen)
        rounds.append(len(ROUNDS))
        random.noise_pass(tape, taped_gen)
        with random.taped(tape) as key:
            taped = _step_draws(key)
        assert all(torch.equal(a, b) for a, b in zip(eager, taped))
        assert tape.ops == ops
    assert len(set(rounds)) > 1, rounds  # the loop's length varied, the tape did not
    assert torch.equal(eager_gen.get_state(), taped_gen.get_state())
    assert random.host_draw is random._OWN["host_draw"]  # put back after each block


def test_host_draw_refuses_a_changed_order_or_shape():
    size = {"n": 3}
    draw = lambda g, box: random.normal(g, (box["n"],), DT, "cpu")
    tape = random.Tape()
    with random.taped(tape) as key:
        random.host_draw(key, draw, size)
        random.uniform(key, (2,), DT, "cpu")
    with pytest.raises(RuntimeError, match="draws changed"):
        with random.taped(tape) as key:
            random.uniform(key, (2,), DT, "cpu")
            random.host_draw(key, draw, size)
    with pytest.raises(RuntimeError, match="not from its own generator"):
        with random.taped(tape):
            random.host_draw(torch.Generator(), draw, size)
    size["n"] = 4
    with pytest.raises(RuntimeError, match=r"host draw 0 gave \(\(4,\)"):
        random.noise_pass(tape, torch.Generator().manual_seed(0))


def test_a_replaced_uniform_reaches_the_recorded_host_draw(monkeypatch):
    """Every uniform below any acceptance bound accepts the first proposals: the
    noise pass's result is the replaced normals, in order."""
    calls = {"uniform": 0, "normal": 0}

    def uniform(generator, shape, dtype, device):
        calls["uniform"] += 1
        return torch.full(tuple(shape), 1e-300, dtype=dtype, device=device)

    def normal(generator, shape, dtype, device):
        calls["normal"] += 1
        return torch.arange(math.prod(shape), dtype=dtype, device=device).reshape(shape) / 10

    monkeypatch.setattr(random, "uniform", uniform)
    monkeypatch.setattr(random, "normal", normal)
    tape = random.Tape()
    with random.taped(tape) as key:
        _normal_rejection(key, 30)
    assert calls == {"uniform": 0, "normal": 0}  # the recording drew its own noise
    random.noise_pass(tape, None)
    assert calls == {"uniform": 1, "normal": 1}
    with random.taped(tape) as key:
        out = _normal_rejection(key, 30)
    assert torch.equal(out, 2 * torch.arange(30, dtype=DT) / 10)


# ------------------------------------------------------------------------- (b)


def _forward_kl_trainer(case):
    """target_forward_kl (no AIS) on ManyWell-4 with the plain flow in f64 or the
    fused flow (K1's plain version here) in f32, or on the 2-D DoubleWell in f64."""
    fused, dim = case == "fused_f32", 2 if case == "double_well" else 4
    dtype = torch.float32 if fused else DT
    flow = make_realnvp(dim, 2, 2 if fused else 4, fused=fused, dtype=dtype,
                        generator=torch.Generator().manual_seed(0), device="cpu")
    target = DoubleWellEnergy() if dim == 2 else ManyWellEnergy(4, device="cpu")
    model = FABModel.create(flow, target, loss_type="target_forward_kl", use_ais=False)
    return Trainer(model, make_optimizer(1e-3, 100.0), dtype=dtype, device="cpu")


@pytest.mark.parametrize("case", ["f64", "fused_f32", "double_well"])
def test_forward_kl_program_equals_eager_bitwise(case):
    """ManyWell's exact sample is one host draw; DoubleWell's first dimension is
    (its rejection loop), its second a taped normal."""
    _, program = _steps_equal(lambda: _forward_kl_trainer(case),
                              per_call=(lambda: FusedPass.recomputes)
                              if case == "fused_f32" else None)
    kinds = [op[0] for op in program.tape.ops]
    if case == "double_well":
        assert kinds == ["host", "normal"] and program.tape.ops[0][2][0] == (BATCH,)
    else:
        assert kinds == ["host"] and program.tape.ops[0][2][0] == (BATCH, 4)


def _many_well_rejection_noise(key, n_wells, n):
    """The port's draws of ManyWell's exact sample on ``fab_tpu``'s key: per well,
    each rejection round's Bernoulli uniforms, proposal normals and acceptance
    uniforms until n are accepted, then the second dimension's normals."""
    well = DoubleWellEnergy()
    noise = {"uniform": [], "normal": []}
    for key_well in jax.random.split(key, n_wells):
        key_rounds, key_x2 = jax.random.split(key_well)
        filled = 0
        while filled < n:
            key_rounds, key_prop, key_u = jax.random.split(key_rounds, 3)
            key_c, key_e = jax.random.split(key_prop)
            comp = np.asarray(jax.random.uniform(key_c, (2 * n,), jnp.float64))
            eps = np.asarray(jax.random.normal(key_e, (2 * n,), jnp.float64))
            u = np.asarray(jax.random.uniform(key_u, (2 * n,), jnp.float64))
            noise["uniform"] += [comp, u]
            noise["normal"].append(eps)
            z = torch.tensor(np.where(comp < 0.8, 1.7, -1.7)) + 0.5 * torch.tensor(eps)
            log_target = -(z**4) + 6 * z**2 + 0.5 * z
            filled += int((torch.log(torch.tensor(u)) < log_target - (
                well._proposal_log_prob(z) + math.log(DW_Z_DIM1 * 3))).sum())
        noise["normal"].append(np.asarray(jax.random.normal(key_x2, (n,), jnp.float64)))
    return noise


def test_many_well_forward_kl_step_matches_fab_tpu(monkeypatch):
    dim, key = 4, jax.random.key(7)
    with jax.enable_x64():
        jax_flow, params, flow = make_flow_pair(dim, 2, 4, DT, seed=3)
        target_j = JaxManyWell(dim)
        x_j = np.asarray(target_j.sample(key, BATCH))
        model_j = JaxFABModel.create(jax_flow, target_j, loss_type="target_forward_kl",
                                     use_ais=False)
        trainer_j = JaxTrainer(model_j, jax_make_optimizer(1e-3, 100.0), dtype=jnp.float64)
        state_j = JaxTrainState({"flow": params}, trainer_j.optimizer.init(params),
                                jnp.zeros((), jnp.int32))
        new_j, info_j = to_np(trainer_j.make_train_step(BATCH)(state_j, key))
        noise = _many_well_rejection_noise(key, dim // 2, BATCH)
    target = ManyWellEnergy(dim, device="cpu")
    replay = NoiseReplay(monkeypatch, noise)
    assert_close(target.sample(None, BATCH, DT), x_j, 1e-12, "exact sample")
    replay.assert_consumed()
    model = FABModel.create(flow, target, loss_type="target_forward_kl", use_ais=False)
    trainer = Trainer(model, make_optimizer(1e-3, 100.0), dtype=DT, device="cpu")
    state = TrainState({}, trainer.optimizer.init(trainer.params), 0)
    replay = NoiseReplay(monkeypatch, noise)
    state, info = trainer.make_train_step(BATCH)(state, None)
    replay.assert_consumed()
    assert trainer._program(BATCH).replays == 1
    expected = from_jax_params(new_j.params["flow"])
    for name, value in trainer.model.flow.state_dict().items():
        assert_close(value, expected[name], 1e-8, name)
    for k in ("loss", "grad_norm"):
        assert_close(info[k], info_j[k], 1e-8, k)


# ------------------------------------------------------------------------- (c)


def _mixture(validate=False, component_validates=False):
    g = torch.Generator().manual_seed(0)
    dists = torch.distributions
    comp = dists.Independent(
        dists.Normal(torch.randn(5, 2, generator=g, dtype=DT) * 3,
                     torch.rand(5, 2, generator=g, dtype=DT) + 0.5,
                     validate_args=component_validates), 1, validate_args=False)
    mix = dists.Categorical(logits=torch.randn(5, generator=g, dtype=DT), validate_args=False)
    return dists.MixtureSameFamily(mix, comp, validate_args=validate)


def _gmm():
    return GMM(n_mixes=8, loc_scaling=5.0, dtype=DT, device="cpu",
               true_expectation_estimation_n_samples=1000)


def _fab_trainer(flow, target):
    model = FABModel.create(flow, target, Metropolis(**MH_KW), 1)
    return Trainer(model, make_optimizer(1e-2, 100.0), dtype=DT, device="cpu")


def test_wrapped_dist_target_program_equals_eager_bitwise():
    _steps_equal(lambda: _fab_trainer(
        make_realnvp(2, 2, 4, generator=torch.Generator().manual_seed(0), dtype=DT,
                     device="cpu"),
        WrappedTorchDist.wrap(_mixture())))


@pytest.mark.parametrize("kind", ["wrap", "from_callables"])
def test_a_program_sampling_a_wrapped_dist_equals_eager(kind):
    """The draw is one host op; its seed split moves the caller's generator as the
    eager draw does."""
    if kind == "wrap":
        dist = WrappedTorchDist.wrap(_mixture())
    else:
        dist = WrappedTorchDist.from_callables(
            lambda g, n: 3 * random.normal(g, (n, 2), DT, "cpu"),
            lambda x: -0.5 * (x / 3).pow(2).sum(-1), 2)

    def fn(state, key):
        x = dist.sample(16, key)
        return {"sum": state["sum"] + x.sum(0)}, {"x": x}

    program = graph.Program(fn, nn.Module(), "cpu")
    state_e = state_c = {"sum": torch.zeros(2, dtype=DT)}
    gen_e, gen_c = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
    for _ in range(3):
        state_e, info_e = fn(state_e, gen_e)
        state_c, info_c = program(state_c, gen_c)
        assert torch.equal(info_e["x"], info_c["x"])
        assert torch.equal(state_e["sum"], state_c["sum"])
    assert torch.equal(gen_e.get_state(), gen_c.get_state())
    assert [op[0] for op in program.tape.ops] == ["host"]


class _GaussianModule(nn.Module):
    """A trainable diagonal Gaussian, an external module: its noise from
    ``fab_tpu_torch.random`` (the wrapper's contract) or from torch's global
    generator (``torch.randn``, which breaks it)."""

    def __init__(self, global_draws=False):
        super().__init__()
        self.loc = nn.Parameter(torch.full((2,), 0.5, dtype=DT))
        self.log_scale = nn.Parameter(torch.full((2,), 1.0, dtype=DT))
        self.global_draws = global_draws

    def sample_and_log_prob(self, generator, n):
        shape = (n, 2)
        eps = (torch.randn(shape, dtype=DT) if self.global_draws
               else random.normal(generator, shape, DT, "cpu"))
        x = self.loc + torch.exp(self.log_scale) * eps
        return x, self.log_prob(x)

    def log_prob(self, x):
        z = (x - self.loc) * torch.exp(-self.log_scale)
        return (-0.5 * z**2 - 0.5 * math.log(2 * math.pi) - self.log_scale).sum(-1)


def test_wrapped_module_flow_program_equals_eager_bitwise():
    _steps_equal(lambda: _fab_trainer(WrappedModuleFlow(_GaussianModule(), 2), _gmm()))


def test_a_module_drawing_from_the_global_generator_raises_at_build():
    trainer = _fab_trainer(WrappedModuleFlow(_GaussianModule(global_draws=True), 2), _gmm())
    state = trainer.init_state(torch.Generator().manual_seed(1))
    params = [p.detach().clone() for p in trainer.model.flow.parameters()]
    global_state = torch.default_generator.get_state()
    step = trainer.make_train_step(BATCH)
    for _ in range(2):  # nothing half-built is kept: the next call raises too
        with pytest.raises(ValueError, match="_GaussianModule drew from torch's global generator"):
            step(state, torch.Generator().manual_seed(2))
    assert torch.equal(torch.default_generator.get_state(), global_state)
    assert all(torch.equal(a, b) for a, b in zip(params, trainer.model.flow.parameters()))
    assert trainer._program(BATCH).graph is None


@pytest.mark.parametrize("case", ["validating_card", "component_validates_card",
                                  "not_validating_card", "validating_cpu"])
def test_a_validating_distribution_stays_eager_on_the_card(case):
    dist = _mixture(validate=case == "validating_card" or case == "validating_cpu",
                    component_validates=case == "component_validates_card")
    model = types.SimpleNamespace(flow=make_realnvp(2, 2, 2, device="cpu"),
                                  target=WrappedTorchDist.wrap(dist), loss_type="fab_alpha_div")
    supported, reason = graph.supported(model, "cpu" if case.endswith("cpu") else "cuda")
    if case in ("validating_card", "component_validates_card"):
        assert (supported, reason) == (False, graph.VALIDATING)
    else:
        assert supported and graph.REFUSED.keys() == {"model_axis", "gloo_on_card"}


# ------------------------------------------------------------------------- (d)


def _frames(n, scale, seed):
    rng = np.random.default_rng(seed)
    return np.load(GOLDEN).reshape(1, 22, 3) * 10.0 + scale * rng.standard_normal((n, 22, 3))


@pytest.mark.parametrize("with_force", [True, False])
def test_host_function_equals_energy_and_force_bitwise(with_force):
    server = native.AldpEnergyServer(build_tables(), n_threads=3, gb=True)
    pos = np.ascontiguousarray(_frames(24, 0.05, 0).reshape(24, 66))
    energy = np.empty(24)
    force = np.empty((24, 66)) if with_force else None
    args = native.HostArgs(pos.ctypes.data, energy.ctypes.data,
                           force.ctypes.data if with_force else None, 24)
    server.lib.aldp_energy_host_fn(ctypes.byref(args))
    e, f = server.energy_and_force(pos, with_force=with_force)
    assert np.array_equal(energy, e)
    if with_force:
        assert np.array_equal(force, f.reshape(24, 66))


def test_the_host_call_plan_keeps_one_site_per_call_in_order():
    server = native.AldpEnergyServer(build_tables(), n_threads=2, gb=True)
    pos = [torch.tensor(_frames(n, 0.05, n), dtype=DT, requires_grad=True) for n in (8, 5)]

    def run():
        first = server.energy(pos[0].detach())
        second = server.energy(pos[1])
        (grad,) = torch.autograd.grad(second.sum(), pos[1])
        return first, second, grad

    eager = run()
    plan = native.HostCalls("cpu")
    calls = native.AldpEnergyServer.calls
    for i in range(2):
        with native.host_calls(plan):
            planned = run()
        assert all(torch.equal(a, b) for a, b in zip(eager, planned))
        if i == 0:
            sites = list(plan.sites)
    assert native.AldpEnergyServer.calls - calls == 4
    assert plan.sites == sites and [s.key() for s in sites] == [(server, 8, False),
                                                                 (server, 5, True)]
    assert sites[0].force is None and sites[1].pos.shape == (5, 66)
    assert sites[0].pos.data_ptr() != sites[1].pos.data_ptr()
    assert sites[1].args.pos == sites[1].pos.data_ptr() and sites[1].args.batch == 5
    with pytest.raises(RuntimeError, match="server calls changed: call 0 is \\(batch 5"):
        with native.host_calls(plan):
            server.energy(pos[1])
    with pytest.raises(RuntimeError, match="made 1 server calls, its plan 2"):
        with native.host_calls(plan):
            server.energy(pos[0].detach())
    other = native.AldpEnergyServer(build_tables(), n_threads=2, gb=False)
    with pytest.raises(RuntimeError, match="two energy servers"):
        with native.host_calls(native.HostCalls("cpu")):
            server.energy(pos[0].detach())
            other.energy(pos[0].detach())


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """The golden minimum-energy frame in Angstrom (the runners' data.transform)."""
    path = tmp_path_factory.mktemp("aldp") / "golden_angstrom.npy"
    np.save(path, np.load(GOLDEN).reshape(1, 66) * 10.0)
    return path


def _host_cpp_trainer(frame):
    """aldp.yaml on the host server as run_aldp builds it, at a small size."""
    cfg = apply_overrides(load_config(str(ROOT / "experiments" / "configs" / "aldp.yaml")), [
        "flow.blocks=2", "flow.hidden_units=16", "flow.num_bins=4", "training.batch_size=16",
        "fab.n_int_dist=2", "fab.n_inner=2", "training.max_iter=10", "training.warmup_iter=2",
        "training.replay_buffer.min_length=2", "training.replay_buffer.max_length=8",
        "training.replay_buffer.n_updates=2", "system.backend=host_cpp", "system.n_threads=2",
        f"data.transform={frame}"])
    model, target = make_aldp_model(cfg, DT, "cpu")
    assert target.backend == "host_cpp"
    t, rb = cfg.training, cfg.training.replay_buffer
    return PrioritisedBufferTrainer(
        model, run_aldp._optimizer(t),
        PrioritisedReplayBuffer(dim=target.dim, max_length=rb.max_length * 16,
                                min_sample_length=rb.min_length * 16),
        n_batches_buffer_sampling=rb.n_updates, w_adjust_max_clip=rb.get("max_adjust_w_clip"),
        dtype=DT, device="cpu")


def test_host_cpp_fill_and_steps_equal_eager_bitwise(frame, monkeypatch):
    calls = lambda: native.AldpEnergyServer.calls
    supported, reason = graph.graph_supported(_host_cpp_trainer(frame))
    assert supported, reason
    # The fill: compiled against eager (the static test refused for the twin).
    compiled = _host_cpp_trainer(frame)
    state_c = compiled.init_state(torch.Generator().manual_seed(1), batch_size=16)
    eager = _host_cpp_trainer(frame)
    with monkeypatch.context() as patch:
        patch.setattr(graph, "graph_supported", lambda t: (False, "the eager twin"))
        state_e = eager.init_state(torch.Generator().manual_seed(1), batch_size=16)
    assert eager.fill_program is None and compiled.fill_program.replays == 2
    # 2 distributions x 2 leapfrog steps and the initial point, per AIS pass.
    assert [s.key()[1:] for s in compiled.fill_program.host_calls.sites] == [(16, True)] * 5
    _assert_same(eager, state_e, compiled, state_c)
    # Three steps from the filled state.
    gen_e, gen_c = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    step = compiled.make_train_step(16)
    for i in range(3):
        before = calls()
        state_e, info_e = eager.train_step(state_e, gen_e, 16)
        mid = calls()
        state_c, info_c = step(state_c, gen_c)
        # The first call builds: the warm-up run, then the call's own.
        assert calls() - mid == (1 + (i == 0)) * (mid - before) == (1 + (i == 0)) * 5
        _assert_same(eager, state_e, compiled, state_c, info_e, info_c)
    program = compiled._program(16)
    assert len(program.host_calls.sites) == 5 and program.replays == 3


@pytest.fixture
def global_x64():
    """float64 in JAX's global config for the test, restored after: fab_tpu's
    server runs inside a jitted function as a host callback, on a thread that does
    not see ``jax.enable_x64()``'s context."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


def test_host_cpp_compiled_step_matches_fab_tpu(frame, monkeypatch, global_x64):
    """The prioritised step through ``make_train_step`` on the host_cpp targets (2
    spline blocks, hidden 16, 4 bins; HMC; the chirality filter) against
    ``fab_tpu``'s jitted step on shared parameters and replayed noise, 1e-8."""
    kw = dict(data_path=str(frame), temperature=300.0, env="implicit", energy_cut=-50.0,
              backend="host_cpp", n_threads=2)
    with jax.enable_x64():
        target_j = JaxAldp(**kw)
    target = AldpBoltzmann(**kw, dtype=DT, device="cpu")
    monkeypatch.setattr(splines, "CIRCULAR_BOUND", F32_PI)  # fab_tpu's float32 pi
    circ = target.transform.circular_flow_dims
    flow_kw = dict(n_blocks=2, hidden_units=16, n_bins=4, seed=0)
    jax_flow = jax_make_aldp_flow(60, circ, **flow_kw)
    rng = np.random.default_rng(1)
    with jax.enable_x64():
        params = to_np(jax_flow.init(jax.random.key(0), jnp.float64))
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape), params)
    flow = make_aldp_flow(60, circ, dtype=DT, device="cpu", **flow_kw)
    flow.load_state_dict(from_jax_params(params))
    scale, shift = chirality_scale_shift(target.transform)
    check_train_step(
        monkeypatch, (jax_flow, params, flow), (target_j, target), 60, 64, 2, n_batches=2,
        hmc_kw=dict(n_ais_intermediate_distributions=2, n_outer=1, n_leapfrog=2,
                    epsilon=0.1),
        filters=(make_chirality_filter_jax(scale=scale, shift=shift),
                 make_chirality_filter(scale=scale, shift=shift)),
        compiled="step",
    )
