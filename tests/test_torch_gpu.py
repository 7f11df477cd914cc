"""K1 and K2 against their plain versions on the card, the host C++ energy server
against the torch force field there, and the compiled steps and fill pass (CUDA
graph replays) against their eager twins, bitwise: among them the configurations
that draw or call on the host (the C++ server as host nodes, ManyWell's
rejection-sampled target_forward_kl, the wrappers). Skipped without a CUDA
card: the hand-written kernels have no CPU mode. This file imports no JAX, so it
also runs on a machine that has only PyTorch (``--noconftest``: tests/conftest.py
imports JAX):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""
import contextlib

import numpy as np
import pytest
import torch

from fab_tpu_torch.flows import LargeFusedCoupling, make_realnvp
from fab_tpu_torch.flows.fused import _stack_params
from fab_tpu_torch.ops import coupling_kernel as ck
from fab_tpu_torch.ops import realnvp_kernel as rk

KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "wlin", "lu_ld")
# (dim, layers, nodes per dim, batch): a small ragged batch, the main path, ragged
# batches at the main widths (one row; a part-filled cluster; one row short of and
# one past the main batch), and widths the wrapper zero-pads for TMA (odd d_cond and
# d_trans: many_well_fast's dim 6 and nodes 40, gmm's dim 2).
SHAPES = [(8, 3, 4, 100), (32, 10, 10, 2048), (32, 10, 10, 1), (32, 10, 10, 100),
          (32, 10, 10, 2047), (32, 10, 10, 2049), (6, 10, 40, 100), (2, 3, 10, 100)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _perturbed_flow(dim, layers, nodes, device, fused=True):
    gen = torch.Generator(device=device).manual_seed(0)
    flow = make_realnvp(dim, layers, nodes, fused=fused, generator=gen, device=device)
    with torch.no_grad():
        for p in flow.parameters():  # the coupling's last layer starts at zero
            p.add_(0.005 * torch.randn(p.shape, generator=gen, device=device))
    return flow


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_k1_kernel_matches_plain_version(card, inverse, shape):
    dim, layers, nodes, batch = shape
    flow = _perturbed_flow(dim, layers, nodes, card)
    x = torch.randn(batch, dim, device=card)
    before = rk.fused_realnvp_pass.launches
    with torch.no_grad():
        s = _stack_params(flow, inverse)
        args = [s[k] for k in KEYS]
        y, ld = rk.fused_realnvp_pass(x, *args, inverse)
        y_ref, ld_ref = rk.fused_realnvp_pass_reference(x, *args, inverse)
    torch.cuda.synchronize()
    assert rk.fused_realnvp_pass.launches == before + 1
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    # log_det sums up to 10 layers' f32 terms in another order.
    torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 20, 2048), (64, 10, 2048), (64, 10, 100)],
                         ids=["d32_h640", "d64_h640", "d64_h640_b100"])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_k1_refuses_widths_past_its_limits(card, inverse, shape):
    """Widths the Hopper kernel refused until it split its stages (H = 640: ManyWell-32
    at 20 nodes per dim; D = 64: a 64-dim ManyWell) now run and match the plain
    version; only a shape past shared memory is refused (next test)."""
    dim, nodes, batch = shape
    flow = _perturbed_flow(dim, 10, nodes, card)
    x = torch.randn(batch, dim, device=card)
    before = rk.fused_realnvp_pass.launches
    with torch.no_grad():
        s = _stack_params(flow, inverse)
        args = [s[k] for k in KEYS]
        y, ld = rk.fused_realnvp_pass(x, *args, inverse)
        y_ref, ld_ref = rk.fused_realnvp_pass_reference(x, *args, inverse)
    torch.cuda.synchronize()
    assert rk.fused_realnvp_pass.launches == before + 1
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_k1_takes_a_narrow_conditioner(card, inverse):
    """D = 32 with d_cond = 8: 2 d_trans = 48 columns of W3 in two column groups."""
    gen = torch.Generator(device=card).manual_seed(3)
    L, D, dc, H = 10, 32, 8, 320
    n3 = 2 * (D - dc)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=card)
    args = [normal(L, dc, H) * (2 / dc) ** 0.5, 0.1 * normal(L, H),
            normal(L, H, H) * (2 / H) ** 0.5, 0.1 * normal(L, H),
            normal(L, H, n3) * 0.1 / H ** 0.5, 0.05 * normal(L, n3),
            torch.linalg.qr(normal(L, D, D))[0], 0.1 * normal(L, 1)]
    x = normal(2048, D)
    with torch.no_grad():
        y, ld = rk.fused_realnvp_pass(x, *args, inverse)
        y_ref, ld_ref = rk.fused_realnvp_pass_reference(x, *args, inverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_k1_refuses_a_chain_past_shared_memory(card):
    """H = 2048: the 16 rows' h1 and h2 alone need 263 KB; the wrapper raises before
    any launch."""
    flow = _perturbed_flow(32, 2, 64, card)
    x = torch.randn(64, 32, device=card)
    before = rk.fused_realnvp_pass.launches
    with torch.no_grad():
        s = _stack_params(flow, True)
        with pytest.raises(ValueError, match="shared memory"):
            rk.fused_realnvp_pass(x, *(s[k] for k in KEYS), True)
    assert rk.fused_realnvp_pass.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_k1_is_bitwise_repeatable(card, inverse):
    """The log-det is summed in a fixed order, with no float atomics, and every
    product in a fixed order: two launches give the same bits."""
    flow = _perturbed_flow(32, 10, 10, card)
    x = torch.randn(2048, 32, device=card)
    with torch.no_grad():
        s = _stack_params(flow, inverse)
        args = [s[k] for k in KEYS]
        first = rk.fused_realnvp_pass(x, *args, inverse)
        second = rk.fused_realnvp_pass(x, *args, inverse)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
def test_fused_flow_launches_k1_on_batched_input(card):
    """A [n, B, D] input on the card runs through K1 (one launch per pass), not
    through the plain chain."""
    fused = _perturbed_flow(8, 3, 4, card)
    plain = _perturbed_flow(8, 3, 4, card, fused=False)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(3, 40, 8, device=card)
    before = rk.fused_realnvp_pass.launches
    with torch.no_grad():
        y, ld = fused.inverse_and_log_det(x)
        y_ref, ld_ref = plain.inverse_and_log_det(x)
    torch.cuda.synchronize()
    assert rk.fused_realnvp_pass.launches == before + 1
    assert y.shape == x.shape and ld.shape == x.shape[:-1]
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_k1_gradients_match_plain_flow(card):
    fused = _perturbed_flow(8, 3, 4, card)
    plain = _perturbed_flow(8, 3, 4, card, fused=False)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(100, 8, device=card)
    grads = []
    for flow in (fused, plain):
        xg = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(flow.log_prob(xg).sum(), [xg, *flow.parameters()]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _perturbed_coupling(dim, width, device):
    gen = torch.Generator(device=device).manual_seed(1)
    layer = LargeFusedCoupling(dim, width, scale_cap=5.0, device=device)
    layer.reset_parameters(gen)
    with torch.no_grad():
        for p in layer.parameters():  # the last layer starts at zero
            p.add_(0.01 * torch.randn(p.shape, generator=gen, device=device))
        layer.mlp[-1].w[:, 2 * layer.d_trans:] = 0.0  # the pad stays zero
        layer.mlp[-1].b[2 * layer.d_trans:] = 0.0
    return layer


# (dim, width, batch): ragged rows, a d_trans that is not a multiple of the
# column-pair tile (d_cond = 125: its rows are padded for TMA), an odd dim, one row,
# the LGCP width with a ragged row tile (513 rows), and the narrowest width (128).
K2_SHAPES = [(256, 256, 100), (250, 384, 64), (7, 128, 3), (250, 384, 1),
             (1600, 3200, 513), (256, 128, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K2_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_k2_kernel_matches_plain_version(card, inverse, shape):
    dim, width, batch = shape
    layer = _perturbed_coupling(dim, width, card)
    x = torch.randn(batch, dim, device=card)
    zc, zt = (t.contiguous() for t in layer._split(x))
    args = [zc, zt] + [t for d in layer.mlp for t in (d.w, d.b)]
    before = ck.fused_coupling_apply.launches
    with torch.no_grad():
        y, ld = ck.fused_coupling_apply(*args, 5.0, inverse)
        y_ref, ld_ref = ck.fused_coupling_apply_reference(*args, 5.0, inverse)
    torch.cuda.synchronize()
    assert ck.fused_coupling_apply.launches == before + 1
    # A width-deep f32 product and a d_trans-term sum, in another order.
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_large_fused_coupling_launches_k2_on_batched_input(card):
    """A [n, B, D] input on the card is one K2 launch; values and gradients match
    the plain coupling with the same parameters."""
    layer = _perturbed_coupling(256, 256, card)
    x = torch.randn(3, 40, 256, device=card, requires_grad=True)
    before = ck.fused_coupling_apply.launches
    y, ld = layer.inverse_and_log_det(x)
    assert ck.fused_coupling_apply.launches == before + 1
    grads = torch.autograd.grad((y**2).sum() + ld.sum(), [x, *layer.parameters()])
    y_ref, ld_ref = super(LargeFusedCoupling, layer).inverse_and_log_det(x)
    grads_ref = torch.autograd.grad(
        (y_ref**2).sum() + ld_ref.sum(), [x, *layer.parameters()]
    )
    torch.cuda.synchronize()
    assert y.shape == x.shape and ld.shape == (3, 40)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)
    for a, b in zip(grads, grads_ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _k2_args(layer, x):
    zc, zt = (t.contiguous() for t in layer._split(x))
    return [zc, zt] + [t for d in layer.mlp for t in (d.w, d.b)]


@pytest.mark.gpu
def test_k2_follows_in_place_weight_updates(card):
    """The kernel multiplies prepared copies of the weights, built at the first call
    and rebuilt after each in-place update of every weight; the kernel matches the
    plain version on the new weights each time (the stale-copy guard)."""
    layer = _perturbed_coupling(256, 384, card)
    args = _k2_args(layer, torch.randn(100, 256, device=card))
    gen = torch.Generator(device=card).manual_seed(2)
    with torch.no_grad():
        for _ in range(3):
            rebuilds = ck.prepared_weight.rebuilds
            y, ld = ck.fused_coupling_apply(*args, 5.0, True)
            y_ref, ld_ref = ck.fused_coupling_apply_reference(*args, 5.0, True)
            torch.cuda.synchronize()
            assert ck.prepared_weight.rebuilds == rebuilds + 3
            torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)
            for p in layer.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen, device=card))
            layer.mlp[-1].w[:, 2 * layer.d_trans:] = 0.0


@pytest.mark.gpu
def test_k2_log_det_is_bitwise_repeatable(card):
    """The log-det is summed in a fixed order, with no float atomics."""
    layer = _perturbed_coupling(1600, 3200, card)
    args = _k2_args(layer, torch.randn(512, 1600, device=card))
    with torch.no_grad():
        first = ck.fused_coupling_apply(*args, 5.0, True)
        second = ck.fused_coupling_apply(*args, 5.0, True)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[0], second[0])


@pytest.mark.gpu
def test_host_energy_server_matches_the_torch_force_field_on_the_card(card):
    """The C++ server (built with g++ on the card's host) against the torch force
    field on the card, implicit solvent, float64: energies rtol 1e-9, forces rtol
    1e-6 / atol 1e-8; the energy comes back on the card in the input's dtype."""
    import pathlib

    from fab_tpu_torch.native import AldpEnergyServer
    from fab_tpu_torch.targets.aldp_ff import build_tables, energy_kcal, gb_energy_kcal

    golden = pathlib.Path(__file__).parent / "data" / "aldp_openmm_min_energy_nm.npy"
    gen = torch.Generator(device=card).manual_seed(0)
    ref = torch.tensor(np.load(golden).reshape(1, 22, 3) * 10.0, device=card)
    pos = (ref + 0.05 * torch.randn((256, 22, 3), generator=gen, device=card,
                                    dtype=torch.float64)).requires_grad_(True)
    tables = build_tables()
    e_ref = energy_kcal(tables, pos) + gb_energy_kcal(tables, pos)
    (g_ref,) = torch.autograd.grad(e_ref.sum(), pos)
    server = AldpEnergyServer(tables, n_threads=4, gb=True)
    e = server.energy(pos)
    (g,) = torch.autograd.grad(e.sum(), pos)
    assert e.device.type == "cuda" and e.dtype == torch.float64
    torch.testing.assert_close(e, e_ref.detach(), rtol=1e-9, atol=0)
    torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-8)


def _graph_trainer(kind, device):
    """A small trainer on the card: GMM-shaped Trainer / BufferTrainer (Metropolis
    AIS, f64) or a ManyWell PrioritisedBufferTrainer with the fused flow (K1, f32)."""
    from fab_tpu_torch.buffer import PrioritisedReplayBuffer, ReplayBuffer
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo, Metropolis
    from fab_tpu_torch.targets import GMM, ManyWellEnergy
    from fab_tpu_torch.train import (BufferTrainer, PrioritisedBufferTrainer, Trainer,
                                     make_optimizer)

    gen = torch.Generator(device=device).manual_seed(0)
    if kind == "prioritised_fused":
        flow = make_realnvp(8, 4, 8, fused=True, generator=gen, device=device)
        hmc = HamiltonianMonteCarlo(n_ais_intermediate_distributions=2, n_outer=1,
                                    n_leapfrog=2, epsilon=1.0)
        model = FABModel.create(flow, ManyWellEnergy(8, device=device), hmc, 2)
        return PrioritisedBufferTrainer(
            model, make_optimizer(3e-4, 100.0),
            PrioritisedReplayBuffer(dim=8, max_length=1024, min_sample_length=256),
            n_batches_buffer_sampling=2, w_adjust_max_clip=10.0, device=device)
    f64 = torch.float64
    flow = make_realnvp(2, 3, 8, generator=gen, dtype=f64, device=device)
    target = GMM(n_mixes=8, loc_scaling=5.0, dtype=f64, device=device,
                 true_expectation_estimation_n_samples=1000)
    mh = Metropolis(n_ais_intermediate_distributions=1, n_updates=2, max_step_size=3.0,
                    min_step_size=1.0)
    model = FABModel.create(flow, target, mh, 1)
    if kind == "trainer":
        return Trainer(model, make_optimizer(1e-2, 100.0), dtype=f64, device=device)
    return BufferTrainer(model, make_optimizer(1e-2, 100.0), ReplayBuffer(2, 512, 128, 1.0),
                         clip_ais_weights_frac=0.1, dtype=f64, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["trainer", "buffer", "prioritised_fused"])
def test_compiled_step_replays_a_cuda_graph_equal_to_eager(card, kind):
    """make_train_step on the card captures a CUDA graph; 3 replays against 3 eager
    steps from one state and seed (parameters and every state tensor bitwise; K1's
    launches counted once, at capture), then make_scanned_train_step(b, 2) against
    2 single replays."""
    from torch.utils import _pytree as pytree

    from fab_tpu_torch import graph

    leaves = lambda s: pytree.tree_leaves(tuple(s)[:-1])
    trainers = [_graph_trainer(kind, card) for _ in range(2)]
    kw = {} if kind == "trainer" else {"batch_size": 128}
    states = [t.init_state(torch.Generator(device=card).manual_seed(1), **kw)
              for t in trainers]
    gens = [torch.Generator(device=card).manual_seed(2) for _ in trainers]
    eager, compiled = trainers
    step = compiled.make_train_step(128)
    for i in range(3):
        states[0], _ = eager.train_step(states[0], gens[0], 128)
        before = graph.counts()
        states[1], info = step(states[1], gens[1])
        torch.cuda.synchronize()
        assert torch.isfinite(info["loss"])
        assert i == 0 or graph.counts() == before  # a replay reaches no wrapper
    program = compiled._program(128)
    assert program.graph is not None and program.replays == 3
    # K1 per step: a flow draw, a gradient pass, 2 x 2 leapfrog passes; 2 replay
    # batches of a probe and a differentiated pass.
    assert program.captured_counts["k1"] == (10 if kind == "prioritised_fused" else 0)
    for a, b in zip(eager.model.flow.parameters(), compiled.model.flow.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(leaves(states[0]), leaves(states[1])):
        assert torch.equal(a, b)
    start = [t.clone() for t in leaves(states[1])]
    params = {k: v.clone() for k, v in compiled.model.flow.state_dict().items()}
    ends = []
    for scanned in (True, False):
        compiled.model.flow.load_state_dict(params)
        state = type(states[1])(*pytree.tree_unflatten(
            [t.clone() for t in start], pytree.tree_flatten(tuple(states[1])[:-1])[1]),
            states[1].step)
        gen = torch.Generator(device=card).manual_seed(3)
        if scanned:
            state, _ = compiled.make_scanned_train_step(128, 2)(state, gen)
        else:
            for _ in range(2):
                state, _ = step(state, gen)
        ends.append([t.clone() for t in leaves(state)]
                    + [p.detach().clone() for p in compiled.model.flow.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*ends))


def _path_trainer(case, device, tmp_path, extra=()):
    """A small trainer of a spline, LARS or SNF path, as its runner builds it (f32):
    aldp.yaml (splines, implicit solvent, the chirality filter, prioritised buffer),
    aldp_rbd.yaml (the LARS base), aldp_snf.yaml (MH layers on the vacuum force
    field) and gmm.yaml with flow.use_snf=true; ``extra`` overrides; and its
    init_state kwargs."""
    import pathlib

    from fab_tpu_torch.buffer import PrioritisedReplayBuffer
    from fab_tpu_torch.experiments import run_aldp, run_gmm
    from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
    from fab_tpu_torch.experiments.setup_run import setup_trainer
    from fab_tpu_torch.train import PrioritisedBufferTrainer
    from fab_tpu_torch.utils.training import apply_overrides, load_config

    root = pathlib.Path(__file__).resolve().parents[1]
    configs = root / "experiments" / "configs"
    if case == "gmm_snf":
        cfg = apply_overrides(load_config(str(configs / "gmm.yaml")), [
            "flow.use_snf=true", "flow.n_layers=3", "training.batch_size=64",
            "target.true_expectation_n_samples=1000", "training.use_buffer=false"])
        return setup_trainer(cfg, run_gmm.make_target(cfg, device), device=device), {}
    frame = tmp_path / "aldp_angstrom.npy"
    np.save(frame, np.load(root / "tests" / "data" / "aldp_openmm_min_energy_nm.npy")
            .reshape(1, 66) * 10.0)
    extra = list(extra) + (["flow.snf.every=1", "flow.snf.steps=2"] if case == "aldp_snf"
                           else [])
    cfg = apply_overrides(load_config(str(configs / f"{case}.yaml")), [
        "flow.blocks=2", "flow.hidden_units=32", "training.batch_size=64", "fab.n_int_dist=2",
        "fab.n_inner=2", "training.replay_buffer.min_length=2",
        "training.replay_buffer.max_length=8", "training.replay_buffer.n_updates=2",
        "training.warmup_iter=2", f"data.transform={frame}", *extra])
    model, target = make_aldp_model(cfg, torch.float32, device)
    t, rb = cfg.training, cfg.training.replay_buffer
    buffer = PrioritisedReplayBuffer(dim=target.dim, max_length=rb.max_length * 64,
                                     min_sample_length=rb.min_length * 64)
    return PrioritisedBufferTrainer(model, run_aldp._optimizer(t), buffer,
                                    n_batches_buffer_sampling=rb.n_updates,
                                    w_adjust_max_clip=rb.get("max_adjust_w_clip"),
                                    device=device), {"batch_size": 64}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["aldp", "aldp_rbd", "aldp_snf", "gmm_snf"])
def test_compiled_paths_replay_a_cuda_graph_equal_to_eager(card, case, tmp_path):
    """The spline, LARS and SNF paths' compiled steps on the card: 2 graph replays
    against 2 eager steps from one state and seed, parameters, buffers and every
    state tensor bitwise."""
    from torch.utils import _pytree as pytree

    leaves = lambda s: pytree.tree_leaves(tuple(s)[:-1])
    (eager, kw), (compiled, _) = (_path_trainer(case, card, tmp_path) for _ in range(2))
    states = [t.init_state(torch.Generator(device=card).manual_seed(1), **kw)
              for t in (eager, compiled)]
    gens = [torch.Generator(device=card).manual_seed(2) for _ in range(2)]
    step = compiled.make_train_step(64)
    for _ in range(2):
        states[0], _ = eager.train_step(states[0], gens[0], 64)
        states[1], info = step(states[1], gens[1])
    torch.cuda.synchronize()
    assert torch.isfinite(info["loss"])
    program = compiled._program(64)
    assert program.graph is not None and program.replays == 2
    named = lambda t: [*t.model.flow.parameters(), *t.model.flow.buffers()]
    for a, b in zip(named(eager), named(compiled)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(states[0]), leaves(states[1])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_compiled_fill_replays_a_cuda_graph_equal_to_eager(card, monkeypatch, tmp_path):
    """aldp.yaml's fill (small): each pass a replay of the captured fill pass,
    against the eager fill from one seed, buffer and transition state bitwise; then
    the ManyWell fill through K1, whose launches are in its graph."""
    from fab_tpu_torch import graph

    (compiled, kw), (eager, _) = (_path_trainer("aldp", card, tmp_path) for _ in range(2))
    state_c = compiled.init_state(torch.Generator(device=card).manual_seed(1), **kw)
    assert compiled.fill_program.graph is not None and compiled.fill_program.replays == 2
    with monkeypatch.context() as patch:
        patch.setattr(graph, "graph_supported", lambda t: (False, "eager for the test"))
        state_e = eager.init_state(torch.Generator(device=card).manual_seed(1), **kw)
    assert eager.fill_program is None
    for a, b in zip(state_c.buffer_state, state_e.buffer_state):
        assert torch.equal(a, b)
    for k, v in state_c.transition_state.items():
        assert torch.equal(v, state_e.transition_state[k])
    fused = _graph_trainer("prioritised_fused", card)
    fused.init_state(torch.Generator(device=card).manual_seed(1), batch_size=128)
    # A flow draw and a gradient pass, then 2 x 2 leapfrog gradient passes.
    assert fused.fill_program.captured_counts["k1"] == 6
    assert fused.fill_program.replays == 2


@pytest.mark.gpu
def test_aldp_log_prob_gradient_is_bitwise_repeatable(card, tmp_path):
    """The ALDP target's x-gradient (implicit solvent, 1024 rows near the minimum):
    two calls on one input give the same bits (the force field's and the z-matrix's
    gathers sum their gradient in a fixed order)."""
    trainer, _ = _path_trainer("aldp", card, tmp_path)
    target = trainer.model.target
    z0 = target.transform.cartesian_to_flow(torch.as_tensor(
        target.ref_cartesian, dtype=torch.float32, device=card))[0]
    gen = torch.Generator(device=card).manual_seed(0)
    z = (z0 + 0.05 * torch.randn((1024, 60), generator=gen, device=card)).requires_grad_()
    grads = [torch.autograd.grad(target.log_prob(z).sum(), z)[0] for _ in range(2)]
    assert torch.isfinite(grads[0]).any()
    assert torch.equal(*grads)


def _graph_node_types(cuda_graph) -> dict:
    """{node type: count} of a captured graph (``keep_graph=True``), read through
    libcuda: 0 kernel, 1 memcpy, 3 host."""
    import collections
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(cuda_graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    kind, types = ctypes.c_int(), collections.Counter()
    for node in nodes:
        assert cu.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0
        types[kind.value] += 1
    return types


def _replays_equal(eager, compiled, kw, card, batch, n=2):
    """Both trainers' init_state from one seed, then ``n`` eager steps against ``n``
    replays of the compiled step from one seed: parameters, buffers and every state
    tensor bitwise. Returns the program."""
    from torch.utils import _pytree as pytree

    leaves = lambda s: pytree.tree_leaves(tuple(s)[:-1])
    states = [t.init_state(torch.Generator(device=card).manual_seed(1), **kw)
              for t in (eager, compiled)]
    gens = [torch.Generator(device=card).manual_seed(2) for _ in range(2)]
    step = compiled.make_train_step(batch)
    for _ in range(n):
        states[0], _ = eager.train_step(states[0], gens[0], batch)
        states[1], info = step(states[1], gens[1])
    torch.cuda.synchronize()
    assert torch.isfinite(info["loss"])
    program = compiled._program(batch)
    assert program.graph is not None and program.replays == n
    named = lambda t: [*t.model.flow.parameters(), *t.model.flow.buffers()]
    for a, b in zip(named(eager), named(compiled)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(states[0]), leaves(states[1])):
        assert torch.equal(a, b)
    return program


@pytest.mark.gpu
def test_host_cpp_step_replays_host_nodes_equal_to_eager(card, tmp_path):
    """aldp.yaml on the host C++ server (small): 2 replays against 2 eager steps,
    bitwise; the graph holds one host node per server call, beside at least three
    copies each (the positions out, the energy and force back), and a replay reaches
    no host counter."""
    from fab_tpu_torch.native import AldpEnergyServer

    extra = ["system.backend=host_cpp", "system.n_threads=4"]
    (eager, kw), (compiled, _) = (_path_trainer("aldp", card, tmp_path, extra)
                                  for _ in range(2))
    assert compiled.model.target.backend == "host_cpp"
    program = _replays_equal(eager, compiled, kw, card, 64)
    calls = program.captured_counts["server calls"]
    assert calls == len(program.host_calls.sites) == 1 + 2 * 2  # start + 2 x 2 leapfrog
    types = _graph_node_types(program.graph)
    assert types[3] == calls and types[1] >= 3 * calls, types
    before = AldpEnergyServer.calls
    state = compiled.init_state(torch.Generator(device=card).manual_seed(1), batch_size=64)
    assert compiled.fill_program.graph is not None
    assert _graph_node_types(compiled.fill_program.graph)[3] == calls
    compiled.make_train_step(64)(state, torch.Generator(device=card).manual_seed(3))
    torch.cuda.synchronize()
    # The new fill's build (warm-up and capture) counted, its replays and the step's not.
    assert AldpEnergyServer.calls - before == 2 * calls


@pytest.mark.gpu
def test_forward_kl_many_well_step_replays_equal_to_eager(card):
    """ManyWell-8 target_forward_kl with the fused flow (K1): the exact draws by
    rejection sampling in the noise pass, 3 replays against 3 eager steps bitwise;
    K1's launches per captured step equal an eager step's, and its kernel nodes are
    in the graph."""
    from fab_tpu_torch import graph
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.targets import ManyWellEnergy
    from fab_tpu_torch.train import Trainer, make_optimizer

    def make():
        flow = make_realnvp(8, 4, 8, fused=True, device=card,
                            generator=torch.Generator(device=card).manual_seed(0))
        model = FABModel.create(flow, ManyWellEnergy(8, device=card),
                                loss_type="target_forward_kl", use_ais=False)
        return Trainer(model, make_optimizer(1e-3, 100.0), device=card)

    eager, compiled = make(), make()
    before = graph.counts()["k1"]
    eager.train_step(eager.init_state(torch.Generator(device=card).manual_seed(9)),
                     torch.Generator(device=card).manual_seed(9), 256)
    per_step = graph.counts()["k1"] - before
    program = _replays_equal(eager, compiled, {}, card, 256, n=3)
    assert per_step > 0 and program.captured_counts["k1"] == per_step
    assert [op[0] for op in program.tape.ops] == ["host"]
    assert _graph_node_types(program.graph)[0] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dist_target", "module_flow"])
def test_wrapped_paths_replay_a_cuda_graph_equal_to_eager(card, case):
    """A WrappedTorchDist target (a 40-component mixture in 2-D, validate_args off)
    under a RealNVP, and a WrappedModuleFlow whose module draws through
    fab_tpu_torch.random over GMM-40's target: 2 replays against 2 eager steps,
    bitwise (f64, Metropolis AIS)."""
    from torch import nn

    from fab_tpu_torch import random
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import Metropolis
    from fab_tpu_torch.targets import GMM
    from fab_tpu_torch.train import Trainer, make_optimizer
    from fab_tpu_torch.wrappers import WrappedModuleFlow, WrappedTorchDist

    f64 = torch.float64

    class Gaussian(nn.Module):
        def __init__(self):
            super().__init__()
            self.loc = nn.Parameter(torch.zeros(2, dtype=f64, device=card))
            self.log_scale = nn.Parameter(torch.full((2,), 2.0, dtype=f64, device=card))

        def sample_and_log_prob(self, generator, n):
            eps = random.normal(generator, (n, 2), f64, card)
            x = self.loc + torch.exp(self.log_scale) * eps
            return x, self.log_prob(x)

        def log_prob(self, x):
            z = (x - self.loc) * torch.exp(-self.log_scale)
            return (-0.5 * z**2 - 0.9189385332046727 - self.log_scale).sum(-1)

    def make():
        gmm = GMM(dim=2, n_mixes=40, loc_scaling=40.0, log_var_scaling=1.0, dtype=f64,
                  device=card, true_expectation_estimation_n_samples=1000)
        if case == "module_flow":
            flow, target = WrappedModuleFlow(Gaussian(), 2), gmm
        else:
            dists = torch.distributions
            flow = make_realnvp(2, 3, 8, generator=torch.Generator(device=card).manual_seed(0),
                                dtype=f64, device=card)
            target = WrappedTorchDist.wrap(dists.MixtureSameFamily(
                dists.Categorical(logits=torch.zeros(40, dtype=f64, device=card),
                                  validate_args=False),
                dists.Independent(dists.Normal(gmm.locs, gmm.scales, validate_args=False), 1,
                                  validate_args=False), validate_args=False))
        mh = Metropolis(n_ais_intermediate_distributions=1, n_updates=1, max_step_size=5.0,
                        min_step_size=5.0, adjust_step_size=False, target_p_accept=0.65)
        model = FABModel.create(flow, target, mh, 1, loss_type="fab_alpha_div")
        return Trainer(model, make_optimizer(1e-4, 100.0), dtype=f64, device=card)

    _replays_equal(make(), make(), {}, card, 128)


@pytest.mark.gpu
def test_no_collection_runs_during_a_capture(card):
    """Python's cyclic collector stays off while a program captures: a collection
    there can free an earlier program's CUDA graph, whose destruction is a CUDA call
    that invalidates the capture. The collector is set to run at almost every
    allocation, and a callback records each pass made while the stream captures."""
    import gc

    from fab_tpu_torch import graph

    module = torch.nn.Linear(4, 4, device=card)

    def fn(state, key):
        with torch.no_grad():
            return {"x": torch.tanh(module(state["x"]))}, {}

    during = []

    def seen(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            during.append(info["generation"])

    x = torch.randn(8, 4, device=card)
    thresholds = gc.get_threshold()
    gc.callbacks.append(seen)
    gc.set_threshold(1, 1, 1)
    try:
        program = graph.Program(fn, module, card)
        out, _ = program({"x": x.clone()}, torch.Generator(device=card).manual_seed(0))
    finally:
        gc.callbacks.remove(seen)
        gc.set_threshold(*thresholds)
    assert program.graph is not None and during == []
    with torch.no_grad():
        assert torch.equal(out["x"], torch.tanh(module(x)))


def _noise_from_the_cpu(monkeypatch, seed: int) -> dict:
    """Serve every draw of the port's random module from a CPU generator seeded with
    ``seed``, one per device the draws are for, moved to that device, whatever
    generator the caller holds: runs on two devices then take the same noise. Returns
    device type -> [(kind, shape, dtype)] of its draws, in order."""
    from fab_tpu_torch import random as port_random

    gens, drawn = {}, {}

    def serve(kind, device, shape, make, dtype=None):
        kind_of = torch.device(device).type
        drawn.setdefault(kind_of, []).append((kind, tuple(shape), str(dtype)))
        cpu = gens.setdefault(kind_of, torch.Generator().manual_seed(seed))
        return make(cpu).to(device)

    draws = {
        "normal": lambda g, shape, dtype, device: serve(
            "normal", device, shape, lambda c: torch.randn(tuple(shape), generator=c, dtype=dtype),
            dtype),
        "uniform": lambda g, shape, dtype, device: serve(
            "uniform", device, shape, lambda c: torch.rand(tuple(shape), generator=c, dtype=dtype),
            dtype),
        "exponential": lambda g, shape, dtype, device: serve(
            "exponential", device, shape,
            lambda c: torch.empty(tuple(shape), dtype=dtype).exponential_(generator=c), dtype),
        "randint": lambda g, low, high, shape, device: serve(
            "randint", device, shape, lambda c: torch.randint(low, high, tuple(shape), generator=c)),
    }
    for name, draw in draws.items():
        monkeypatch.setattr(port_random, name, draw)
    return drawn


def _gmm_f64_trainer(device):
    """GMM-40's fab_no_buffer ``Trainer`` at gmm.yaml's widths and settings (RealNVP
    15 x 80-80, Metropolis AIS, lr 1e-4, clip 100), f64, on ``device``."""
    import pathlib

    from fab_tpu_torch.experiments.setup_run import setup_model
    from fab_tpu_torch.targets import GMM
    from fab_tpu_torch.train import Trainer, make_optimizer
    from fab_tpu_torch.utils.training import apply_overrides, load_config

    config = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "configs" / "gmm.yaml"
    cfg = apply_overrides(load_config(str(config)),
                          ["fab.loss_type=fab_alpha_div", "training.use_buffer=false"])
    f64 = torch.float64
    target = GMM(dim=2, n_mixes=40, loc_scaling=40.0, log_var_scaling=1.0, dtype=f64,
                 device=device, true_expectation_estimation_n_samples=1000)
    return Trainer(setup_model(cfg, target, f64, device), make_optimizer(1e-4, 100.0),
                   dtype=f64, device=device)


def _gmm_f64_steps(devices, n_steps: int, batch: int = 128, tol: float = 1e-9) -> dict:
    """GMM-40 at gmm.yaml's widths and settings (RealNVP 15 x 80-80, Metropolis AIS,
    lr 1e-4, clip 100), f64, fab_no_buffer's Trainer, on each of two ``devices`` from
    one initial flow and on the same noise, step by step in lockstep: the flow's
    pieces on one input before any step (max abs apart), then per step the largest
    relative difference of the flow's parameters and both steps' infos, until the
    first step past ``tol``; and each device's draws."""
    f64, trainers = torch.float64, [_gmm_f64_trainer(device) for device in devices]
    cpu = lambda t: {k: v.detach().cpu() for k, v in t.model.flow.state_dict().items()}
    out = {"rel": [], "infos": []}
    with pytest.MonkeyPatch.context() as mp:
        out["drawn"] = _noise_from_the_cpu(mp, seed=0)
        gens = [torch.Generator(device=t.device).manual_seed(0) for t in trainers]
        # init_state draws the flow's parameters from each device's generator: the
        # second flow then takes the first's.
        states = [t.init_state(g) for t, g in zip(trainers, gens)]
        trainers[1].model.flow.load_state_dict(trainers[0].model.flow.state_dict())
        z = torch.randn((batch, 2), generator=torch.Generator().manual_seed(1), dtype=f64)
        with torch.no_grad():
            got = [(t.model.flow.forward_and_log_det(z.to(t.device)),
                    t.model.target.log_prob(30 * z.to(t.device)),
                    t.model.flow.log_prob(30 * z.to(t.device))) for t in trainers]
        apart = lambda a, b: float((a.cpu() - b.cpu()).abs().max())
        ((xa, lda), lpa, lqa), ((xb, ldb), lpb, lqb) = got
        out["pieces"] = {"flow x": apart(xa, xb), "flow log det": apart(lda, ldb),
                         "target log p": apart(lpa, lpb), "flow log q": apart(lqa, lqb)}
        for _ in range(n_steps):
            infos = []
            for i, (t, g) in enumerate(zip(trainers, gens)):
                states[i], info = t.train_step(states[i], g, batch)
                infos.append({k: float(v) for k, v in info.items()
                              if torch.is_tensor(v) and v.numel() == 1})
            a, b = cpu(trainers[0]), cpu(trainers[1])
            out["rel"].append(max(float((b[n] - v).abs().max() / v.abs().max().clamp(min=1e-300))
                                  for n, v in a.items()))
            out["infos"].append(infos)
            if out["rel"][-1] > tol:
                break
    return out


@pytest.mark.gpu
def test_gmm_f64_steps_on_the_card_follow_the_cpus(card):
    """GMM-40's fab_no_buffer steps (gmm.yaml, f64) from one initial flow on the same
    noise, drawn on the CPU and served to both: 30 eager steps on the card stay within
    relative 1e-9 of 30 on the CPU, with the same draws and the same step infos.
    Rounding alone parts two f64 runs by ~5e-14 in 50 steps (``shared_noise_run`` in
    tests/torch_parity_utils.py); an f32 path on the card would part them by ~1e-7 at
    the first step. (The card's compiled step equals its eager one bitwise:
    ``test_compiled_step_replays_a_cuda_graph_equal_to_eager``.)"""
    out = _gmm_f64_steps([torch.device("cpu"), card], 30)
    print("before any step, card against CPU, max abs apart: "
          + ", ".join(f"{k} {v:.3e}" for k, v in out["pieces"].items()))
    for k, (rel, (c, g)) in enumerate(zip(out["rel"], out["infos"])):
        print(f"step {k + 1}: parameters {rel:.3e} relative apart; infos apart: "
              + ", ".join(f"{n} {c[n]:.6g}/{g[n]:.6g}" for n in c
                          if abs(c[n] - g[n]) > 1e-9 * max(abs(c[n]), 1e-30)))
    assert out["drawn"]["cpu"] == out["drawn"]["cuda"], [
        (i, a, b) for i, (a, b) in enumerate(zip(out["drawn"]["cpu"], out["drawn"]["cuda"]))
        if a != b][:5]
    assert len(out["rel"]) == 30 and out["rel"][-1] < 1e-9, out["rel"]


@pytest.mark.gpu
def test_step_keys_on_the_card_draw_independent_noise(card):
    """The keys a run splits off its generator, one per step (``random.split``), on the
    card as on the CPU: 4096 keys in a chain, each drawing a step's base noise (128 x 2
    normals, f64) and its 128 accept uniforms. Per key, the mean and variance of the
    normals sit within 6 standard errors of N(0, 1)'s over the 4096 keys; consecutive
    keys' draws and the normals against the uniforms correlate by less than 6 / sqrt(n);
    no two keys draw the same noise."""
    from fab_tpu_torch import random

    stats = {}
    for device in (torch.device("cpu"), card):
        generator = torch.Generator(device=device).manual_seed(0)
        normals, uniforms = [], []
        for _ in range(4096):
            key = random.split(generator)
            normals.append(random.normal(key, (128, 2), torch.float64, device).flatten())
            uniforms.append(random.uniform(key, (128,), torch.float64, device))
        e = torch.stack(normals).cpu()
        u = torch.stack(uniforms).cpu()
        lag = torch.corrcoef(torch.stack([e[:-1].flatten(), e[1:].flatten()]))[0, 1]
        cross = torch.corrcoef(torch.stack([e[:, :128].flatten(), u.flatten()]))[0, 1]
        stats[device.type] = {
            "mean": float(e.mean()), "var": float(e.var()),
            "key means' spread": float(e.mean(1).std() * 16), "lag-1 corr": float(lag),
            "normal-uniform corr": float(cross), "distinct keys": len({float(r[0]) for r in e}),
            "uniform mean": float(u.mean())}
    print("step keys' noise: " + "; ".join(
        f"{d}: " + ", ".join(f"{k} {v:.4g}" for k, v in s.items()) for d, s in stats.items()))
    n = 4096 * 256
    for s in stats.values():
        assert abs(s["mean"]) < 6 / n ** 0.5 and abs(s["var"] - 1) < 6 * (2 / n) ** 0.5, s
        assert abs(s["key means' spread"] - 1) < 6 / (2 * 4096) ** 0.5, s
        assert abs(s["lag-1 corr"]) < 6 / n ** 0.5, s
        assert abs(s["normal-uniform corr"]) < 6 / (4096 * 128) ** 0.5, s
        assert s["distinct keys"] == 4096 and abs(s["uniform mean"] - 0.5) < 0.01, s


@pytest.mark.gpu
def test_a_served_card_run_draws_the_cpu_runs_noise(card, monkeypatch):
    """``run_gmm_served``'s run on the card: ``init_state`` and 5 compiled steps of
    GMM-40's fab_no_buffer trainer (f64) inside ``served()``, on its CPU generator, take
    exactly the noise of ``init_state`` and 5 eager steps on the CPU from the plain
    run's generator at that seed (``make_generator``): the initial flows (drawn by
    ``mlp_init`` and the LU layers) bitwise equal, then the steps' 15 draws value by
    value, in order; after the steps the flows stay within relative 1e-9 (f64
    rounding alone between the devices)."""
    from fab_tpu_torch import random
    from fab_tpu_torch.experiments import run_gmm_served, setup_run

    cpu, drawn, flows = torch.device("cpu"), {"cpu": [], "cuda": []}, {}
    trainers = {"cpu": _gmm_f64_trainer(cpu), "cuda": _gmm_f64_trainer(card)}
    running = []

    def recording(kind, draw):
        def recorded(generator, *args):
            out = draw(generator, *args)
            drawn[running[-1]].append((kind, out.detach().cpu().clone()))
            return out
        return recorded

    for kind in ("normal", "exponential", "uniform", "randint"):
        monkeypatch.setattr(random, kind, recording(kind, getattr(random, kind)))
    generators = {"cpu": setup_run.make_generator(0, cpu)}
    for name, trainer in trainers.items():
        running.append(name)
        with run_gmm_served.served() if name == "cuda" else contextlib.nullcontext():
            if name == "cuda":
                generators[name] = setup_run.make_generator(0, card)
                assert generators[name].device.type == "cpu"
            state = trainer.init_state(generators[name])
            flows[name] = [{k: v.detach().cpu().clone()
                            for k, v in trainer.model.flow.state_dict().items()}]
            step = (lambda s, g, t=trainer: t.train_step(s, g, 128)) if name == "cpu" else \
                trainer.make_train_step(128)
            for _ in range(5):
                state, _ = step(state, generators[name])
        flows[name].append({k: v.detach().cpu().clone()
                            for k, v in trainer.model.flow.state_dict().items()})
    print(f"draws: CPU {len(drawn['cpu'])}, card served {len(drawn['cuda'])}; kinds "
          f"{sorted({k for k, _ in drawn['cpu']})}")
    assert len(drawn["cpu"]) == len(drawn["cuda"]) == 15  # three a step
    for i, ((ka, a), (kb, b)) in enumerate(zip(drawn["cpu"], drawn["cuda"])):
        assert ka == kb and torch.equal(a, b), (i, ka, kb)
    (start_cpu, end_cpu), (start_card, end_card) = flows["cpu"], flows["cuda"]
    assert all(torch.equal(start_cpu[k], start_card[k]) for k in start_cpu)
    rel = max(float((end_card[k] - v).abs().max() / v.abs().max().clamp(min=1e-300))
              for k, v in end_cpu.items())
    print(f"after 5 steps, card (served) against CPU: parameters {rel:.3e} relative apart")
    assert rel < 1e-9


def _sigma_tail(z: float) -> float:
    """P(|N(0, 1)| > z)."""
    import math

    return math.erfc(z / math.sqrt(2.0))


@pytest.mark.gpu
def test_the_steps_own_draws_on_the_card_look_like_the_cpus(card):
    """The draws of GMM-40's fab_no_buffer step (f64, batch 128) in the order, kinds
    and shapes of its recorded noise tape (the flow's base normals, then Metropolis'
    normals and its accept uniforms, all from the run's generator), for 32,768 steps
    of noise passes, from the card's generator and from the CPU's (served to the card,
    as run_gmm_served does). For each: the shares of normals beyond 4 and 5 sigma and
    of uniforms below 1e-4 and above 1 - 1e-4 within 6 standard errors of their
    expected counts (binomial); correlations at step lags 1-64 (element by element,
    and of the steps' means), and between the draws one step makes one after another,
    within 6 standard errors (1 / sqrt(n)); no two steps draw the same noise, and no
    uniform value repeats more often than 3 times in all."""
    import math

    from fab_tpu_torch import random
    from fab_tpu_torch.experiments import run_gmm_served

    trainer = _gmm_f64_trainer(card)
    state = trainer.init_state(torch.Generator(device=card).manual_seed(0))
    program = trainer._program(128)
    program(state, torch.Generator(device=card).manual_seed(0))
    tape = program.tape
    ops = [op[0] for op in tape.ops]
    print(f"the step's tape: {tape.ops}")
    assert ops == ["normal", "normal", "uniform"] and all(op[1] == 0 for op in tape.ops)
    n_steps, stats = 32_768, {}
    for name, generator in (("card", torch.Generator(device=card).manual_seed(0)),
                            ("cpu", torch.Generator().manual_seed(0))):
        draws = [[] for _ in tape.noise]
        with run_gmm_served.served() if name == "cpu" else contextlib.nullcontext():
            for _ in range(n_steps):
                random.noise_pass(tape, generator)
                for out, t in zip(draws, tape.noise):
                    out.append(t.clone())
        base, move, u = (torch.stack(d).reshape(n_steps, -1).cpu() for d in draws)
        z = torch.cat([base, move], 1)
        s = {}
        for sigma in (4.0, 5.0):
            p, n = _sigma_tail(sigma), z.numel()
            s[f"beyond {sigma:g} sigma"] = (int((z.abs() > sigma).sum()), n * p,
                                            math.sqrt(n * p * (1 - p)))
        for label, mask in (("u < 1e-4", u < 1e-4), ("u > 1 - 1e-4", u > 1 - 1e-4)):
            s[label] = (int(mask.sum()), u.numel() * 1e-4, math.sqrt(u.numel() * 1e-4))
        corr = lambda a, b: float(torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1])
        worst = {}
        for label, x in (("base", base), ("move", move), ("u", u)):
            for lag in range(1, 65):
                worst.setdefault(f"{label} lag", []).append(
                    abs(corr(x[:-lag], x[lag:])) * math.sqrt(x[lag:].numel()))
                m = x.mean(1)
                worst.setdefault(f"{label} mean lag", []).append(
                    abs(corr(m[:-lag], m[lag:])) * math.sqrt(n_steps - lag))
        pairs = (("base-move", base, move), ("move x-u", move[:, 0::2], u),
                 ("move y-u", move[:, 1::2], u), ("base x-u", base[:, 0::2], u))
        for label, a, b in pairs:
            worst[label] = [abs(corr(a, b)) * math.sqrt(a.numel())]
        s.update({k: max(v) for k, v in worst.items()})
        s["distinct steps"] = min(len({tuple(r[:4].tolist()) for r in x}) for x in (base, move, u))
        s["repeated uniforms"] = u.numel() - int(torch.unique(u).numel())
        stats[name] = s
    for name, s in stats.items():
        print(f"{name}: " + "; ".join(
            f"{k} {v[0]} (expected {v[1]:.4g} +- {v[2]:.3g})" if isinstance(v, tuple)
            else f"{k} {v:.4g}" for k, v in s.items()))
    for name, s in stats.items():
        for k, v in s.items():
            if isinstance(v, tuple):
                assert abs(v[0] - v[1]) <= 6 * v[2] + 1, (name, k, v)
            elif k.endswith("lag") or "-" in k:
                assert v < 6, (name, k, v)
        assert s["distinct steps"] == n_steps and s["repeated uniforms"] <= 3, (name, s)
