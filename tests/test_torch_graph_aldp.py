"""Compiled train steps of the ALDP spline flows, the LARS base and SNFs
(``fab_tpu_torch/graph.py``) on the CPU, where a program runs the eager step through
the same static tensors and noise tape as on the card, without a CUDA graph.

For each configuration, from one initial state (a buffer trainer's filled),
``make_train_step`` over 3 steps and ``make_scanned_train_step(b, 3)`` equal 3
eager ``train_step`` calls bit for bit: parameters and buffers of the flow, every
state tensor and the logged info. The configurations, built as their runners build
them (``make_aldp_model``, ``setup_trainer``) at a small size (ALDP's 60-D target,
2 spline blocks of width 16, 4 bins, batch 16, HMC with 2 distributions of 2
leapfrog steps; f64):

- aldp.yaml: the prioritised trainer, implicit solvent, the chirality filter, the
  cosine schedule with warm-up;
- aldp_al2div.yaml and aldp_kld.yaml: the plain ``Trainer`` with
  ``flow_alpha_2_div_unbiased`` and ``flow_reverse_kl``;
- aldp_rbd.yaml: the LARS base (T = 100 rejection rounds, its buffer ``z_points``);
- aldp_snf.yaml: an MH layer of 2 steps of the vacuum force field after each block;
- gmm.yaml with ``flow.use_snf=true`` and with ``flow.resampled_base=true``.

Against ``fab_tpu``'s jitted and scanned steps on shared noise, the same
configurations' parity tests take ``compiled`` (``test_torch_aldp_runner.py``,
``test_torch_resampled_snf.py``).
"""
import pathlib

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.experiments import run_aldp, run_gmm
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
from fab_tpu_torch.experiments.setup_run import setup_trainer
from fab_tpu_torch.flows import ResampledGaussianBase, StochasticFlow
from fab_tpu_torch.flows.splines import SplineCoupling
from fab_tpu_torch.train import PrioritisedBufferTrainer, Trainer
from fab_tpu_torch.utils.training import apply_overrides, load_config
from torch_parity_utils import one_torch_thread  # noqa: F401  (module-scoped fixture)

DT = torch.float64
ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "experiments" / "configs"
GOLDEN = ROOT / "tests" / "data" / "aldp_openmm_min_energy_nm.npy"
BATCH = 16
ALDP_SMALL = ["flow.blocks=2", "flow.hidden_units=16", "flow.num_bins=4",
              f"training.batch_size={BATCH}", "fab.n_int_dist=2", "fab.n_inner=2",
              "training.max_iter=10", "training.warmup_iter=2"]
BUFFER_SMALL = ["training.replay_buffer.min_length=2", "training.replay_buffer.max_length=8",
                "training.replay_buffer.n_updates=2"]
GMM_SMALL = ["flow.n_layers=2", "flow.layer_nodes_per_dim=4", f"training.batch_size={BATCH}",
             "target.true_expectation_n_samples=1000", "training.use_buffer=false"]
CASES = {
    "aldp": ("aldp.yaml", BUFFER_SMALL),
    "aldp_al2div": ("aldp_al2div.yaml", []),
    "aldp_kld": ("aldp_kld.yaml", []),
    "aldp_rbd": ("aldp_rbd.yaml", BUFFER_SMALL),
    "aldp_snf": ("aldp_snf.yaml", BUFFER_SMALL + ["flow.snf.every=1", "flow.snf.steps=2"]),
    "gmm_snf": ("gmm.yaml", ["flow.use_snf=true"]),
    "gmm_lars": ("gmm.yaml", ["flow.resampled_base=true"]),
}


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """The golden minimum-energy frame in Angstrom (the runners' data.transform)."""
    path = tmp_path_factory.mktemp("aldp") / "golden_angstrom.npy"
    np.save(path, np.load(GOLDEN).reshape(1, 66) * 10.0)
    return path


def _trainer(case, frame):
    """The case's trainer as its runner builds it, and its init_state kwargs."""
    config, extra = CASES[case]
    if config == "gmm.yaml":
        cfg = apply_overrides(load_config(str(CONFIGS / config)), GMM_SMALL + extra)
        return setup_trainer(cfg, run_gmm.make_target(cfg, "cpu"), device="cpu"), {}
    cfg = apply_overrides(load_config(str(CONFIGS / config)),
                          ALDP_SMALL + extra + [f"data.transform={frame}"])
    model, target = make_aldp_model(cfg, DT, "cpu")
    t, rb = cfg.training, cfg.training.replay_buffer
    if rb is not None and rb.get("type") == "prioritised":
        buffer = PrioritisedReplayBuffer(dim=target.dim, max_length=rb.max_length * BATCH,
                                         min_sample_length=rb.min_length * BATCH)
        return PrioritisedBufferTrainer(
            model, run_aldp._optimizer(t), buffer, n_batches_buffer_sampling=rb.n_updates,
            w_adjust_max_clip=rb.get("max_adjust_w_clip"), dtype=DT, device="cpu",
        ), {"batch_size": BATCH}
    return Trainer(model, run_aldp._optimizer(t), dtype=DT, device="cpu"), {}


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


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_and_scanned_steps_equal_eager_bitwise(case, frame):
    (eager, kw), (compiled, _), (scanned, _) = (_trainer(case, frame) for _ in range(3))
    flow = compiled.model.flow
    modules = list(flow.modules())
    expect = {"aldp_rbd": ResampledGaussianBase, "gmm_lars": ResampledGaussianBase}
    if case in expect:
        assert any(isinstance(m, expect[case]) for m in modules)
    assert isinstance(flow, StochasticFlow) == case.endswith("snf")
    assert any(isinstance(m, SplineCoupling) for m in modules) == case.startswith("aldp")
    states = [t.init_state(torch.Generator().manual_seed(1), **kw)
              for t in (eager, compiled, scanned)]
    _assert_same(eager, states[0], compiled, states[1])
    _assert_same(eager, states[0], scanned, states[2])
    gens = [torch.Generator().manual_seed(5) for _ in range(3)]
    step = compiled.make_train_step(BATCH)
    for _ in range(3):
        states[0], info_e = eager.train_step(states[0], gens[0], BATCH)
        states[1], info_c = step(states[1], gens[1])
        _assert_same(eager, states[0], compiled, states[1], info_e, info_c)
    states[2], info_s = scanned.make_scanned_train_step(BATCH, 3)(states[2], gens[2])
    _assert_same(eager, states[0], scanned, states[2], info_e, info_s)
    assert all(torch.equal(gens[0].get_state(), g.get_state()) for g in gens[1:])
    # (aldp_al2div's loss is 0 here: every w^2 of a fresh flow's draws underflows.)
    assert torch.isfinite(info_e["loss"])
    program = compiled._program(BATCH)
    assert program.graph is None and program.replays == 3
    assert scanned._program(BATCH).replays == 3


def test_gather_rows_is_index_select_with_a_fixed_order_gradient():
    """``internal_coords.gather_rows`` (the force field's and the z-matrix's gathers of
    atoms several rows take): index_select's values, and its gradient with each
    source row's uses summed in one fixed order (equal across calls; index_select's
    own atomics on the card are not)."""
    from fab_tpu_torch.targets.internal_coords import gather_rows, row_index

    idx = np.array([3, 0, 3, 1, 3, 0])  # row 2 taken by none, row 3 three times
    index = row_index(idx, 4, "cpu")
    assert index[1].tolist() == [[1, 5, 6], [3, 6, 6], [6, 6, 6], [0, 2, 4]]
    p = torch.randn(5, 4, 3, dtype=DT, requires_grad=True)
    weights = torch.randn(5, 6, 3, dtype=DT)
    out = gather_rows(p, index)
    assert torch.equal(out, p.index_select(-2, torch.as_tensor(idx)))
    (grad,) = torch.autograd.grad((out * weights).sum(), p)
    (again,) = torch.autograd.grad((gather_rows(p, index) * weights).sum(), p)
    (plain,) = torch.autograd.grad((p.index_select(-2, torch.as_tensor(idx)) * weights).sum(), p)
    assert torch.equal(grad, again)
    torch.testing.assert_close(grad, plain, rtol=1e-14, atol=1e-14)
    assert torch.equal(grad[:, 2], torch.zeros(5, 3, dtype=DT))
