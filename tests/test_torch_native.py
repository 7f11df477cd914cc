"""The port's host C++ energy server (``fab_tpu_torch/native``) against fab_tpu's, on
the CPU in float64.

- energies and forces against fab_tpu's C++ server on the same perturbed frames
  (both compile the same source): 1e-12, vacuum and GBSA-OBC2;
- against fab_tpu's JAX force field: energy rtol 1e-9, forces rtol 1e-6 / atol 1e-8
  (``tests/test_aldp.py``'s float64 tolerances);
- the autograd Function: ``gradcheck`` in float64; dtype and shape of the output;
- ``AldpBoltzmann(backend="host_cpp")``: log-prob and x-gradient against fab_tpu's
  ``host_cpp`` target, on a batch with invalid rows and rows above the energy cut,
  1e-8; one float64 ``PrioritisedBufferTrainer`` step against fab_tpu's, 1e-8;
- the process-global parameter set: a server called after another was made
  evaluates its own tables;
- a failed g++ build raises, and the target does not fall back to the torch force
  field.
"""
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.make_aldp_model import make_aldp_flow as jax_make_aldp_flow
from fab_tpu.targets.aldp import AldpBoltzmann as JaxAldp
from fab_tpu.targets.aldp_ff import build_tables as jax_build_tables
from fab_tpu.targets.aldp_ff import energy_kcal as jax_energy_kcal
from fab_tpu.targets.aldp_ff import gb_energy_kcal as jax_gb_energy_kcal
from fab_tpu.utils.aldp_eval import make_chirality_filter_jax
from fab_tpu_torch import native
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_flow
from fab_tpu_torch.flows import splines
from fab_tpu_torch.ops import build as build_lib
from fab_tpu_torch.sampling.point import batched_value_and_grad
from fab_tpu_torch.targets.aldp import AldpBoltzmann
from fab_tpu_torch.targets.aldp_ff import build_tables, energy_kcal, gb_energy_kcal
from fab_tpu_torch.utils.aldp_eval import chirality_scale_shift, make_chirality_filter
from torch_parity_utils import assert_close, check_train_step, to_np

DT = torch.float64
GOLDEN = pathlib.Path(__file__).parent / "data" / "aldp_openmm_min_energy_nm.npy"
F32_PI = float(np.float32(np.pi))
ENV = {"vacuum": False, "gb": True}


def _frames(n, scale, seed):
    rng = np.random.default_rng(seed)
    pos = np.load(GOLDEN).reshape(1, 22, 3) * 10.0
    return pos + scale * rng.standard_normal((n, 22, 3))


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("native") / "golden_angstrom.npy"
    np.save(path, np.load(GOLDEN).reshape(1, 66) * 10.0)
    return path


@pytest.fixture(scope="module")
def host_targets(ref_path):
    """(fab_tpu target, port target), implicit solvent, backend host_cpp, float64;
    an energy cut of -50 kT, near the reduced energies of the perturbed minimum, so
    that rows take both of its branches."""
    kw = dict(data_path=str(ref_path), temperature=300.0, env="implicit", energy_cut=-50.0,
              backend="host_cpp", n_threads=2)
    with jax.enable_x64():
        target_j = JaxAldp(**kw)
    target = AldpBoltzmann(**kw, dtype=DT, device="cpu")
    return target_j, target


@pytest.fixture
def global_x64():
    """float64 in JAX's global config for the test, restored after: fab_tpu's
    server runs inside a jitted function as a host callback, on a thread that does
    not see ``jax.enable_x64()``'s context."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.mark.parametrize("env", ENV)
def test_server_matches_fab_tpu_server(env):
    jax_native = pytest.importorskip("fab_tpu.native")
    server_j = jax_native.AldpEnergyServer(jax_build_tables(), n_threads=2, gb=ENV[env])
    server = native.AldpEnergyServer(build_tables(), n_threads=3, gb=ENV[env])
    pos = _frames(40, 0.05, 0)
    e_j, f_j = server_j.energy_and_force(pos)
    e, f = server.energy_and_force(pos)
    assert e.dtype == np.float64 and f.shape == (40, 22, 3)
    np.testing.assert_allclose(e, e_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(f, f_j, rtol=1e-12, atol=1e-12)
    e_only, none = server.energy_and_force(pos, with_force=False)
    assert none is None
    np.testing.assert_array_equal(e_only, e)


@pytest.mark.parametrize("env", ENV)
def test_server_matches_jax_force_field(env):
    tables_j = jax_build_tables()
    pos = _frames(32, 0.05, 1)

    def potential(p):
        e = jax_energy_kcal(tables_j, p)
        return e + jax_gb_energy_kcal(tables_j, p) if ENV[env] else e

    with jax.enable_x64():
        e_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(potential)))(jnp.asarray(pos))
    e, f = native.AldpEnergyServer(build_tables(), n_threads=2, gb=ENV[env]).energy_and_force(pos)
    np.testing.assert_allclose(e, np.asarray(e_j), rtol=1e-9)
    np.testing.assert_allclose(-f, np.asarray(g_j), rtol=1e-6, atol=1e-8)


def test_energy_function_gradcheck_and_dtypes():
    server = native.AldpEnergyServer(build_tables(), n_threads=2, gb=True)
    pos = torch.tensor(_frames(6, 0.03, 2), dtype=DT).reshape(2, 3, 22, 3)
    pos.requires_grad_(True)
    assert torch.autograd.gradcheck(server.energy, (pos,))
    e = server.energy(pos)
    assert e.shape == (2, 3) and e.dtype == DT
    x = torch.tensor(_frames(4, 0.03, 3), dtype=torch.float32, requires_grad=True)
    e32 = server.energy(x)
    (g,) = torch.autograd.grad(e32.sum(), x)
    e64, f64 = server.energy_and_force(x.detach().double().numpy())
    assert e32.dtype == torch.float32 and g.dtype == torch.float32
    assert_close(e32, e64.astype(np.float32), 0.0, "energy cast to the input's dtype")
    assert_close(g, -f64.astype(np.float32), 0.0, "gradient = -force in the input's dtype")
    with torch.no_grad():
        calls = native.AldpEnergyServer.calls
        server.energy(x)
    assert native.AldpEnergyServer.calls == calls + 1


def test_matches_the_torch_force_field():
    """The two port backends agree: the server against ``energy_kcal`` (+ GB)."""
    tables = build_tables()
    pos = torch.tensor(_frames(16, 0.05, 4), dtype=DT, requires_grad=True)
    e_t = energy_kcal(tables, pos) + gb_energy_kcal(tables, pos)
    (g_t,) = torch.autograd.grad(e_t.sum(), pos)
    e, f = native.AldpEnergyServer(tables, n_threads=2, gb=True).energy_and_force(
        pos.detach().numpy())
    np.testing.assert_allclose(e, e_t.detach().numpy(), rtol=1e-9)
    np.testing.assert_allclose(-f, g_t.numpy(), rtol=1e-6, atol=1e-8)


def test_servers_share_one_parameter_set():
    """Constructing a server installs its tables (a vacuum server turns the GB term
    off); a call through an older server installs its own again first."""
    pos = _frames(8, 0.05, 5)
    gb = native.AldpEnergyServer(build_tables(), n_threads=2, gb=True)
    e_gb, _ = gb.energy_and_force(pos)
    vacuum = native.AldpEnergyServer(build_tables(), n_threads=1, gb=False)
    assert native.AldpEnergyServer._active is vacuum
    e_vac, _ = vacuum.energy_and_force(pos)
    assert np.abs(e_gb - e_vac).min() > 1.0  # the solvation energy
    np.testing.assert_array_equal(gb.energy_and_force(pos)[0], e_gb)
    assert native.AldpEnergyServer._active is gb
    np.testing.assert_array_equal(vacuum.energy_and_force(pos)[0], e_vac)


def test_host_cpp_log_prob_matches_fab_tpu(host_targets, global_x64):
    target_j, target = host_targets
    ref = torch.as_tensor(target.ref_cartesian)
    z_min = target.transform.cartesian_to_flow(ref)[0].numpy()
    rng = np.random.default_rng(6)
    z = z_min + 0.1 * rng.standard_normal((24, 60))
    z[3, 0] = -50.0  # a bond <= 0: invalid row
    z[7, 2] = 40.0  # an angle out of (0, pi): invalid row
    z[11] = z_min + 0.3 * rng.standard_normal(60)  # far above the cut
    with jax.enable_x64():
        lp_j = jax.jit(target_j.log_prob)(jnp.asarray(z))
        g_j = jax.jit(jax.grad(lambda a: target_j.log_prob(a).sum()))(jnp.asarray(z))
    lp, g = batched_value_and_grad(target.log_prob, torch.tensor(z))
    lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    assert np.isneginf(lp_j[[3, 7]]).all() and np.isneginf(lp.numpy()[[3, 7]]).all()
    ok = np.isfinite(lp_j)
    assert ok.sum() == 22 and (np.isfinite(lp.numpy()) == ok).all()
    u = target.reduced_energy(target.transform.flow_to_cartesian(torch.tensor(z[ok]))[0])
    assert (u > -50.0).sum() >= 3 and (u < -50.0).sum() >= 3  # both branches of the cut
    assert_close(lp[ok], lp_j[ok], 1e-8, "log_prob")
    assert np.isfinite(g.numpy()).all()
    assert_close(g[ok], g_j[ok], 1e-8, "x-gradient")


def test_host_cpp_trainer_step_matches_fab_tpu(host_targets, monkeypatch, global_x64):
    """One whole f64 PrioritisedBufferTrainer step on the host_cpp targets (2 spline
    blocks, hidden 16, 4 bins; HMC; the chirality filter) on shared parameters and
    replayed noise: flow parameters, Adam state, buffer and info, 1e-8."""
    target_j, target = host_targets
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
    filters = (make_chirality_filter_jax(scale=scale, shift=shift),
               make_chirality_filter(scale=scale, shift=shift))
    calls = native.AldpEnergyServer.calls
    info, _, _, _ = check_train_step(
        monkeypatch, (jax_flow, params, flow), host_targets, 60, 64, 2, n_batches=2,
        hmc_kw=dict(n_ais_intermediate_distributions=2, n_outer=1, n_leapfrog=2,
                    epsilon=0.1),
        filters=filters,
    )
    # The AIS pass: the initial point and 2 distributions x 2 leapfrog steps.
    assert native.AldpEnergyServer.calls - calls == 1 + 2 * 2
    assert 0.0 < float(info["frac_filter_pass"]) <= 1.0


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch, ref_path):
    broken = tmp_path / "aldp_energy.cpp"
    broken.write_text(native.SRC.read_text().replace("extern \"C\" {", "extern \"C\" {{"))
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(build_lib, "BUILD_DIR", tmp_path / "_build")
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.build()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            AldpBoltzmann(data_path=str(ref_path), backend="host_cpp", dtype=DT,
                          device="cpu")
        assert not list((tmp_path / "_build").glob("*.so"))
    finally:
        native._library.cache_clear()
    monkeypatch.undo()
    lib = native.build()
    assert lib == native.build() and lib.name == (
        f"libaldp_energy_{build_lib.source_digest(native.SRC)}.so")
    energy, _ = native.AldpEnergyServer(build_tables()).energy_and_force(_frames(1, 0.0, 0))
    assert lib.parent == build_lib.BUILD_DIR and math.isfinite(energy[0])
