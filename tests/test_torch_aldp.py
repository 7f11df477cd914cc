"""Parity of the port's ALDP target with fab_tpu's, on the CPU in float64.

Both targets are built once per module from the OpenMM-minimised L-alanine frame
(``tests/data/aldp_openmm_min_energy_nm.npy``, in Angstrom) through ``data_path``;
the port reads fab_tpu's ``ref_cartesian`` from a ``.npy``. Tolerances:

- z-matrix Cartesian <-> internal, both log-dets, round trip: 1e-10;
- ``energy_kcal``, ``born_radii``, ``gb_energy_kcal`` on perturbed frames: relative
  1e-9;
- ``log_prob`` and its x-gradient on a batch with invalid rows (a bond or an angle
  out of range) and rows above ``energy_cut``: equal values (-inf where fab_tpu has
  it) and finite, equal gradients, 1e-8;
- ``phi_psi``: 1e-10; the chirality filters' masks: exact; ``evaluate_aldp``'s
  metrics on the same arrays: 1e-12;
- the two packages' own minimisations (200 steps): 1e-8; a D-form reference is
  reflected to L by both.
"""
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fab_tpu.targets.aldp import AldpBoltzmann as JaxAldp
from fab_tpu.targets.aldp_ff import born_radii as jax_born_radii
from fab_tpu.targets.aldp_ff import build_tables as jax_build_tables
from fab_tpu.targets.aldp_ff import energy_kcal as jax_energy_kcal
from fab_tpu.targets.aldp_ff import gb_energy_kcal as jax_gb_energy_kcal
from fab_tpu.utils import aldp_eval as jax_eval
from fab_tpu_torch.sampling.point import batched_value_and_grad
from fab_tpu_torch.targets.aldp import AldpBoltzmann, ca_signed_volume
from fab_tpu_torch.targets.aldp_ff import born_radii, build_tables, energy_kcal, gb_energy_kcal
from fab_tpu_torch.utils import aldp_eval
from torch_parity_utils import assert_close

DT = torch.float64
GOLDEN = pathlib.Path(__file__).parent / "data" / "aldp_openmm_min_energy_nm.npy"


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    """The golden frame in Angstrom, as a data_path."""
    path = tmp_path_factory.mktemp("aldp") / "golden_angstrom.npy"
    np.save(path, np.load(GOLDEN).reshape(1, 66) * 10.0)
    return path


@pytest.fixture(scope="module")
def targets(ref_path, tmp_path_factory):
    """(fab_tpu target, port target), implicit solvent, float64; the port reads
    fab_tpu's reference configuration."""
    with jax.enable_x64():
        target_j = JaxAldp(data_path=str(ref_path), temperature=300.0, env="implicit")
    shared = tmp_path_factory.mktemp("aldp_shared") / "ref_cartesian.npy"
    np.save(shared, np.asarray(target_j.ref_cartesian, np.float64))
    target = AldpBoltzmann(data_path=str(shared), temperature=300.0, env="implicit",
                           dtype=DT, device="cpu")
    return target_j, target


def _z_min(target_j):
    with jax.enable_x64():
        return np.asarray(jax.jit(target_j.transform.cartesian_to_flow)(
            jnp.asarray(target_j.ref_cartesian))[0])


class _Jitted:
    """fab_tpu's target with phi_psi compiled (eager JAX dispatch is slow)."""

    def __init__(self, target_j):
        self.transform = target_j.transform
        self.phi_psi = jax.jit(target_j.phi_psi)


def _perturbed_cartesian(n, scale, seed):
    rng = np.random.default_rng(seed)
    pos = np.load(GOLDEN).reshape(1, 66) * 10.0
    return pos + scale * rng.standard_normal((n, 66))


def test_transform_statistics_match(targets):
    target_j, target = targets
    np.testing.assert_allclose(target.ref_cartesian, target_j.ref_cartesian, rtol=0, atol=0)
    assert_close(target.transform.mean, target_j.transform.mean, 1e-12, "mean")
    assert_close(target.transform.std, target_j.transform.std, 0.0, "std")
    assert target.transform.circular_dims == target_j.transform.circular_dims


def test_zmatrix_round_trip_and_log_det_match(targets):
    target_j, target = targets
    x = _perturbed_cartesian(16, 0.05, 0)
    zmat_j, zmat = target_j.transform.zmat, target.transform.zmat
    with jax.enable_x64():
        int_j, ld_j = jax.jit(zmat_j.cartesian_to_internal)(jnp.asarray(x))
        back_j, ldb_j = jax.jit(zmat_j.internal_to_cartesian)(int_j)
        zf_j, lzf_j = jax.jit(target_j.transform.cartesian_to_flow)(jnp.asarray(x))
        xf_j, lxf_j = jax.jit(target_j.transform.flow_to_cartesian)(zf_j)
    internal, ld = zmat.cartesian_to_internal(torch.tensor(x))
    back, ldb = zmat.internal_to_cartesian(internal)
    assert_close(internal, int_j, 1e-10, "internal")
    assert_close(ld, ld_j, 1e-10, "log-det cart -> int")
    assert_close(back, back_j, 1e-10, "cartesian")
    assert_close(ldb, ldb_j, 1e-10, "log-det int -> cart")
    assert_close(ld + ldb, np.zeros(16), 1e-10, "log-dets cancel")
    zf, lzf = target.transform.cartesian_to_flow(torch.tensor(x))
    xf, lxf = target.transform.flow_to_cartesian(zf)
    for a, b, what in ((zf, zf_j, "flow"), (lzf, lzf_j, "flow log-det"),
                       (xf, xf_j, "flow -> cartesian"), (lxf, lxf_j, "its log-det")):
        assert_close(a, b, 1e-10, what)
    # The gauge-fixed frame reproduces every internal coordinate.
    again, _ = zmat.cartesian_to_internal(back)
    assert_close(again, int_j, 1e-10, "internal of the rebuilt frame")


def test_force_field_matches(targets):
    x = _perturbed_cartesian(12, 0.08, 1).reshape(12, 22, 3)
    tables_j, tables = jax_build_tables(), build_tables()
    for name in ("bond_idx", "torsion_k", "pair_qq", "gb_radius", "gb_scale"):
        np.testing.assert_array_equal(getattr(tables, name), getattr(tables_j, name))
    with jax.enable_x64():
        xj = jnp.asarray(x)
        expected = [np.asarray(jax.jit(lambda v, f=f: f(tables_j, v))(xj)) for f in
                    (jax_energy_kcal, jax_born_radii, jax_gb_energy_kcal)]
    for f, e, name in zip((energy_kcal, born_radii, gb_energy_kcal), expected,
                          ("energy_kcal", "born_radii", "gb_energy_kcal")):
        got = f(tables, torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, e, rtol=1e-9, atol=0, err_msg=name)


def _hard_batch(target_j, n=24):
    """Flow-space rows near the minimum, plus rows with a bond below 1e-2, an angle
    past pi, a NaN, and strongly distorted rows (energies far above a low cut)."""
    rng = np.random.default_rng(2)
    z = _z_min(target_j) + 0.05 * rng.standard_normal((n, 60))
    mean, std = target_j.transform.mean, target_j.transform.std
    z[0, 5] = (0.005 - mean[5]) / std[5]  # bond 2 of the z-matrix at 0.005 A
    z[1, 30] = (math.pi - mean[30]) / std[30]  # an angle at pi
    z[2, 3] = -1e3  # a negative bond
    z[3, 10] = np.nan
    z[4:10] += 1.5 * rng.standard_normal((6, 60))  # far from the minimum
    return z


@pytest.mark.parametrize("energy_cut", [1e8, 30.0], ids=["config-cut", "low-cut"])
def test_log_prob_and_gradient_match(targets, ref_path, energy_cut):
    target_j, target = targets
    if energy_cut != 1e8:
        with jax.enable_x64():
            target_j = JaxAldp(data_path=str(ref_path), temperature=300.0, env="implicit",
                               energy_cut=energy_cut)
        target = AldpBoltzmann(data_path=str(ref_path), temperature=300.0, env="implicit",
                               energy_cut=energy_cut, dtype=DT, device="cpu")
    z = _hard_batch(target_j)
    with jax.enable_x64():
        zj = jnp.asarray(z)
        lp_j, vjp = jax.vjp(jax.jit(target_j.log_prob), zj)
        (g_j,) = vjp(jnp.ones_like(lp_j))
        lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
        u_j = np.asarray(jax.jit(lambda v: target_j.reduced_energy(
            target_j.transform.flow_to_cartesian(v)[0]))(zj[4:10]))
    lp, g = batched_value_and_grad(target.log_prob, torch.tensor(z))
    assert np.isneginf(lp_j[:4]).all() and np.isfinite(lp_j[4:]).all()
    if energy_cut != 1e8:
        assert (u_j > energy_cut).all()  # the distorted rows take the log branch
    assert_close(lp, lp_j, 1e-8, "log_prob")
    assert np.isfinite(g.numpy()).all() and np.isfinite(g_j).all()
    assert_close(g, g_j, 1e-8, "gradient")
    assert (g[:4] == 0).all()


def test_phi_psi_and_chirality_filters_match(targets):
    target_j, target = targets
    rng = np.random.default_rng(3)
    z = _z_min(target_j) + 0.3 * rng.standard_normal((200, 60))
    # Half the rows mirrored (D-form) through the Cartesian frame.
    with jax.enable_x64():
        x_j = np.asarray(jax.jit(target_j.transform.flow_to_cartesian)(jnp.asarray(z))[0])
        mirrored = (x_j.reshape(-1, 22, 3) * np.array([-1.0, 1.0, 1.0])).reshape(-1, 66)
        z[::2] = np.asarray(jax.jit(target_j.transform.cartesian_to_flow)(
            jnp.asarray(mirrored[::2]))[0])
        phi_j, psi_j = (np.asarray(a) for a in _Jitted(target_j).phi_psi(jnp.asarray(z)))
    phi, psi = target.phi_psi(torch.tensor(z))
    assert_close(phi, phi_j, 1e-10, "phi")
    assert_close(psi, psi_j, 1e-10, "psi")

    scale, shift = aldp_eval.chirality_scale_shift(target.transform)
    assert (scale, shift) == jax_eval.chirality_scale_shift(target_j.transform)
    keep = aldp_eval.filter_chirality(z, scale=scale, shift=shift)
    keep_j = jax_eval.filter_chirality(z, scale=scale, shift=shift)
    np.testing.assert_array_equal(keep, keep_j)
    assert 0.3 < keep.mean() < 0.7
    mask = rng.random(200) > 0.1
    for min_frac in (0.1, 0.9):  # filtering, and the guard that leaves the mask
        f = aldp_eval.make_chirality_filter(scale=scale, shift=shift, min_frac=min_frac)
        with jax.enable_x64():
            f_j = jax_eval.make_chirality_filter_jax(scale=scale, shift=shift,
                                                     min_frac=min_frac)
            m_j = np.asarray(f_j(jnp.asarray(z), jnp.asarray(mask)))
        m = f(torch.tensor(z), torch.tensor(mask)).numpy()
        np.testing.assert_array_equal(m, m_j)
    assert ca_signed_volume(target.ref_cartesian.reshape(-1, 22, 3)).min() > 0


def test_evaluate_aldp_matches(targets, tmp_path):
    target_j, target = targets
    rng = np.random.default_rng(4)
    z_min = _z_min(target_j)
    z_test = z_min + 0.05 * rng.standard_normal((600, 60))
    z_sample = z_min + 0.08 * rng.standard_normal((500, 60))
    with jax.enable_x64():
        m_j = jax_eval.evaluate_aldp(_Jitted(target_j), z_sample, z_test, iteration=7,
                                     metric_dir=str(tmp_path / "jax"))
    m = aldp_eval.evaluate_aldp(target, z_sample, z_test, iteration=7,
                                metric_dir=str(tmp_path / "port"))
    assert list(m) == list(m_j)
    for k in m:
        assert math.isfinite(m[k]) and abs(m[k] - m_j[k]) <= 1e-12 * max(1.0, abs(m_j[k])), k
    rows = (tmp_path / "port" / "metrics.csv").read_text().splitlines()
    assert rows[0] == (tmp_path / "jax" / "metrics.csv").read_text().splitlines()[0]
    assert len(rows) == 2
    aldp_eval.evaluate_aldp(target, z_sample, z_test, iteration=7, plot_dir=str(tmp_path))
    assert sorted(p.name for p in tmp_path.glob("*.png")) == [
        "marginals_dih_000007.png", "ramachandran_000007.png"]


def test_minimisation_and_reflection_match(ref_path, tmp_path):
    """Each package's own 200-step minimisation from the idealised geometry
    (vacuum), and a mirror-image (D-form) data_path, reflected to L by both."""
    with jax.enable_x64():
        minimised_j = JaxAldp(temperature=300.0, minimise_steps=200)
    minimised = AldpBoltzmann(temperature=300.0, minimise_steps=200, dtype=DT, device="cpu")
    assert_close(minimised.ref_cartesian, minimised_j.ref_cartesian, 1e-8, "minimum")
    assert_close(minimised.transform.mean, minimised_j.transform.mean, 1e-8, "mean")

    mirror = np.load(ref_path).reshape(1, 22, 3) * np.array([-1.0, 1.0, 1.0])
    path = tmp_path / "mirror.npy"
    np.save(path, mirror.reshape(1, 66))
    assert ca_signed_volume(mirror)[0] < 0
    with jax.enable_x64():
        reflected_j = JaxAldp(data_path=str(path), temperature=300.0)
    reflected = AldpBoltzmann(data_path=str(path), temperature=300.0, dtype=DT, device="cpu")
    np.testing.assert_array_equal(reflected.ref_cartesian, reflected_j.ref_cartesian)
    assert ca_signed_volume(reflected.ref_cartesian.reshape(1, 22, 3))[0] > 0


def test_backends_and_metrics():
    with pytest.raises(ValueError, match="unknown backend"):
        AldpBoltzmann(backend="openmm", data_path=str(GOLDEN), device="cpu")
    host = AldpBoltzmann(backend="host_cpp", data_path=str(GOLDEN), env="implicit",
                         n_threads=3, device="cpu")
    assert host._server.gb and host._server.n_threads == 3
    target = AldpBoltzmann(data_path=None, minimise_steps=0, device="cpu")
    assert target.performance_metrics(None, None) == {}
    assert target.dim == 60 and target.dtype == torch.float32
