"""The port's ALDP physics scripts and ALDP demo against fab_tpu's, on the CPU.

- ``rotate_about_bond``, ``dihedral`` (aldp_torsion_scan), ``basin_populations`` and
  ``split_chain_rhat`` (aldp_external_anchor) against fab_tpu's scripts' functions on
  shared arrays, 1e-12;
- the torsion scan's energy grid at ``--n-grid 12`` against
  ``experiments/aldp_torsion_scan.py``'s (its frames and fab_tpu's force field, under
  x64), float64, 1e-8, and its CSV against the one that script writes (5 decimals);
- aldp_phi_overlay, aldp_external_anchor (part 2) and aldp_demo on a run of the port's
  ``run_aldp``: the report keys of fab_tpu's scripts, the reference-MD column null,
  finite numbers, the figures with matplotlib and ``plots off`` without.
"""
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest

from experiments import aldp_external_anchor as jax_anchor
from fab_tpu.targets.aldp_ff import build_tables as jax_build_tables
from fab_tpu.targets.aldp_ff import energy_kcal as jax_energy_kcal
from fab_tpu.targets.aldp_ff import gb_energy_kcal as jax_gb_energy_kcal
from fab_tpu_torch.demo import aldp_demo
from fab_tpu_torch.experiments import (
    aldp_external_anchor,
    aldp_phi_overlay,
    aldp_torsion_scan,
    run_aldp,
)
from torch_parity_utils import assert_close, one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "experiments" / "configs" / "aldp.yaml")
GOLDEN = ROOT / "tests" / "data" / "aldp_openmm_min_energy_nm.npy"
ALDP_TINY = ["flow.blocks=2", "flow.hidden_units=16", "training.batch_size=32"]


@pytest.fixture(scope="module")
def jax_scan():
    """``experiments/aldp_torsion_scan.py``; it turns x64 on in JAX's global config
    when imported, which is put back here."""
    before = jax.config.jax_enable_x64
    from experiments import aldp_torsion_scan as module

    jax.config.update("jax_enable_x64", before)
    return module


@pytest.fixture(scope="module")
def aldp_run(tmp_path_factory):
    """A run of the port's run_aldp at tiny widths on the golden frame (Angstrom)."""
    root = tmp_path_factory.mktemp("aldp")
    frame = root / "frame.npy"
    np.save(frame, np.load(GOLDEN).reshape(1, 66) * 10)
    run_aldp.main(["--config", CONFIG, "--device", "cpu", *ALDP_TINY, "training.max_iter=2",
                   "training.replay_buffer.min_length=2", "training.n_test_samples=200",
                   "training.test_mcmc_steps=20", "training.final_eval_samples=100",
                   "training.n_eval=0", f"training.save_root={root / 'run'}",
                   f"data.transform={frame}"])
    return {"run": root / "run", "frame": frame}


def test_rotation_and_dihedral_match_fab_tpu(jax_scan):
    pos = np.load(GOLDEN).reshape(22, 3) * 10.0
    for angle in (-2.0, 0.3, 3.1):
        for axis, moving in ((jax_scan.PHI_AXIS, jax_scan.PHI_MOVING),
                             (jax_scan.PSI_AXIS, jax_scan.PSI_MOVING)):
            got = aldp_torsion_scan.rotate_about_bond(pos, *axis, moving, angle)
            assert_close(got, jax_scan.rotate_about_bond(pos, *axis, moving, angle), 1e-12)
            for atoms in (jax_scan.PHI_ATOMS, jax_scan.PSI_ATOMS):
                assert_close(aldp_torsion_scan.dihedral(got, atoms),
                             jax_scan.dihedral(got, atoms), 1e-12)
    assert (aldp_torsion_scan.PHI_ATOMS, aldp_torsion_scan.PSI_ATOMS) == (
        jax_scan.PHI_ATOMS, jax_scan.PSI_ATOMS)


def test_torsion_scan_grid_matches_fab_tpu(jax_scan, tmp_path, monkeypatch):
    n = 12
    out = aldp_torsion_scan.main(["--n-grid", str(n), "--device", "cpu", "--out",
                                  str(tmp_path / "port.csv")])
    pos0 = np.load(GOLDEN).reshape(22, 3) * 10.0
    phi0 = jax_scan.dihedral(pos0, jax_scan.PHI_ATOMS)
    psi0 = jax_scan.dihedral(pos0, jax_scan.PSI_ATOMS)
    grid = np.linspace(-np.pi, np.pi, n, endpoint=False)
    frames = np.empty((n, n, 22, 3))
    for i, ph in enumerate(grid):
        p_phi = jax_scan.rotate_about_bond(pos0, *jax_scan.PHI_AXIS, jax_scan.PHI_MOVING, ph - phi0)
        for j, ps in enumerate(grid):
            frames[i, j] = jax_scan.rotate_about_bond(p_phi, *jax_scan.PSI_AXIS,
                                                      jax_scan.PSI_MOVING, ps - psi0)
    with jax.enable_x64():
        tables = jax_build_tables()
        flat = jnp.asarray(frames.reshape(n * n, 22, 3))
        e_j = np.asarray(jax_energy_kcal(tables, flat) + jax_gb_energy_kcal(tables, flat))
    e_j = e_j.reshape(n, n) - e_j.min()
    assert_close(out["frames"], frames, 1e-12, "frames")
    assert_close(out["E"], e_j, 1e-8, "energy grid")

    monkeypatch.chdir(ROOT)
    with jax.enable_x64():
        jax_scan.main(["--n-grid", str(n), "--out", str(tmp_path / "jax.csv")])
    port = np.loadtxt(tmp_path / "port.csv", delimiter=",", skiprows=1)
    fab = np.loadtxt(tmp_path / "jax.csv", delimiter=",", skiprows=1)
    assert (tmp_path / "port.csv").read_text().splitlines()[0] == "phi,psi,energy_kcal"
    np.testing.assert_allclose(port, fab, rtol=0, atol=1.1e-5)


def test_anchor_helpers_match_fab_tpu():
    rng = np.random.default_rng(2)
    phi, psi = rng.uniform(-np.pi, np.pi, (2, 4000))
    assert aldp_external_anchor.basin_populations(phi, psi) == jax_anchor.basin_populations(
        phi, psi)
    for chains in (rng.random((16, 40)) < 0.3, np.ones((4, 10)), np.zeros((4, 10)),
                   np.repeat([[0.0], [1.0]], 20, axis=1)):
        got, want = (aldp_external_anchor.split_chain_rhat(chains),
                     jax_anchor.split_chain_rhat(chains))
        assert got == want or abs(got - want) <= 1e-12 * abs(want), (got, want)


def test_torsion_scan_with_a_port_test_set(aldp_run, tmp_path):
    out = aldp_torsion_scan.main(["--n-grid", "8", "--device", "cpu", "--out",
                                  str(tmp_path / "scan.csv"), "--test-set",
                                  str(aldp_run["run"] / "test_set.npy"), "--run-config", CONFIG,
                                  f"data.transform={aldp_run['frame']}"])
    masses = out["test_set"]
    assert 0 <= masses["mass_c5"] <= 1 and 0 <= masses["mass_c7"] <= 1
    assert masses["mass_c5"] + masses["mass_c7"] <= 1 + 1e-9


def test_phi_overlay_on_a_port_run(aldp_run, tmp_path, monkeypatch, capsys):
    scan = tmp_path / "scan.csv"
    aldp_torsion_scan.main(["--n-grid", "12", "--device", "cpu", "--out", str(scan)])
    phi_scan, p_scan = aldp_phi_overlay.scan_phi_marginal(str(scan))
    d = np.loadtxt(scan, delimiter=",", skiprows=1)  # fab_tpu's lines, with numpy's rule
    w = np.exp(-(d[:, 2] - d[:, 2].min()) / (0.0019872041 * 300)).reshape(12, 12)
    want = w.sum(1) / np.trapezoid(w.sum(1), d[:, 0].reshape(12, 12)[:, 0])
    assert_close(p_scan, want, 1e-12, "scan phi density")
    args = ["--run", str(aldp_run["run"]), "--config", CONFIG, "--n-samples", "300", "--scan",
            str(scan), "--device", "cpu", *ALDP_TINY, f"data.transform={aldp_run['frame']}"]
    report = aldp_phi_overlay.main(args + ["--out-prefix", str(tmp_path / "a" / "overlay")])
    assert (tmp_path / "a" / "overlay.png").stat().st_size > 0
    assert json.loads((tmp_path / "a" / "overlay.json").read_text()) == json.loads(
        json.dumps(report))
    assert list(report) == ["iter", "n_flow_samples", "peaks", "mass_phi_lt_m1.6",
                            "mass_alphaL_region"]
    assert report["iter"] == 2 and report["peaks"]["reference_md"] is None
    assert set(report["mass_alphaL_region"]) == {"flow", "flow_mc_stderr", "flow_count",
                                                 "test_set", "ff_scan", "reference_md"}
    assert "reference MD column: unavailable" in capsys.readouterr().out
    matplotlib.pyplot.close("all")
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.setitem(sys.modules, name, None)
    aldp_phi_overlay.main(args + ["--out-prefix", str(tmp_path / "b" / "overlay")])
    assert "plots off" in capsys.readouterr().out
    assert not (tmp_path / "b" / "overlay.png").exists()


def test_external_anchor_part_2_on_a_port_test_set(aldp_run, tmp_path, capsys):
    out = tmp_path / "anchor.json"
    report = aldp_external_anchor.main([
        "--quick", "--test-set", str(aldp_run["run"] / "test_set.npy"), "--data-path",
        str(aldp_run["frame"]), "--n-samples", "64", "--n-steps", "20", "--fresh-chains", "32",
        "--n-chains", "8", "--n-sweeps", "9", "--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert report["reference_md_curve"] is None and report["md_anchor"]["reference_md"] is None
    assert set(report["fresh_chains"]) == {"seed7", "seed23"}
    for pops in [report["test_set_basins"], *report["fresh_chains"].values()]:
        assert abs(pops["alpha_L"] + pops["alpha_R"] + pops["beta_C5_PPII"] + pops["other"]
                   - 1) < 1e-9
    assert report["fresh_chains"]["seed7"]["n"] == 64
    assert np.isfinite(report["rhat_alphaR_indicator"]) or report["rhat_alphaR_indicator"] == np.inf
    assert 0 <= report["alphaR_frac_last_half"] <= 1
    assert "reference MD: unavailable" in capsys.readouterr().out


def test_aldp_demo_checkpoint_and_train(aldp_run, tmp_path):
    common = ["--config", CONFIG, "--device", "cpu", "--n-samples", "200"]
    out = aldp_demo.main(common + ["--checkpoint", str(aldp_run["run"]), "--out",
                                   str(tmp_path / "ckpt.png"), *ALDP_TINY,
                                   f"data.transform={aldp_run['frame']}"])
    assert out["phi"].shape == (200,) and np.isfinite(out["mean_log_q"])
    assert (tmp_path / "ckpt.png").stat().st_size > 0
    out = aldp_demo.main(common + ["--train", "--iters", "1", "--out", str(tmp_path / "t.png"),
                                   "flow.blocks=2", "flow.hidden_units=16",
                                   "training.batch_size=16", f"data.transform={aldp_run['frame']}"])
    assert np.isfinite(out["mean_log_q"]) and (tmp_path / "t.png").stat().st_size > 0
    matplotlib.pyplot.close("all")
    with pytest.raises(SystemExit):
        aldp_demo.main(["--device", "cpu"])  # neither --checkpoint nor --train
