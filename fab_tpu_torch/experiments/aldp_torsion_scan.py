"""Rigid phi/psi torsion scan of the port's ALDP force field, a physics check
(``experiments/aldp_torsion_scan.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.aldp_torsion_scan [--n-grid 72]
        [--test-set <run>/test_set.npy --run-config experiments/configs/aldp.yaml]
        [--out results/torch/aldp_torsion_scan.csv] [--device cpu] [overrides ...]

Starting from the OpenMM-minimised frame ``tests/data/aldp_openmm_min_energy_nm.npy``,
the phi branch is rotated rigidly about N6-CA8 and the psi branch about CA8-C14
(Rodrigues rotations, which keep every internal coordinate but the dihedrals
across the rotated bond), and the implicit-solvent energy E(phi, psi) = vacuum +
GBSA-OBC2 (``targets/aldp_ff.py``: ``energy_kcal`` + ``gb_energy_kcal``, float64 on
the device) is evaluated on an n x n grid. Reports:

1. the map's local minima (relative energy, phi, psi), to compare with the AMBER /
   GBSA alanine-dipeptide landmarks C7eq (phi ~ -80 deg), C5 (phi ~ -150 deg),
   alpha_R (phi ~ -70, psi ~ -25 deg) and alpha_L (phi ~ +60 deg);
2. the scan's Boltzmann phi marginal at 300 K and the free-energy profile F(phi),
   and with ``--test-set`` an HMC test set's empirical phi masses (the test set's
   target is built from ``--run-config`` and the dotted overrides).

Writes the grid as CSV (phi, psi, energy_kcal; the columns of the repository's
script). The default path lies under ``results/torch/``; the repository's
``reports/aldp_torsion_scan.csv`` is never written unless named.
"""
from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np
import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.targets.aldp_ff import build_tables, energy_kcal, gb_energy_kcal

KT_300K = 0.0019872041 * 300.0  # kcal/mol
GOLDEN = pathlib.Path(__file__).resolve().parents[2] / "tests" / "data" / (
    "aldp_openmm_min_energy_nm.npy")

# Atom branches for rigid dihedral rotation (the atom order of targets/aldp_ff.py).
PHI_AXIS = (6, 8)  # N -> CA
PHI_MOVING = [9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]
PSI_AXIS = (8, 14)  # CA -> C
PSI_MOVING = [15, 16, 17, 18, 19, 20, 21]
PHI_ATOMS = (4, 6, 8, 14)
PSI_ATOMS = (6, 8, 14, 16)


def rotate_about_bond(pos, i0, i1, moving, angle):
    """``pos`` with the atoms ``moving`` rotated by ``angle`` about the i0 -> i1 bond."""
    p = np.array(pos, np.float64)
    a0, a1 = p[i0], p[i1]
    k = (a1 - a0) / np.linalg.norm(a1 - a0)
    v = p[moving] - a1
    p[moving] = (
        a1
        + v * np.cos(angle)
        + np.cross(k, v) * np.sin(angle)
        + (v @ k)[:, None] * k[None, :] * (1 - np.cos(angle))
    )
    return p


def dihedral(p, atoms):
    """IUPAC-sign dihedral (as ``targets/internal_coords.py``'s)."""
    b1 = p[atoms[1]] - p[atoms[0]]
    b2 = p[atoms[2]] - p[atoms[1]]
    b3 = p[atoms[3]] - p[atoms[2]]
    n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
    m1 = np.cross(n1, b2 / np.linalg.norm(b2))
    return float(np.arctan2(-(m1 @ n2), n1 @ n2))


def scan_frames(pos0: np.ndarray, n: int):
    """(phis, psis, frames [n, n, 22, 3]): ``pos0`` rotated to each grid point. A
    Rodrigues rotation by +delta about the axis raises the IUPAC-sign dihedral by
    +delta."""
    phi0, psi0 = dihedral(pos0, PHI_ATOMS), dihedral(pos0, PSI_ATOMS)
    phis = np.linspace(-np.pi, np.pi, n, endpoint=False)
    psis = np.linspace(-np.pi, np.pi, n, endpoint=False)
    frames = np.empty((n, n, 22, 3))
    for i, ph in enumerate(phis):
        p_phi = rotate_about_bond(pos0, *PHI_AXIS, PHI_MOVING, ph - phi0)
        for j, ps in enumerate(psis):
            frames[i, j] = rotate_about_bond(p_phi, *PSI_AXIS, PSI_MOVING, ps - psi0)
    return phis, psis, frames


def scan_energies(frames: np.ndarray, device, chunk: int = 512) -> np.ndarray:
    """Implicit-solvent energy [kcal/mol] of each frame, float64, minus the least."""
    tables = build_tables()
    n = frames.shape[0]
    flat = torch.as_tensor(frames.reshape(n * n, 22, 3), dtype=torch.float64, device=device)
    with torch.no_grad():
        es = [energy_kcal(tables, x) + gb_energy_kcal(tables, x)
              for x in flat.split(chunk)]
    e = torch.cat(es).cpu().numpy().reshape(n, n)
    return e - e.min()


def analyse(E: np.ndarray, phis: np.ndarray, psis: np.ndarray) -> dict:
    """Local minima of the periodic map, the 300 K Boltzmann phi marginal's band
    masses, and F(-150 deg) - F(-80 deg)."""
    def neighbours(a):
        return [np.roll(np.roll(a, di, 0), dj, 1)
                for di in (-1, 0, 1) for dj in (-1, 0, 1) if (di, dj) != (0, 0)]

    is_min = np.all([E < nb for nb in neighbours(E)], axis=0)
    minima = sorted((float(E[i, j]), float(phis[i]), float(psis[j]))
                    for i, j in zip(*np.nonzero(is_min)))
    w_phi = np.exp(-E / KT_300K).sum(axis=1)
    p_phi = w_phi / w_phi.sum()
    F_phi = -KT_300K * np.log(w_phi + 1e-300)
    F_phi -= F_phi.min()

    def band_mass(lo_deg, hi_deg):
        sel = (np.rad2deg(phis) >= lo_deg) & (np.rad2deg(phis) < hi_deg)
        return float(p_phi[sel].sum())

    bands = {
        "C5/extended  phi in [-180,-120)": band_mass(-180, -120),
        "C7eq/PPII    phi in [-120, -30)": band_mass(-120, -30),
        "alpha_L      phi in [ +30,+120)": band_mass(30, 120),
    }
    bands["other"] = 1.0 - sum(bands.values())
    i_c5 = np.argmin(np.abs(np.rad2deg(phis) - (-150)))
    i_c7 = np.argmin(np.abs(np.rad2deg(phis) - (-80)))
    return {"minima": minima, "p_phi": p_phi, "F_phi": F_phi, "bands": bands,
            "F_c5_minus_c7": float(F_phi[i_c5] - F_phi[i_c7])}


def test_set_phi_masses(path: str, run_config: str, overrides, device) -> dict:
    """An HMC test set's phi masses in [-180, -120) and [-120, -30) deg (36 bins)."""
    from fab_tpu_torch.targets.aldp import AldpBoltzmann
    from fab_tpu_torch.utils.training import apply_overrides, load_config

    cfg = apply_overrides(load_config(run_config), overrides)
    sys_cfg = cfg.system
    target = AldpBoltzmann(
        data_path=cfg.data.get("transform"),
        temperature=sys_cfg.temperature,
        energy_cut=float(sys_cfg.energy_cut),
        energy_max=float(sys_cfg.energy_max),
        transform=sys_cfg.get("transform", "internal"),
        env=sys_cfg.get("env", "vacuum"),
        device=device,
    )
    z = torch.as_tensor(np.load(path)[:20000], dtype=target.dtype, device=device)
    with torch.no_grad():
        phi_t = target.phi_psi(z)[0].cpu().numpy()
    phi_t = phi_t[np.isfinite(phi_t)]
    h, edges = np.histogram(phi_t, bins=36, range=(-np.pi, np.pi), density=True)
    tot = h.sum()
    return {
        "mass_c5": float(h[(edges[:-1] >= -np.pi) & (edges[:-1] < -2 * np.pi / 3)].sum() / tot),
        "mass_c7": float(h[(edges[:-1] >= -2 * np.pi / 3) & (edges[:-1] < -np.pi / 6)].sum()
                         / tot),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-grid", type=int, default=72)
    ap.add_argument("--frame", default=str(GOLDEN),
                    help="the starting frame (nm, 22 x 3)")
    ap.add_argument("--test-set", default=None,
                    help="optional path to a run's test_set.npy (internal coords)"
                    " for the empirical phi marginal")
    ap.add_argument("--run-config", default="experiments/configs/aldp.yaml",
                    help="config used to build the transform for --test-set")
    ap.add_argument("--out", default="results/torch/aldp_torsion_scan.csv")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="dotted overrides of --run-config")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pos0 = np.load(args.frame).reshape(22, 3) * 10.0
    phi0, psi0 = dihedral(pos0, PHI_ATOMS), dihedral(pos0, PSI_ATOMS)
    print(f"golden frame: phi={phi0:.3f} rad ({np.rad2deg(phi0):.1f} deg), "
          f"psi={psi0:.3f} rad ({np.rad2deg(psi0):.1f} deg)")
    n = args.n_grid
    phis, psis, frames = scan_frames(pos0, n)
    E = scan_energies(frames, device)
    # Sanity: the scan reproduces the requested dihedrals.
    chk = frames[n // 3, 2 * n // 3]
    assert abs(dihedral(chk, PHI_ATOMS) - phis[n // 3]) < 1e-6
    assert abs(dihedral(chk, PSI_ATOMS) - psis[2 * n // 3]) < 1e-6
    assert np.isfinite(E).all(), "non-finite energy on the scan grid"

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("phi,psi,energy_kcal\n")
        for i, ph in enumerate(phis):
            for j, ps in enumerate(psis):
                f.write(f"{ph:.5f},{ps:.5f},{E[i, j]:.5f}\n")
    print(f"wrote {args.out} ({n}x{n} grid, E range 0..{E.max():.1f} kcal/mol)")

    out = analyse(E, phis, psis)
    print("\nlocal minima of the rigid-scan map (rel E kcal/mol, phi, psi deg):")
    for e, ph, ps in out["minima"][:8]:
        print(f"  E={e:7.2f}  phi={np.rad2deg(ph):7.1f}  psi={np.rad2deg(ps):7.1f}")
    print("\nrigid-scan Boltzmann phi-marginal mass at 300 K:")
    for k, v in out["bands"].items():
        print(f"  {k}: {v:.4f}")
    print(f"\nF(phi=-150deg) - F(phi=-80deg) = {out['F_c5_minus_c7']:.2f} "
          "kcal/mol (positive => C7eq/PPII basin deeper, matching literature)")
    if args.test_set:
        masses = test_set_phi_masses(args.test_set, args.run_config, args.overrides, device)
        print("\nHMC test-set phi histogram (36 bins, density):")
        print(f"  mass phi in [-180,-120) deg: {masses['mass_c5']:.4f}")
        print(f"  mass phi in [-120, -30) deg: {masses['mass_c7']:.4f}")
        out["test_set"] = masses
    out.update(E=E, phis=phis, psis=psis, frames=frames)
    return out


if __name__ == "__main__":
    main()
