"""Independent-sampler consistency of the ALDP ensemble
(``experiments/aldp_external_anchor.py`` of the repository, its part 2).

    python3 -m fab_tpu_torch.experiments.aldp_external_anchor --test-set <run>/test_set.npy
        [--quick] [--data-path <frame.npy>] [--out results/torch/aldp_external_anchor.json]
        [--n-samples N] [--n-steps N] [--fresh-chains N] [--n-chains N] [--n-sweeps N]
        [--device cpu]

- The test set's basin populations (C5/PPII, alpha_R, alpha_L) and phi masses;
- fresh HMC test sets from two seeds (7, 23) through the port's
  ``generate_test_set``: basin populations and the alpha_L-region mass of each
  (10,000 samples of 400 sweeps; ``--quick`` 2,000 of 200);
- a multi-chain HMC run from the reference configuration plus 0.05 noise (10
  leapfrog steps of 0.05, step size tuned; 256 chains x 120 sweeps, ``--quick`` 64
  x 60): the split-chain R-hat of the alpha_R indicator over the last two thirds.

The target is the implicit-solvent ``AldpBoltzmann`` (its reference from
``--data-path``, else the 4000-step minimisation). ``--n-samples``, ``--n-steps``,
``--fresh-chains`` (the chains of a fresh set; ``generate_test_set``'s own count,
at least 512, by default), ``--n-chains`` and ``--n-sweeps`` cut the lengths further.

Part 1 of the repository's script compares the test set with the reference MD phi
density, digitised from a plot that is not in this repository: that column is
printed as unavailable and written as null; the test set's own side of it is
kept.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from fab_tpu_torch import random
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.aldp_phi_overlay import REFERENCE_MD, phi_psi, trapezoid
from fab_tpu_torch.experiments.run_aldp import generate_test_set
from fab_tpu_torch.sampling import HamiltonianMonteCarlo, create_point
from fab_tpu_torch.targets.aldp import AldpBoltzmann


def basin_populations(phi, psi):
    """Coarse basin split used for consistency checks (radians).

    alpha_L: phi in (0, 2.2); alpha_R: phi <= 0, psi in (-1.8, 0.5); C5/PPII (beta):
    phi <= 0 elsewhere.
    """
    phi = np.asarray(phi)
    psi = np.asarray(psi)
    al = (phi > 0) & (phi < 2.2)
    ar = (phi <= 0) & (psi > -1.8) & (psi < 0.5)
    beta = (phi <= 0) & ~ar
    other = ~(al | ar | beta)
    n = len(phi)
    return {
        "alpha_L": float(al.mean()),
        "alpha_R": float(ar.mean()),
        "beta_C5_PPII": float(beta.mean()),
        "other": float(other.mean()),
        "n": n,
    }


def split_chain_rhat(indicator_chains):
    """Split-chain R-hat of a binary indicator; chains [M, T]."""
    x = np.asarray(indicator_chains, float)
    m, t = x.shape
    half = t // 2
    x = np.concatenate([x[:, :half], x[:, half : 2 * half]], 0)  # [2M, half]
    cm = x.mean(1)
    w = x.var(1, ddof=1).mean()
    b = half * cm.var(ddof=1)
    if w <= 0:
        return 1.0 if b <= 0 else np.inf
    var_hat = (half - 1) / half * w + b / half
    return float(np.sqrt(var_hat / w))


def test_set_anchors(phi_t) -> dict:
    """The test set's side of part 1 (the reference MD side is unavailable)."""
    hist, edges = np.histogram(phi_t, 100, range=(-np.pi, np.pi), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])

    def region_mass(lo, hi):
        m = (centers >= lo) & (centers < hi)
        return trapezoid(hist[m], centers[m])

    return {"reference_md": None,
            "mass_phi_pos_ours": region_mass(0.0, 2.4),
            "mass_phi_lt_m1.6_ours": region_mass(-np.pi, -1.6),
            "mass_phi_m1.6_0_ours": region_mass(-1.6, 0.0),
            "peak_major_ours": float(centers[np.argmax(hist)])}


def alpha_r_rhat(target, n_chains: int, n_sweeps: int, device) -> dict:
    """Split-chain R-hat of the alpha_R indicator over n_chains HMC chains."""
    op = HamiltonianMonteCarlo(n_ais_intermediate_distributions=1, n_outer=1,
                               n_leapfrog=10, epsilon=0.05)
    state = op.init_state(target.dim, dtype=torch.float32, device=device)
    ref = torch.as_tensor(target.ref_cartesian, dtype=target.dtype, device=device)
    z0, _ = target.transform.cartesian_to_flow(ref)
    noise = torch.Generator(device=device).manual_seed(100)
    z = z0.expand(n_chains, target.dim) + 0.05 * random.normal(
        noise, (n_chains, target.dim), target.dtype, device)

    def log_q(x):
        return (x * 0.0).sum(-1)

    point = create_point(z, log_q, target.log_prob, with_grad=True)
    mask = torch.ones(n_chains, dtype=torch.bool, device=device)
    generator = torch.Generator(device=device).manual_seed(99)
    traj = []
    for _ in range(n_sweeps):
        point, state, _ = op.transition(state, generator, point, 1.0, 0, log_q,
                                        target.log_prob, 1.0, mask, True)
        traj.append(point.x.cpu().numpy())
    burn = len(traj) // 3
    ar = np.zeros((n_chains, len(traj) - burn))
    for t in range(burn, len(traj)):
        a, b = phi_psi(target, traj[t])
        ar[:, t - burn] = (a <= 0) & (b > -1.8) & (b < 0.5)
    return {"rhat_alphaR_indicator": split_chain_rhat(ar),
            "alphaR_frac_last_half": float(ar[:, ar.shape[1] // 2:].mean())}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--test-set", default="results/aldp/fab_buff_r5/00/test_set.npy")
    p.add_argument("--quick", action="store_true", help="smaller fresh chains")
    p.add_argument("--data-path", default=None,
                   help="the target's reference frame (else it is minimised)")
    p.add_argument("--n-samples", type=int, default=None)
    p.add_argument("--n-steps", type=int, default=None)
    p.add_argument("--fresh-chains", type=int, default=None)
    p.add_argument("--n-chains", type=int, default=None)
    p.add_argument("--n-sweeps", type=int, default=None)
    p.add_argument("--out", default="results/torch/aldp_external_anchor.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    target = AldpBoltzmann(data_path=args.data_path, env="implicit", device=device)
    report = {"reference_md_curve": None}
    print(f"part 1, reference MD: {REFERENCE_MD}")

    phi_t, psi_t = phi_psi(target, np.load(args.test_set))
    ok = np.isfinite(phi_t) & np.isfinite(psi_t)
    phi_t, psi_t = phi_t[ok], psi_t[ok]
    report["md_anchor"] = test_set_anchors(phi_t)
    report["test_set_basins"] = basin_populations(phi_t, psi_t)

    n_s = args.n_samples or (2000 if args.quick else 10000)
    steps = args.n_steps or (200 if args.quick else 400)
    fresh = {}
    for name, seed in (("seed7", 7), ("seed23", 23)):
        z = generate_test_set(target, torch.Generator(device=device).manual_seed(seed),
                              n_samples=n_s, n_steps=steps, n_chains=args.fresh_chains)
        a, b = phi_psi(target, z)
        fresh[name] = basin_populations(a, b)
        fresh[name]["mass_phi_pos"] = float(((a > 0) & (a < 2.4)).mean())
    report["fresh_chains"] = fresh

    n_ch = args.n_chains or (64 if args.quick else 256)
    n_sw = args.n_sweeps or (60 if args.quick else 120)
    report.update(alpha_r_rhat(target, n_ch, n_sw, device))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
