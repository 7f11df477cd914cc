"""The phi marginal of a trained ALDP flow against the test set and the force
field's rigid scan (``experiments/aldp_phi_overlay.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.aldp_phi_overlay --run <training.save_root>
        [--config experiments/configs/aldp.yaml] [--n-samples 50000]
        [--scan reports/aldp_torsion_scan.csv]
        [--out-prefix results/torch/aldp_phi_overlay] [--device cpu] [overrides ...]

Loads the run's latest checkpoint (``model_checkpoints/iter_<n>``, written by
either package's ``run_aldp``) into the config's flow, draws ``--n-samples`` flow
samples, and reads the run's ``test_set.npy`` and the scan CSV of
``aldp_torsion_scan`` (only read; its 300 K Boltzmann phi marginal). Reports each
curve's peak, its mass at phi < -1.6 and in the alpha_L region (0 < phi < 2.4), the
flow's with its Monte Carlo error, as ``<out-prefix>.json``, and with matplotlib the
figure ``<out-prefix>.png`` (else ``plots off``).

The repository's script adds a fourth curve, the reference MD phi density digitised
from a plot that is not in this repository; its column is printed as unavailable
and written as null.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from fab_tpu_torch.checkpoint import latest_checkpoint
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.load_model_for_eval import load_flow
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
from fab_tpu_torch.utils.plotting import PLOTS_OFF, plots_available, pyplot
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64

KT_300K = 0.0019872041 * 300.0
REFERENCE_MD = "unavailable: the reference MD phi plot is not in this repository"


def trapezoid(y, x) -> float:
    return float(np.sum((y[1:] + y[:-1]) * np.diff(x)) / 2)


def scan_phi_marginal(path: str):
    """(phi grid, normalised 300 K Boltzmann phi density) of a scan CSV."""
    d = np.loadtxt(path, delimiter=",", skiprows=1)
    n = int(round(np.sqrt(len(d))))
    w = np.exp(-(d[:, 2] - d[:, 2].min()) / KT_300K).reshape(n, n)
    phi_scan = d[:, 0].reshape(n, n)[:, 0]
    p_scan = w.sum(1)
    return phi_scan, p_scan / trapezoid(p_scan, phi_scan)


def phi_psi(target, z: np.ndarray, batch: int = 2000):
    """(phi, psi) of flow-space rows ``z``, in batches on the target's device."""
    a, b = [], []
    with torch.no_grad():
        for i in range(0, len(z), batch):
            pa, pb = target.phi_psi(torch.as_tensor(z[i:i + batch], dtype=target.dtype,
                                                    device=target.device))
            a.append(pa.cpu().numpy())
            b.append(pb.cpu().numpy())
    return np.concatenate(a), np.concatenate(b)


def finite_phi(target, z: np.ndarray) -> np.ndarray:
    phi = phi_psi(target, z)[0]
    return phi[np.isfinite(phi)]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--run", default="results/aldp/fab_buff_r5/00")
    p.add_argument("--config", default="experiments/configs/aldp.yaml")
    p.add_argument("--n-samples", type=int, default=50_000)
    p.add_argument("--scan", default="reports/aldp_torsion_scan.csv")
    p.add_argument("--out-prefix", default="results/torch/aldp_phi_overlay")
    p.add_argument("--device", default="cuda")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = apply_overrides(load_config(args.config), args.overrides)
    dtype = maybe_enable_x64(cfg)
    model, target = make_aldp_model(cfg, dtype, device)
    ckpt = latest_checkpoint(os.path.join(args.run, "model_checkpoints"))
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {args.run}/model_checkpoints")
    load_flow(model.flow, ckpt, device)
    it = int(os.path.basename(os.path.dirname(ckpt)).split("_")[-1])
    print(f"loaded {ckpt} (iter {it})")

    generator = torch.Generator(device=device).manual_seed(0)
    B, zs = 2000, []
    with torch.no_grad():
        for start in range(0, args.n_samples, B):
            zs.append(model.flow.sample(min(B, args.n_samples - start), generator).cpu().numpy())
    phi_f = finite_phi(target, np.concatenate(zs))
    phi_t = finite_phi(target, np.load(os.path.join(args.run, "test_set.npy")))
    phi_scan, p_scan = scan_phi_marginal(args.scan)

    nb = 100
    h_f, edges = np.histogram(phi_f, nb, range=(-np.pi, np.pi), density=True)
    h_t, _ = np.histogram(phi_t, nb, range=(-np.pi, np.pi), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])

    def peak(c, h):
        return float(c[np.argmax(h)])

    def mass(c, h, lo, hi):
        m = (c >= lo) & (c < hi)
        return trapezoid(h[m], c[m])

    n_pos = int(((phi_f > 0) & (phi_f < 2.4)).sum())
    report = {
        "iter": it,
        "n_flow_samples": int(len(phi_f)),
        "peaks": {"flow": peak(centers, h_f), "test_set": peak(centers, h_t),
                  "ff_scan": peak(phi_scan, p_scan), "reference_md": None},
        "mass_phi_lt_m1.6": {
            "flow": mass(centers, h_f, -np.pi, -1.6),
            "test_set": mass(centers, h_t, -np.pi, -1.6),
            "ff_scan": mass(phi_scan, p_scan, -np.pi, -1.6),
            "reference_md": None,
        },
        "mass_alphaL_region": {
            "flow": n_pos / len(phi_f),
            "flow_mc_stderr": float(np.sqrt(max(n_pos, 1)) / len(phi_f)),
            "flow_count": n_pos,
            "test_set": float(((phi_t > 0) & (phi_t < 2.4)).mean()),
            "ff_scan": mass(phi_scan, p_scan, 0, 2.4),
            "reference_md": None,
        },
    }
    os.makedirs(os.path.dirname(args.out_prefix) or ".", exist_ok=True)
    with open(args.out_prefix + ".json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"reference MD column: {REFERENCE_MD}")

    if not plots_available():
        print(PLOTS_OFF)
        return report
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.semilogy(phi_scan, p_scan, "C2--", lw=1.5, label="force-field rigid-scan Boltzmann")
    ax.semilogy(centers, np.maximum(h_t, 1e-6), "C0-", lw=1.2, label="HMC test set")
    ax.semilogy(centers, np.maximum(h_f, 1e-6), "C3-", lw=1.2, label=f"FAB flow (iter {it})")
    ax.set_xlabel(r"$\phi$")
    ax.set_ylabel("density")
    ax.set_ylim(1e-5, 3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(args.out_prefix + ".png", dpi=130)
    plt.close(fig)
    print("wrote", args.out_prefix + ".png")
    return report


if __name__ == "__main__":
    main()
