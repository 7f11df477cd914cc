"""ALDP evaluation: marginal KLDs, Ramachandran metrics, chirality filter
(``fab_tpu/utils/aldp_eval.py``).

Per-dimension 200-bin histogram KLDs of the normalised internal coordinates, split
into bond / angle / dihedral groups; 1-D KLDs of the backbone phi and psi and the
64-bin 2-D Ramachandran KLD; an append to ``metrics.csv``; the Ramachandran and
dihedral-marginal PNGs (matplotlib). The internal layout is
[b1, b2, a2 | bonds(19) | angles(19) | dihedrals(19)], so the groups are fixed
slices.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from fab_tpu_torch.utils.plotting import pyplot

N_Z = 19
BOND_DIMS = tuple([0, 1] + list(range(3, 3 + N_Z)))
ANGLE_DIMS = tuple([2] + list(range(3 + N_Z, 3 + 2 * N_Z)))
DIH_DIMS = tuple(range(3 + 2 * N_Z, 3 + 3 * N_Z))

# Dihedral flow-dims of HA (atom 9, z-row 7) and CB (atom 10, z-row 8) about the
# CA-N axis: their wrapped difference distinguishes the L- from the D-form.
CHIRALITY_DIMS = (3 + 2 * N_Z + 7, 3 + 2 * N_Z + 8)


def _hist_kld(test: np.ndarray, gen: np.ndarray, nbins: int, lo: float, hi: float):
    """KLD(test || gen) from density histograms."""
    eps = 1e-10
    htest, _ = np.histogram(test, nbins, range=(lo, hi), density=True)
    hgen, _ = np.histogram(gen, nbins, range=(lo, hi), density=True)
    return float(
        np.sum(htest * np.log((htest + eps) / (hgen + eps))) * (hi - lo) / nbins
    )


def _wrap(a: np.ndarray) -> np.ndarray:
    return (a + np.pi) % (2 * np.pi) - np.pi


L_FORM_DIFF = -2.0 * np.pi / 3.0  # HA - CB dihedral difference of the L-form
THRESHOLD = 0.8


def _require_scale_shift(name, scale, shift, raw) -> None:
    if (scale is None or shift is None) and not raw:
        raise ValueError(
            f"{name}: pass scale=/shift= (chirality_scale_shift(transform)) for "
            "flow-space coords, or raw=True if the input is genuinely raw radians.")


def filter_chirality(z_flow: np.ndarray, scale=None, shift=None, *, ind=CHIRALITY_DIMS,
                     mean_diff: Optional[float] = None, threshold: float = THRESHOLD,
                     raw: bool = False) -> np.ndarray:
    """Boolean mask of flow-space samples in the L-alanine chirality basin (numpy).

    The difference of the dihedrals at ``ind`` (HA and CB about the CA frame; raw
    radians, IUPAC dihedral sign) sits near -2pi/3 for the L-form and +2pi/3 for the
    D-form; samples within ``threshold`` (0.8) of ``mean_diff`` (default -2pi/3, the
    L-form) pass. ``scale``/``shift`` (``chirality_scale_shift(transform)``) map the
    flow coordinates back to raw radians: dim 48 (HA, z-row 7) is not circular, so
    the transform standardises it; dim 49 (CB) is circular and stays raw. A
    difference of a standardised and a raw angle would pick the wrong basin, so they
    are required unless ``raw=True`` says the input is raw radians already.
    """
    _require_scale_shift("filter_chirality", scale, shift, raw)
    mean_diff = L_FORM_DIFF if mean_diff is None else mean_diff
    a, b = z_flow[:, ind[0]], z_flow[:, ind[1]]
    if scale is not None:
        a, b = a * scale[0], b * scale[1]
    if shift is not None:
        a, b = a + shift[0], b + shift[1]
    diff = _wrap(_wrap(a) - _wrap(b))
    return np.abs(_wrap(diff - mean_diff)) < threshold


def chirality_scale_shift(transform, ind=CHIRALITY_DIMS):
    """(scale, shift) tuples mapping the flow coords at ``ind`` (the chirality
    dims) to raw radians."""
    i0, i1 = ind
    return (
        (float(transform.std[i0]), float(transform.std[i1])),
        (float(transform.mean[i0]), float(transform.mean[i1])),
    )


def make_chirality_filter(scale=None, shift=None, min_frac: float = 0.1, *,
                          ind=CHIRALITY_DIMS, mean_diff: Optional[float] = None,
                          threshold: float = THRESHOLD, raw: bool = False):
    """The train-time chirality filter as a torch ``(x, mask) -> mask``
    (``fab_tpu/utils/aldp_eval.py:108-155``): D-form rows are marked invalid, so
    they carry -inf importance weight, unless at most ``min_frac`` of the valid rows
    are L-form (then the mask is returned unfiltered, so training is not starved).
    ``ind``, ``mean_diff``, ``threshold`` and ``raw`` as ``filter_chirality``'s.
    Runs on the device with no host sync."""
    _require_scale_shift("make_chirality_filter", scale, shift, raw)
    mean_diff = L_FORM_DIFF if mean_diff is None else mean_diff
    s0, s1 = (1.0, 1.0) if scale is None else scale
    t0, t1 = (0.0, 0.0) if shift is None else shift
    i0, i1 = ind

    def wrap(a):
        return torch.remainder(a + np.pi, 2 * np.pi) - np.pi

    def sample_filter(x, mask):
        # Unscale to raw radians before differencing (see filter_chirality).
        diff = wrap(wrap(x[:, i0] * s0 + t0) - wrap(x[:, i1] * s1 + t1))
        ind_l = wrap(diff - mean_diff).abs() < threshold
        frac_l = (ind_l & mask).sum() / mask.sum().clamp(min=1)
        return torch.where(frac_l > min_frac, mask & ind_l, mask)

    return sample_filter


def evaluate_aldp(
    target,
    z_sample: np.ndarray,
    z_test: np.ndarray,
    iteration: int = 0,
    metric_dir: Optional[str] = None,
    plot_dir: Optional[str] = None,
    batch_size: int = 1000,
) -> Dict[str, float]:
    """The ALDP metric suite of flow-space samples against a flow-space test set;
    appends a row to ``<metric_dir>/metrics.csv`` if ``metric_dir`` is given, and
    writes ``ramachandran_<iter>.png`` and ``marginals_dih_<iter>.png`` into
    ``plot_dir`` if that is given (raising ``ImportError`` first, before any
    output, if matplotlib is missing). ``target`` is an ``AldpBoltzmann`` (for
    phi_psi and the transform)."""
    plt = pyplot() if plot_dir is not None else None
    z_sample = np.asarray(z_sample)
    z_test = np.asarray(z_test)
    ch_scale, ch_shift = chirality_scale_shift(target.transform)

    # Marginal KLDs over normalised internal coords.
    nbins = 200
    lo, hi = -5.0, 5.0
    dim = z_sample.shape[1]
    kld = np.array(
        [
            _hist_kld(z_test[:, i], z_sample[:, i], nbins, lo, hi)
            if i not in DIH_DIMS
            else _hist_kld(
                _wrap(z_test[:, i]), _wrap(z_sample[:, i]), nbins, -np.pi, np.pi
            )
            for i in range(dim)
        ]
    )
    kld_bond = kld[list(BOND_DIMS)]
    kld_angle = kld[list(ANGLE_DIMS)]
    kld_dih = kld[list(DIH_DIMS)]

    # phi/psi and Ramachandran KLDs, the dihedrals computed on the target's device.
    def phi_psi(z):
        out_phi, out_psi = [], []
        with torch.no_grad():
            for start in range(0, len(z), batch_size):
                chunk = torch.as_tensor(
                    z[start : start + batch_size], dtype=target.dtype, device=target.device
                )
                p, s = target.phi_psi(chunk)
                out_phi.append(p.cpu().numpy())
                out_psi.append(s.cpu().numpy())
        return np.concatenate(out_phi), np.concatenate(out_psi)

    phi, psi = phi_psi(z_sample)
    phi_d, psi_d = phi_psi(z_test)
    ok = np.isfinite(phi) & np.isfinite(psi)
    phi, psi = phi[ok], psi[ok]
    ok_d = np.isfinite(phi_d) & np.isfinite(psi_d)
    phi_d, psi_d = phi_d[ok_d], psi_d[ok_d]

    kld_phi = _hist_kld(phi_d, phi, nbins, -np.pi, np.pi)
    kld_psi = _hist_kld(psi_d, psi, nbins, -np.pi, np.pi)

    nbins_ram = 64
    eps = 1e-10
    h_test = np.histogram2d(
        phi_d, psi_d, nbins_ram, range=[[-np.pi, np.pi]] * 2, density=True
    )[0]
    h_gen = np.histogram2d(
        phi, psi, nbins_ram, range=[[-np.pi, np.pi]] * 2, density=True
    )[0]
    kld_ram = float(
        np.sum(h_test * np.log((h_test + eps) / (h_gen + eps)))
        * (2 * np.pi / nbins_ram) ** 2
    )

    metrics = {
        "iter": iteration,
        "kld_bond_mean": float(kld_bond.mean()),
        "kld_bond_max": float(kld_bond.max()),
        "kld_angle_mean": float(kld_angle.mean()),
        "kld_angle_max": float(kld_angle.max()),
        "kld_dih_mean": float(kld_dih.mean()),
        "kld_dih_max": float(kld_dih.max()),
        "kld_phi": kld_phi,
        "kld_psi": kld_psi,
        "kld_ram": kld_ram,
        "frac_L_form": float(np.mean(filter_chirality(z_sample, ch_scale, ch_shift))),
        # Mass in the positive-phi (alpha-L) region, model samples and test set:
        # the minor phi mode (about 0.2-0.4 % of the mass) that FAB should find.
        "frac_phi_pos_sample": float(((phi > 0.0) & (phi < 2.4)).mean()),
        "frac_phi_pos_test": float(((phi_d > 0.0) & (phi_d < 2.4)).mean()),
    }

    if metric_dir is not None:
        os.makedirs(metric_dir, exist_ok=True)
        path = os.path.join(metric_dir, "metrics.csv")
        header = not os.path.exists(path)
        with open(path, "a") as f:
            if header:
                f.write(",".join(metrics.keys()) + "\n")
            f.write(",".join(str(v) for v in metrics.values()) + "\n")

    if plot_dir is not None:
        os.makedirs(plot_dir, exist_ok=True)
        fig, axs = plt.subplots(1, 2, figsize=(10, 4))
        for ax, (a, b), title in zip(axs, ((phi_d, psi_d), (phi, psi)),
                                     ("test data", "model samples")):
            ax.hist2d(a, b, bins=nbins_ram, range=[[-np.pi, np.pi]] * 2, cmap="viridis")
            ax.set_title(title)
            ax.set_xlabel(r"$\phi$")
            ax.set_ylabel(r"$\psi$")
        fig.savefig(os.path.join(plot_dir, f"ramachandran_{iteration:06d}.png"))
        plt.close(fig)

        # The dihedral group's marginals, test set and model samples overlaid.
        fig, axs = plt.subplots(4, 5, figsize=(16, 10))
        for j, d in enumerate(DIH_DIMS):
            ax = axs.ravel()[j]
            ax.hist(_wrap(z_test[:, d]), 60, density=True, alpha=0.5, label="test")
            ax.hist(_wrap(z_sample[:, d]), 60, density=True, alpha=0.5, label="model")
            ax.set_title(f"dih {j}")
        axs.ravel()[0].legend()
        fig.tight_layout()
        fig.savefig(os.path.join(plot_dir, f"marginals_dih_{iteration:06d}.png"))
        plt.close(fig)

    return metrics
