"""Alanine-dipeptide Boltzmann target in internal coordinates
(``fab_tpu/targets/aldp.py``).

The flow lives in the 60-D normalised internal-coordinate space. ``log_prob`` maps
flow coords to Cartesian through the z-matrix transform (``internal_coords.py``),
evaluates the potential (the force field of ``aldp_ff.py``, plus the GBSA-OBC2 term
for ``env="implicit"``), regularises the energy (log scale above ``energy_cut``,
clamped at ``energy_max``, NaN -> max) and adds the transform's log-det. With
``backend="jax"`` (the configs' name for the on-device force field) the potential is
torch on the target's device; with ``backend="host_cpp"`` it is the C++ energy server
(``native/``) on ``n_threads`` host threads, and everything else stays in torch on
the device.

The transform's statistics come from a reference configuration: loaded from
``data_path`` (Angstrom), or made by gradient descent on the potential from an
idealised geometry. A mirror-image (D-form) reference is reflected to L-alanine.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.native import AldpEnergyServer
from fab_tpu_torch.targets.aldp_ff import (
    ATOM_TYPES,
    BOND_PARAMS,
    KB_KCAL,
    build_tables,
    energy_kcal,
    gb_energy_kcal,
)
from fab_tpu_torch.targets.base import TargetDistribution
from fab_tpu_torch.targets.internal_coords import (
    NormalizedInternalTransform,
    ZMatrixTransform,
    dihedral_angle,
)

# The z-matrix, 'internal' mode: (atom, (bond_ref, angle_ref, dihedral_ref)).
Z_MATRIX = (
    (0, (1, 4, 6)),
    (1, (4, 6, 8)),
    (2, (1, 4, 0)),
    (3, (1, 4, 0)),
    (4, (6, 8, 14)),
    (5, (4, 6, 8)),
    (7, (6, 8, 4)),
    (9, (8, 6, 4)),
    (10, (8, 6, 4)),
    (11, (10, 8, 6)),
    (12, (10, 8, 11)),
    (13, (10, 8, 11)),
    (15, (14, 8, 16)),
    (16, (14, 8, 6)),
    (17, (16, 14, 15)),
    (18, (16, 14, 8)),
    (19, (18, 16, 14)),
    (20, (18, 16, 19)),
    (21, (18, 16, 19)),
)
CART_INDICES = (8, 6, 14)
N_ATOMS = 22

# Circular dihedrals by z-matrix row: methyl rotors, phi/psi and peptide-adjacent
# rotations.
IND_CIRC_DIH = (0, 1, 2, 3, 4, 5, 8, 9, 10, 13, 15, 16)

# phi = C(4)-N(6)-CA(8)-C(14); psi = N(6)-CA(8)-C(14)-N(16).
PHI_ATOMS = (4, 6, 8, 14)
PSI_ATOMS = (6, 8, 14, 16)

_N_Z = len(Z_MATRIX)
_BOND_DIMS = [0, 1] + list(range(3, 3 + _N_Z))
_ANGLE_DIMS = [2] + list(range(3 + _N_Z, 3 + 2 * _N_Z))


def ca_signed_volume(pos: np.ndarray) -> np.ndarray:
    """Stereochemistry scalar at CA(8): (N6-CA) x (C14-CA) . (CB10-CA) for pos
    [..., 22, 3]; positive for L-alanine, negated by a mirror image."""
    ca, n, c, cb = pos[..., 8, :], pos[..., 6, :], pos[..., 14, :], pos[..., 10, :]
    return np.einsum("...i,...i->...", np.cross(n - ca, c - ca), cb - ca)


def _ideal_internal_coords(zmat: ZMatrixTransform) -> np.ndarray:
    """Starting internal coordinates for the minimisation: bond r0s,
    tetrahedral/trigonal angles, staggered dihedrals."""

    def bond_r0(i, j):
        ti, tj = ATOM_TYPES[i], ATOM_TYPES[j]
        return (BOND_PARAMS.get((ti, tj)) or BOND_PARAMS.get((tj, ti)))[1]

    s1, s2, s3 = zmat.cart_indices
    seed = [bond_r0(s2, s1), bond_r0(s3, s1), np.deg2rad(111.0)]
    bonds, angles, dihs = [], [], []
    group_count: Dict[Tuple[int, int], int] = {}
    for atom, (r1, r2, r3) in zmat.z_matrix:
        bonds.append(bond_r0(atom, r1))
        sp2 = ATOM_TYPES[r1] in ("C", "N")
        angles.append(np.deg2rad(120.0 if sp2 else 109.5))
        key = (r1, r2)
        n_prev = group_count.get(key, 0)
        group_count[key] = n_prev + 1
        if ATOM_TYPES[atom] in ("HC", "H1") and ATOM_TYPES[r1] == "CT":
            dih = 60.0 + 120.0 * n_prev  # staggered methyl hydrogens
        else:
            dih = 180.0 - 25.0 * n_prev  # extended backbone, offset siblings
        dihs.append(np.deg2rad(((dih + 180.0) % 360.0) - 180.0))
    return np.array(seed + bonds + angles + dihs)


class AldpBoltzmann(TargetDistribution):
    """``backend="jax"``, the value the configs carry, selects the force field on
    the target's device (here a torch one). ``backend="host_cpp"`` evaluates the
    potential and its forces with the C++ energy server on ``n_threads`` host threads
    (``system.n_threads``): each evaluation copies the positions to the host and the
    energies back, so a step on this backend synchronises with the device at every
    target evaluation. The server's tables are process-global (``native/``): the
    most recently constructed ``host_cpp`` target defines them, and a call through
    an older one installs its own again. The minimisation of the reference
    configuration uses the torch force field on either backend."""

    def __init__(
        self,
        data_path: Optional[str] = None,
        temperature: float = 1000.0,
        energy_cut: float = 1.0e8,
        energy_max: float = 1.0e20,
        transform: str = "internal",
        env: str = "vacuum",
        backend: str = "jax",
        n_threads: int = 4,
        minimise_steps: int = 4000,
        ind_circ_dih=IND_CIRC_DIH,
        dtype=torch.float32,
        device="cuda",
    ):
        if transform != "internal":
            raise NotImplementedError("only the internal transform is implemented")
        if env not in ("vacuum", "implicit"):
            raise NotImplementedError("This environment is not implemented.")
        if backend not in ("jax", "host_cpp"):
            raise ValueError(f"unknown backend {backend!r}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.env = env
        self.dim = 3 * N_ATOMS - 6
        self.temperature = temperature
        self.kT = KB_KCAL * temperature
        self.energy_cut = energy_cut  # in kT
        self.energy_max = energy_max
        self.backend = backend
        self.n_threads = n_threads
        self.tables = build_tables()

        zmat = ZMatrixTransform(n_atoms=N_ATOMS, z_matrix=Z_MATRIX, cart_indices=CART_INDICES)
        if data_path is not None:
            ref_cart = np.load(data_path).reshape(-1, N_ATOMS * 3)
        else:
            ref_cart = self._minimise(zmat, minimise_steps)
        # The potential is achiral: a D-form reference is as good a minimum as its
        # mirror image, so reflect it to L-alanine.
        pos = ref_cart.reshape(-1, N_ATOMS, 3)
        d_form = ca_signed_volume(pos) < 0.0
        if np.any(d_form):
            pos = pos.copy()
            pos[d_form, :, 0] *= -1.0
            ref_cart = pos.reshape(-1, N_ATOMS * 3)
        assert np.all(ca_signed_volume(ref_cart.reshape(-1, N_ATOMS, 3)) > 0.0)
        self.ref_cartesian = ref_cart
        self.transform = NormalizedInternalTransform.from_data(
            zmat,
            ref_cart,
            ind_circ_dih=ind_circ_dih,
            default_std={"bond": 0.05, "angle": 0.15, "dih": 0.2},  # Angstrom
        )
        if backend == "host_cpp":
            self._server = AldpEnergyServer(self.tables, n_threads=n_threads,
                                            gb=env == "implicit")

    # ------------------------------------------------------------------ energy

    def _potential_kcal(self, pos: torch.Tensor) -> torch.Tensor:
        """Potential [kcal/mol] for pos [..., N_ATOMS, 3]: the vacuum terms plus,
        for env='implicit', the GBSA-OBC2 solvation energy."""
        e = energy_kcal(self.tables, pos)
        if self.env == "implicit":
            e = e + gb_energy_kcal(self.tables, pos)
        return e

    def _minimise(self, zmat: ZMatrixTransform, steps: int) -> np.ndarray:
        """Gradient descent (lr 1e-4, gradient NaN-zeroed and clipped to +-1e3) from
        the idealised geometry, in the target's dtype on its device."""
        z0 = torch.tensor(_ideal_internal_coords(zmat), dtype=self.dtype, device=self.device)
        x0, _ = zmat.internal_to_cartesian(z0[None])
        x = x0.reshape(N_ATOMS, 3)
        lr = 1e-4
        for _ in range(steps):
            x = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self._potential_kcal(x), x)
            x = x.detach() - lr * torch.clamp(torch.nan_to_num(g), -1e3, 1e3)
        with torch.no_grad():
            e_final = float(self._potential_kcal(x))
        assert math.isfinite(e_final), "ALDP minimisation diverged"
        return x.detach().cpu().numpy().reshape(1, N_ATOMS * 3)

    def reduced_energy(self, x_cartesian: torch.Tensor) -> torch.Tensor:
        """Regularised potential in kT: u below the cut; cut + log(1 + u - cut) above;
        clamped at energy_max; NaN and +inf -> energy_max."""
        pos = x_cartesian.reshape(x_cartesian.shape[:-1] + (N_ATOMS, 3))
        if self.backend == "host_cpp":
            e_kcal = self._server.energy(pos)  # the whole potential, GB included
        else:
            e_kcal = self._potential_kcal(pos)
        u = e_kcal / self.kT
        u = torch.where(
            u < self.energy_cut, u, self.energy_cut + torch.log1p((u - self.energy_cut).abs())
        )
        u = torch.nan_to_num(u, nan=self.energy_max, posinf=self.energy_max)
        return torch.clamp(u, max=self.energy_max)

    # ------------------------------------------------------------------ density

    def _flow_index(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        cache = self.__dict__.setdefault("_index_cache", {})
        if device not in cache:
            cache[device] = (torch.tensor(_BOND_DIMS, device=device),
                             torch.tensor(_ANGLE_DIMS, device=device))
        return cache[device]

    def log_prob(self, z_flow: torch.Tensor) -> torch.Tensor:
        """Unnormalised Boltzmann log-density in normalised internal coords.

        Rows with an unphysical internal coordinate (a bond <= 1e-2 or an angle
        outside (1e-2, pi - 1e-2)) get -inf, computed on a configuration with those
        rows set to 0, so no NaN reaches the x-gradient."""
        mean, std, _ = self.transform._stats(z_flow)
        internal = z_flow * std + mean
        bond_dims, angle_dims = self._flow_index(z_flow.device)
        bonds = internal.index_select(-1, bond_dims)
        angles = internal.index_select(-1, angle_dims)
        valid = (bonds > 1e-2).all(-1) & ((angles > 1e-2) & (angles < math.pi - 1e-2)).all(-1)
        z_safe = torch.where(valid[..., None], z_flow, 0.0)
        x_cart, log_det = self.transform.flow_to_cartesian(z_safe)
        log_p = -self.reduced_energy(x_cart) + log_det
        return torch.where(valid, log_p, -math.inf)

    def phi_psi(self, z_flow: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Backbone dihedrals of flow-space samples (for the Ramachandran metrics)."""
        x_cart, _ = self.transform.flow_to_cartesian(z_flow)
        pos = x_cart.reshape(x_cart.shape[:-1] + (N_ATOMS, 3))
        phi = dihedral_angle(*[pos[..., a, :] for a in PHI_ATOMS])
        psi = dihedral_angle(*[pos[..., a, :] for a in PSI_ATOMS])
        return phi, psi

    def performance_metrics(self, samples, log_w, log_q_fn=None, batch_size=None,
                            mask=None, generator=None) -> Dict[str, torch.Tensor]:
        """None: the ALDP metrics are ``utils/aldp_eval.py:evaluate_aldp``."""
        return {}
