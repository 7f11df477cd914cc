"""Classical force field for alanine dipeptide (ACE-ALA-NME, 22 atoms)
(``fab_tpu/targets/aldp_ff.py``).

AMBER-type functional forms with ff99-family parameters: harmonic bonds and angles,
periodic torsions and impropers, 12-6 Lennard-Jones and Coulomb with the 1-4
scalings and 1-2/1-3 exclusions, and for the implicit solvent the GBSA-OBC2 term
(OBC2 Born radii over the HCT descreening integral, the still-equation polar energy
and the ACE surface-area term). Units: kcal/mol and Angstrom.

The parameter tables, and the numpy code that assembles them, are this package's
own copy of ``fab_tpu``'s. The energies are batched torch code over [..., 22, 3]
positions, differentiable by autograd: the HMC leapfrog takes its x-gradient
through them.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import numpy as np
import torch

COULOMB_CONST = 332.0637  # kcal * Angstrom / (mol * e^2)
KB_KCAL = 0.0019872041  # kcal/mol/K
SCEE = 1.2  # 1-4 electrostatic divider (AMBER)
SCNB = 2.0  # 1-4 LJ divider (AMBER)

# Atom order of openmmtools' AlanineDipeptideVacuum (amber prmtop order), which the
# reference z-matrix indexes (aldp.py:66-88):
# 0 HH31 1 CH3 2 HH32 3 HH33 4 C 5 O | 6 N 7 H 8 CA 9 HA 10 CB 11 HB1 12 HB2 13 HB3
# 14 C 15 O | 16 N 17 H 18 CH3 19 HH31 20 HH32 21 HH33
ATOM_TYPES = [
    "HC", "CT", "HC", "HC", "C", "O",
    "N", "H", "CT", "H1", "CT", "HC", "HC", "HC",
    "C", "O",
    "N", "H", "CT", "H1", "H1", "H1",
]

CHARGES = np.array([
    0.1123, -0.3662, 0.1123, 0.1123, 0.5972, -0.5679,
    -0.4157, 0.2719, 0.0337, 0.0823, -0.1825, 0.0603, 0.0603, 0.0603,
    0.5973, -0.5679,
    -0.4157, 0.2719, -0.1490, 0.0976, 0.0976, 0.0976,
])

# LJ parameters per type: (Rmin/2 [A], epsilon [kcal/mol]) — parm99.
LJ_PARAMS = {
    "CT": (1.9080, 0.1094),
    "C": (1.9080, 0.0860),
    "O": (1.6612, 0.2100),
    "N": (1.8240, 0.1700),
    "H": (0.6000, 0.0157),
    "HC": (1.4870, 0.0157),
    "H1": (1.3870, 0.0157),
}

BONDS: Tuple[Tuple[int, int], ...] = (
    (0, 1), (1, 2), (1, 3), (1, 4), (4, 5), (4, 6), (6, 7), (6, 8), (8, 9),
    (8, 10), (10, 11), (10, 12), (10, 13), (8, 14), (14, 15), (14, 16),
    (16, 17), (16, 18), (18, 19), (18, 20), (18, 21),
)

# Bond force constants k [kcal/mol/A^2] (E = k (r - r0)^2) and r0 [A] — parm99.
BOND_PARAMS = {
    ("CT", "HC"): (340.0, 1.090),
    ("CT", "H1"): (340.0, 1.090),
    ("CT", "C"): (317.0, 1.522),
    ("C", "O"): (570.0, 1.229),
    ("C", "N"): (490.0, 1.335),
    ("N", "H"): (434.0, 1.010),
    ("N", "CT"): (337.0, 1.449),
    ("CT", "CT"): (310.0, 1.526),
}

# Angle force constants [kcal/mol/rad^2] and theta0 [deg] — parm99.
ANGLE_PARAMS = {
    ("HC", "CT", "HC"): (35.0, 109.50),
    ("H1", "CT", "H1"): (35.0, 109.50),
    ("HC", "CT", "C"): (50.0, 109.50),
    ("H1", "CT", "C"): (50.0, 109.50),
    ("HC", "CT", "CT"): (50.0, 109.50),
    ("H1", "CT", "CT"): (50.0, 109.50),
    ("H1", "CT", "N"): (50.0, 109.50),
    ("HC", "CT", "N"): (50.0, 109.50),
    ("CT", "C", "O"): (80.0, 120.40),
    ("CT", "C", "N"): (70.0, 116.60),
    ("O", "C", "N"): (80.0, 122.90),
    ("C", "N", "H"): (50.0, 120.00),
    ("C", "N", "CT"): (50.0, 121.90),
    ("H", "N", "CT"): (38.0, 118.04),
    ("N", "CT", "CT"): (80.0, 109.70),
    ("N", "CT", "C"): (63.0, 110.10),
    ("CT", "CT", "C"): (63.0, 111.10),
}

# Proper torsions: key -> list of (height [kcal/mol] (PK/IDIVF), periodicity,
# phase [deg]). "X" entries are wildcards; specific (ff99SB-style backbone) terms
# take precedence.
TORSION_PARAMS: Dict[Tuple[str, str, str, str], List[Tuple[float, int, float]]] = {
    ("X", "C", "N", "X"): [(2.5, 2, 180.0)],
    ("X", "CT", "N", "X"): [(0.0, 2, 0.0)],
    ("X", "CT", "C", "X"): [(0.0, 2, 0.0)],
    ("X", "CT", "CT", "X"): [(1.40 / 9.0, 3, 0.0)],
    # Backbone phi (C-N-CT-C) and psi (N-CT-C-N) specific terms (ff99SB):
    ("C", "N", "CT", "C"): [(0.27, 1, 0.0), (0.42, 2, 0.0), (0.40, 3, 0.0)],
    ("N", "CT", "C", "N"): [(0.45, 1, 180.0), (1.58, 2, 180.0), (0.55, 3, 180.0)],
    # H-N-CT-* and O-C-N-H amide terms:
    ("H", "N", "C", "O"): [(2.0, 1, 0.0), (2.5, 2, 180.0)],
}

# Impropers (i, j, center, l): E = k (1 + cos(2 phi - pi)).
IMPROPERS: Tuple[Tuple[Tuple[int, int, int, int], float], ...] = (
    ((1, 6, 4, 5), 10.5),  # ACE carbonyl planarity (X-X-C-O)
    ((8, 16, 14, 15), 10.5),  # ALA carbonyl planarity
    ((4, 8, 6, 7), 1.0),  # ALA amide N planarity (X-X-N-H)
    ((14, 18, 16, 17), 1.0),  # NME amide N planarity
)

# ---------------------------------------------------------------- GBSA (OBC2)
# Implicit solvent for env="implicit": the reference evaluates it through OpenMM's
# GBSAOBCForce (openmmtools AlanineDipeptideImplicit, fab/target_distributions/
# aldp.py:93-94). Implemented here: OBC2 effective Born radii (alpha=1, beta=0.8,
# gamma=4.85) over the HCT pairwise-descreening integral, the still-equation GB pair
# energy, and the ACE surface-area term — the exact functional forms of OpenMM's
# reference GBSA-OBC implementation, in kcal/mol and Angstrom.
GB_OFFSET = 0.09  # dielectric offset [A] (OpenMM: 0.009 nm)
GB_PROBE = 1.4  # solvent probe radius [A]
# OpenMM surfaceAreaEnergy = 28.3919551 kJ/mol/nm^2 -> kcal/mol/A^2.
GB_SA_FACTOR = 28.3919551 / 4.184 / 100.0
GB_ALPHA, GB_BETA, GB_GAMMA = 1.0, 0.8, 4.85  # OBC2
SOLVENT_DIELECTRIC = 78.5
SOLUTE_DIELECTRIC = 1.0

# mbondi2 intrinsic radii [A] (H on N: 1.3, other H: 1.2, C: 1.7, N: 1.55, O: 1.5)
# and OBC descreening scale factors by element (H .85, C .72, N .79, O .85).
_GB_RADII_BY_ELEMENT = {"H": 1.2, "C": 1.7, "N": 1.55, "O": 1.5}
_GB_SCALE_BY_ELEMENT = {"H": 0.85, "C": 0.72, "N": 0.79, "O": 0.85}


def _gb_params() -> Tuple[np.ndarray, np.ndarray]:
    neighbours = {i: set() for i in range(len(ATOM_TYPES))}
    for i, j in BONDS:
        neighbours[i].add(j)
        neighbours[j].add(i)
    radii, scales = [], []
    for i, t in enumerate(ATOM_TYPES):
        elem = "H" if t.startswith("H") else t[0]
        r = _GB_RADII_BY_ELEMENT[elem]
        if elem == "H" and any(ATOM_TYPES[j].startswith("N") for j in neighbours[i]):
            r = 1.3  # mbondi2: H bonded to N
        radii.append(r)
        scales.append(_GB_SCALE_BY_ELEMENT[elem])
    return np.array(radii), np.array(scales)


def _build_topology():
    """Derive angles, torsions, and exclusion classes from the bond graph."""
    n = len(ATOM_TYPES)
    adj = {i: set() for i in range(n)}
    for i, j in BONDS:
        adj[i].add(j)
        adj[j].add(i)
    angles = []
    for j in range(n):
        for i, k in itertools.combinations(sorted(adj[j]), 2):
            angles.append((i, j, k))
    torsions = []
    for j, k in BONDS:
        for i in adj[j] - {k}:
            for l in adj[k] - {j}:
                if i != l:
                    torsions.append((i, j, k, l))
    # Exclusions: 1-2 and 1-3 fully excluded; 1-4 scaled.
    pairs12 = {frozenset(b) for b in BONDS}
    pairs13 = {frozenset((i, k)) for (i, j, k) in angles}
    pairs14 = set()
    for (i, j, k, l) in torsions:
        key = frozenset((i, l))
        if key not in pairs12 and key not in pairs13:
            pairs14.add(key)
    return angles, torsions, pairs12, pairs13, pairs14


def _lookup_bond(ti, tj):
    return BOND_PARAMS.get((ti, tj)) or BOND_PARAMS[(tj, ti)]


def _lookup_angle(ti, tj, tk):
    return ANGLE_PARAMS.get((ti, tj, tk)) or ANGLE_PARAMS[(tk, tj, ti)]


def _lookup_torsion(ti, tj, tk, tl):
    for key in [
        (ti, tj, tk, tl),
        (tl, tk, tj, ti),
        ("X", tj, tk, "X"),
        ("X", tk, tj, "X"),
    ]:
        if key in TORSION_PARAMS:
            return TORSION_PARAMS[key]
    return [(0.0, 2, 0.0)]


@dataclasses.dataclass(frozen=True)
class AldpForceFieldTables:
    """Flat numpy parameter tables."""

    bond_idx: np.ndarray  # [NB, 2]
    bond_k: np.ndarray
    bond_r0: np.ndarray
    angle_idx: np.ndarray  # [NA, 3]
    angle_k: np.ndarray
    angle_t0: np.ndarray
    torsion_idx: np.ndarray  # [NT, 4]
    torsion_k: np.ndarray
    torsion_n: np.ndarray
    torsion_phase: np.ndarray
    pair_idx: np.ndarray  # [NP, 2] nonbonded pairs (excl. 1-2/1-3)
    pair_qq: np.ndarray  # scaled charge products * coulomb const
    pair_eps: np.ndarray
    pair_rmin: np.ndarray
    charges: np.ndarray  # [N] partial charges [e] (GB uses the UNSCALED full set)
    gb_radius: np.ndarray  # [N] mbondi2 intrinsic radii [A]
    gb_scale: np.ndarray  # [N] OBC descreening scale factors


def build_tables() -> AldpForceFieldTables:
    types = ATOM_TYPES
    angles, torsions, p12, p13, p14 = _build_topology()

    bond_idx = np.array(BONDS)
    bk, br = zip(*[_lookup_bond(types[i], types[j]) for i, j in BONDS])

    angle_idx = np.array(angles)
    ak, at = zip(*[_lookup_angle(types[i], types[j], types[k]) for i, j, k in angles])

    t_idx, t_k, t_n, t_ph = [], [], [], []
    for (i, j, k, l) in torsions:
        for height, per, phase in _lookup_torsion(
            types[i], types[j], types[k], types[l]
        ):
            if height == 0.0:
                continue
            t_idx.append((i, j, k, l))
            t_k.append(height)
            t_n.append(per)
            t_ph.append(np.deg2rad(phase))
    for (quad, k) in IMPROPERS:
        t_idx.append(quad)
        t_k.append(k)
        t_n.append(2)
        t_ph.append(np.pi)

    n = len(types)
    pair_idx, pair_qq, pair_eps, pair_rmin = [], [], [], []
    for i in range(n):
        for j in range(i + 1, n):
            key = frozenset((i, j))
            if key in p12 or key in p13:
                continue
            scale_q = 1.0 / SCEE if key in p14 else 1.0
            scale_lj = 1.0 / SCNB if key in p14 else 1.0
            rmin_i, eps_i = LJ_PARAMS[types[i]]
            rmin_j, eps_j = LJ_PARAMS[types[j]]
            pair_idx.append((i, j))
            pair_qq.append(COULOMB_CONST * CHARGES[i] * CHARGES[j] * scale_q)
            pair_eps.append(np.sqrt(eps_i * eps_j) * scale_lj)
            pair_rmin.append(rmin_i + rmin_j)

    gb_radius, gb_scale = _gb_params()
    return AldpForceFieldTables(
        bond_idx=bond_idx,
        bond_k=np.array(bk),
        bond_r0=np.array(br),
        angle_idx=angle_idx,
        angle_k=np.array(ak),
        angle_t0=np.deg2rad(np.array(at)),
        torsion_idx=np.array(t_idx),
        torsion_k=np.array(t_k),
        torsion_n=np.array(t_n),
        torsion_phase=np.array(t_ph),
        pair_idx=np.array(pair_idx),
        pair_qq=np.array(pair_qq),
        pair_eps=np.array(pair_eps),
        pair_rmin=np.array(pair_rmin),
        charges=CHARGES.copy(),
        gb_radius=gb_radius,
        gb_scale=gb_scale,
    )


def _device_tables(tables: AldpForceFieldTables, like: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The tables as tensors in ``like``'s dtype and on its device, built once per
    (dtype, device): index arrays as int64 (and each column of one as a
    ``gather_rows`` index, ``<name>_<column>``), parameters as floats."""
    from fab_tpu_torch.targets.internal_coords import row_index

    cache = tables.__dict__.setdefault("_device_cache", {})
    key = (like.dtype, like.device)
    if key not in cache:
        out = {}
        for field in dataclasses.fields(tables):
            a = getattr(tables, field.name)
            if field.name.endswith("_idx"):
                out[field.name] = torch.as_tensor(a, dtype=torch.long, device=like.device)
                for j in range(np.asarray(a).shape[1]):
                    out[f"{field.name}_{j}"] = row_index(np.asarray(a)[:, j],
                                                         len(tables.charges), like.device)
            else:
                out[field.name] = torch.as_tensor(np.asarray(a, np.float64), device=like.device).to(like.dtype)
        n = len(tables.charges)
        out["eye"] = torch.eye(n, dtype=torch.bool, device=like.device)
        cache[key] = out
    return cache[key]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def energy_kcal(tables: AldpForceFieldTables, pos_angstrom: torch.Tensor) -> torch.Tensor:
    """Total vacuum potential energy [kcal/mol]; pos [..., 22, 3] in Angstrom."""
    from fab_tpu_torch.targets.internal_coords import bond_angle, dihedral_angle, gather_rows

    t = _device_tables(tables, pos_angstrom)
    p = pos_angstrom
    atoms = lambda name, j: gather_rows(p, t[f"{name}_idx_{j}"])
    r = _norm(atoms("bond", 0) - atoms("bond", 1))
    e_bond = (t["bond_k"] * (r - t["bond_r0"]) ** 2).sum(-1)

    theta = bond_angle(atoms("angle", 0), atoms("angle", 1), atoms("angle", 2))
    e_angle = (t["angle_k"] * (theta - t["angle_t0"]) ** 2).sum(-1)

    phi = dihedral_angle(*(atoms("torsion", j) for j in range(4)))
    e_torsion = (
        t["torsion_k"] * (1.0 + torch.cos(t["torsion_n"] * phi - t["torsion_phase"]))
    ).sum(-1)

    inv = 1.0 / _norm(atoms("pair", 0) - atoms("pair", 1))
    e_coul = (t["pair_qq"] * inv).sum(-1)
    x6 = (t["pair_rmin"] * inv) ** 6
    e_lj = (t["pair_eps"] * (x6**2 - 2.0 * x6)).sum(-1)
    return e_bond + e_angle + e_torsion + e_coul + e_lj


def born_radii(tables: AldpForceFieldTables, pos_angstrom: torch.Tensor) -> torch.Tensor:
    """OBC2 effective Born radii [A] for pos [..., N, 3]: the HCT pairwise
    descreening integral and the OBC tanh rescaling (OpenMM's reference
    GBSA-OBC formulation)."""
    t = _device_tables(tables, pos_angstrom)
    p = pos_angstrom
    radius = t["gb_radius"]  # intrinsic [N]
    rho = radius - GB_OFFSET  # offset radii
    sr = t["gb_scale"] * rho  # scaled descreening radii
    eye = t["eye"]

    diff = p[..., :, None, :] - p[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    d = torch.sqrt(torch.where(eye, 1.0, d2))  # diagonal guarded (masked out below)

    rho_i = rho[:, None]
    sr_j = sr[None, :]
    # Pair (i, j) contributes iff atom j's descreening sphere reaches atom i.
    active = (rho_i < d + sr_j) & ~eye
    d_safe = torch.where(active, d, 1.0)
    upper = 1.0 / (d_safe + sr_j)
    lower = 1.0 / torch.maximum(rho_i, (d_safe - sr_j).abs())
    l2, u2 = lower * lower, upper * upper
    term = (
        lower
        - upper
        + 0.25 * d_safe * (u2 - l2)
        + (0.5 / d_safe) * torch.log(upper / lower)
        + (0.25 * sr_j * sr_j / d_safe) * (l2 - u2)
    )
    # Atom i fully inside j's descreening sphere:
    term = term + torch.where(rho_i < sr_j - d_safe, 2.0 * (1.0 / rho_i - lower), 0.0)
    integral = torch.where(active, term, 0.0).sum(-1)  # [..., N]

    psi = 0.5 * integral * rho
    psi2 = psi * psi
    born_inv = 1.0 / rho - torch.tanh(
        GB_ALPHA * psi - GB_BETA * psi2 + GB_GAMMA * psi2 * psi
    ) / radius
    return 1.0 / born_inv


def gb_energy_kcal(tables: AldpForceFieldTables, pos_angstrom: torch.Tensor) -> torch.Tensor:
    """GBSA-OBC2 solvation energy [kcal/mol]: the still-equation polar term and
    the ACE non-polar surface-area term."""
    t = _device_tables(tables, pos_angstrom)
    p = pos_angstrom
    q = t["charges"]
    radius = t["gb_radius"]
    rb = born_radii(tables, p)  # [..., N]

    diff = p[..., :, None, :] - p[..., None, :, :]
    d2 = (diff * diff).sum(-1)  # diagonal is exactly 0 -> f_ii = R_i
    rbij = rb[..., :, None] * rb[..., None, :]
    f_gb = torch.sqrt(d2 + rbij * torch.exp(-d2 / (4.0 * rbij)))
    pre = -0.5 * COULOMB_CONST * (1.0 / SOLUTE_DIELECTRIC - 1.0 / SOLVENT_DIELECTRIC)
    qq = q[:, None] * q[None, :]
    # Sum over all ordered pairs, the diagonal included: self terms once, cross
    # terms twice.
    e_polar = pre * (qq / f_gb).sum((-2, -1))
    e_sa = GB_SA_FACTOR * ((radius + GB_PROBE) ** 2 * (radius / rb) ** 6).sum(-1)
    return e_polar + e_sa
