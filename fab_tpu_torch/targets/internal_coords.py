"""Z-matrix internal coordinates: Cartesian <-> internal with log-det
(``fab_tpu/targets/internal_coords.py``).

A z-matrix lists (atom, (bond_ref, angle_ref, dihedral_ref)) rows; three seed atoms
fix the rigid-body frame (seed 1 at the origin, seed 2 on +x, seed 3 in the xy
half-plane y > 0). The internal vector is

    [b1, b2, a2, bonds(n_z), angles(n_z), dihedrals(n_z)]   (3N - 6 dims)

and the log-det of d(cartesian)/d(internal) is log(b2) + sum(2 log(bond) +
log(sin(angle))). Placement is NeRF, vectorised by topological level: every row
whose references are placed moves in one gather and one scatter.

Gathers of atoms that several rows take (``gather_rows``) keep the gradient the same
on every call: ``index_select``'s backward adds a row's uses with atomics on the
card, in a different order each call, so no two steps through the force field
would repeat (and a captured step could not equal its eager twin).

``NormalizedInternalTransform`` standardises the non-circular coordinates with a
per-dim mean/std; circular dihedrals stay on [-pi, pi].
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable


class _GatherRows(torch.autograd.Function):
    """``p.index_select(-2, idx)`` whose backward sums each source row's uses in the
    order of ``uses``, through a gather (no atomics)."""

    @staticmethod
    def forward(ctx, p, idx, uses):
        ctx.save_for_backward(uses)
        return p.index_select(-2, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (uses,) = ctx.saved_tensors
        pad = grad.new_zeros(grad.shape[:-2] + (1, grad.shape[-1]))
        taken = torch.cat([grad, pad], -2).index_select(-2, uses.reshape(-1))
        return taken.reshape(grad.shape[:-2] + uses.shape + grad.shape[-1:]).sum(-2), None, None


def row_index(idx, n_rows: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gather_rows``'s index on ``device``: (idx, uses), ``uses[i]`` the positions of
    ``idx`` that take row i, in increasing order, padded with ``len(idx)`` (a zero
    row)."""
    idx = np.asarray(idx).reshape(-1)
    positions = [np.flatnonzero(idx == i) for i in range(n_rows)]
    uses = np.full((n_rows, max(1, max(map(len, positions)))), len(idx))
    for i, taken in enumerate(positions):
        uses[i, :len(taken)] = taken
    return (torch.as_tensor(idx, dtype=torch.long, device=device),
            torch.as_tensor(uses, dtype=torch.long, device=device))


def gather_rows(p: torch.Tensor, index: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """p[..., idx, :] for ``index = row_index(idx, ...)``, its gradient summed in a
    fixed order (the module docstring says why)."""
    return _GatherRows.apply(p, *index)


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.sqrt((v * v).sum(-1, keepdim=True)) + eps)


def dihedral_angle(p0, p1, p2, p3) -> torch.Tensor:
    """Signed dihedral of the chain p0-p1-p2-p3 in [-pi, pi], IUPAC sign."""
    b0 = p1 - p0
    b1 = p2 - p1
    b2 = p3 - p2
    n1 = torch.linalg.cross(b0, b1)
    n2 = torch.linalg.cross(b1, b2)
    m1 = torch.linalg.cross(n1, _normalize(b1))
    x = (n1 * n2).sum(-1)
    y = (m1 * n2).sum(-1)
    return torch.atan2(-y, x)


def bond_angle(p0, p1, p2) -> torch.Tensor:
    """Angle p0-p1-p2 in (0, pi)."""
    u = _normalize(p0 - p1)
    v = _normalize(p2 - p1)
    return torch.arccos(torch.clamp((u * v).sum(-1), -1.0, 1.0))


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as jnp.linalg.norm (sqrt of the sum of
    squares, so its gradient at 0 is not finite, as in fab_tpu)."""
    return torch.sqrt((v * v).sum(-1))


@dataclasses.dataclass(frozen=True)
class ZMatrixTransform:
    """Static z-matrix spec; every method is batched over leading axes."""

    n_atoms: int
    z_matrix: Tuple[Tuple[int, Tuple[int, int, int]], ...]
    cart_indices: Tuple[int, int, int]  # (origin, +x axis, xy-plane)

    @property
    def dim_internal(self) -> int:
        return 3 * self.n_atoms - 6

    @property
    def n_z(self) -> int:
        return len(self.z_matrix)

    def _index(self, device) -> dict:
        """The z-matrix's index tensors on ``device``, built once (indexing with a
        host list would copy it to the card on every call)."""
        cache = self.__dict__.setdefault("_index_cache", {})
        if device not in cache:
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)
            rows = lambda a: row_index(a, self.n_atoms, device)
            refs = np.asarray([r for _, r in self.z_matrix])
            levels = []
            for ks in self._placement_levels():
                level_refs = refs[list(ks)]
                levels.append((t(ks), t([self.z_matrix[k][0] for k in ks]),
                               *(rows(level_refs[:, j]) for j in range(3))))
            cache[device] = {
                "atoms": t([a for a, _ in self.z_matrix]),
                "refs": tuple(rows(refs[:, j]) for j in range(3)),
                "seeds": t(self.cart_indices[1:]),
                "levels": levels,
            }
        return cache[device]

    def cartesian_to_internal(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[..., n_atoms*3] cartesian -> ([..., 3N-6] internal, [...] log|d int / d cart|)
        of the gauge-fixed map."""
        pos = x.reshape(x.shape[:-1] + (self.n_atoms, 3))
        index = self._index(x.device)
        s1, s2, s3 = self.cart_indices
        b1 = _norm(pos[..., s2, :] - pos[..., s1, :])
        b2 = _norm(pos[..., s3, :] - pos[..., s1, :])
        a2 = bond_angle(pos[..., s2, :], pos[..., s1, :], pos[..., s3, :])
        p = pos.index_select(-2, index["atoms"])
        q1, q2, q3 = (gather_rows(pos, r) for r in index["refs"])
        bonds = _norm(p - q1)
        angles = bond_angle(p, q1, q2)
        dihs = dihedral_angle(p, q1, q2, q3)
        internal = torch.cat([torch.stack([b1, b2, a2], -1), bonds, angles, dihs], -1)
        log_det = -(
            torch.log(b2) + (2 * torch.log(bonds) + torch.log(torch.sin(angles))).sum(-1)
        )
        return internal, log_det

    def internal_to_cartesian(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[..., 3N-6] internal -> ([..., n_atoms*3] gauge-fixed cartesian,
        [...] log|d cart / d int|)."""
        n_z = self.n_z
        index = self._index(z.device)
        b1, b2, a2 = z[..., 0], z[..., 1], z[..., 2]
        bonds = z[..., 3 : 3 + n_z]
        angles = z[..., 3 + n_z : 3 + 2 * n_z]
        dihs = z[..., 3 + 2 * n_z :]

        batch_shape = z.shape[:-1]
        zero = torch.zeros_like(b1)
        pos = torch.zeros(batch_shape + (self.n_atoms, 3), dtype=z.dtype, device=z.device)
        seeds = torch.stack([
            torch.stack([b1, zero, zero], -1),
            torch.stack([b2 * torch.cos(a2), b2 * torch.sin(a2), zero], -1),
        ], -2)
        pos = pos.index_copy(-2, index["seeds"], seeds)
        for ks, atoms, r0, r1, r2 in index["levels"]:
            d = bonds.index_select(-1, ks)[..., None]
            theta = angles.index_select(-1, ks)[..., None]
            phi = dihs.index_select(-1, ks)[..., None]
            a_pos = gather_rows(pos, r0)
            b_pos = gather_rows(pos, r1)
            c_pos = gather_rows(pos, r2)
            bc = _normalize(a_pos - b_pos)
            n = _normalize(torch.linalg.cross(b_pos - c_pos, bc))
            m = torch.linalg.cross(n, bc)
            # The n-component's sign makes dihedral_angle(P, r1, r2, r3) == phi.
            d_vec = -d * torch.cos(theta) * bc + d * torch.sin(theta) * (
                torch.cos(phi) * m + torch.sin(phi) * n
            )
            pos = pos.index_copy(-2, atoms, a_pos + d_vec)
        log_det = torch.log(b2) + (
            2 * torch.log(bonds) + torch.log(torch.sin(angles))
        ).sum(-1)
        return pos.reshape(batch_shape + (self.n_atoms * 3,)), log_det

    def _placement_levels(self) -> Tuple[Tuple[int, ...], ...]:
        """Topological levels of z-matrix rows: within a level every row's
        references are placed by earlier levels."""
        placed = set(self.cart_indices)
        remaining = dict(enumerate(self.z_matrix))
        levels = []
        while remaining:
            level = [k for k in sorted(remaining) if all(r in placed for r in remaining[k][1])]
            if not level:
                raise ValueError("z-matrix has unresolvable reference ordering")
            for k in level:
                placed.add(remaining[k][0])
                del remaining[k]
            levels.append(tuple(level))
        return tuple(levels)


@dataclasses.dataclass(frozen=True)
class NormalizedInternalTransform:
    """Z-matrix transform composed with per-dim standardisation
    (``fab_tpu/targets/internal_coords.py:198-282``).

    Non-circular dims: z = (i - mean) / std. Circular dihedrals (mean 0, std 1) are
    wrapped to [-pi, pi). ``flow space`` -> internal -> cartesian; log-dets compose.
    """

    zmat: ZMatrixTransform
    mean: np.ndarray  # [dim_internal]
    std: np.ndarray  # [dim_internal]
    circular_dims: Tuple[int, ...]  # indices into the internal vector

    @classmethod
    def from_data(
        cls,
        zmat: ZMatrixTransform,
        cartesian_data: np.ndarray,
        ind_circ_dih: Sequence[int] = (),
        default_std: Dict[str, float] = None,
    ) -> "NormalizedInternalTransform":
        """Mean/std fitted on reference configurations; with fewer than 10 frames
        the std of each coordinate class comes from ``default_std``."""
        default_std = default_std or {"bond": 0.005, "angle": 0.15, "dih": 0.2}
        data = torch.as_tensor(np.asarray(cartesian_data)).reshape(-1, zmat.n_atoms * 3)
        internal, _ = zmat.cartesian_to_internal(data)
        internal = internal.numpy()
        mean = internal.mean(0)
        std = internal.std(0)
        n_z = zmat.n_z
        classes = ["bond", "bond", "angle"] + ["bond"] * n_z + ["angle"] * n_z + ["dih"] * n_z
        if internal.shape[0] < 10:
            std = np.array([default_std[c] for c in classes])
        circular = tuple(3 + 2 * n_z + int(i) for i in ind_circ_dih)
        for c_idx in circular:
            mean[c_idx] = 0.0
            std[c_idx] = 1.0
        return cls(zmat, mean, std, circular)

    @property
    def dim(self) -> int:
        return self.zmat.dim_internal

    @property
    def circular_flow_dims(self) -> Tuple[int, ...]:
        return self.circular_dims

    def _std_logdet(self) -> float:
        return float(np.sum(np.log(self.std)))

    def _stats(self, like: torch.Tensor):
        """(mean, std, circular mask) as tensors like ``like``, built once each."""
        key = (like.dtype, like.device)
        cache = self.__dict__.setdefault("_cache", {})
        if key not in cache:
            mask = np.zeros(self.dim, bool)
            mask[list(self.circular_dims)] = True
            cache[key] = (
                torch.tensor(self.mean, dtype=like.dtype, device=like.device),
                torch.tensor(self.std, dtype=like.dtype, device=like.device),
                torch.tensor(mask, device=like.device),
            )
        return cache[key]

    def _wrap_circular(self, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not self.circular_dims:
            return v
        wrapped = torch.remainder(v + np.pi, 2 * np.pi) - np.pi
        return torch.where(mask, wrapped, v)

    def flow_to_cartesian(self, z_flow: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalised flow coords -> cartesian; log-det of d cart / d flow."""
        mean, std, mask = self._stats(z_flow)
        internal = self._wrap_circular(z_flow * std + mean, mask)
        x, log_det = self.zmat.internal_to_cartesian(internal)
        return x, log_det + self._std_logdet()

    def cartesian_to_flow(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        internal, log_det = self.zmat.cartesian_to_internal(x)
        mean, std, mask = self._stats(x)
        z_flow = self._wrap_circular((internal - mean) / std, mask)
        return z_flow, log_det - self._std_logdet()
