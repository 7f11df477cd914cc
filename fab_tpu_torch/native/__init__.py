"""The host C++ energy server for ALDP (``fab_tpu/native/`` of the repository).

``csrc/aldp_energy.cpp`` evaluates the classical potential and its analytic forces
for a batch of configurations in float64, split across ``n_threads`` host threads
(spawned on every call). It is built with ``g++`` at first use into
``fab_tpu_torch/ops/_build/`` (``ops/build.py``: content-hashed name, atomic rename);
a failed build raises. The parameter tables and the GBSA-OBC2 constants come from
``targets/aldp_ff.py``, the torch force field's own source.

``AldpEnergyServer.energy(pos)`` is the differentiable entry: positions on any
device go to the host, and the energies come back in the input's dtype on its
device, so every call is a device -> host -> device round trip (a host sync). The
backward multiplies the saved -force by the incoming gradient; it is not itself
differentiable.

The library holds ONE process-global parameter set (tables and the GB flag), as
the repository's server does: constructing a server installs its tables and always
calls ``aldp_gb_init`` (a server with ``gb=False`` turns an earlier server's GB term
off), so the most recently constructed server defines the active potential. A call
through a server that is not the active one installs that server's tables again
first, so a server never evaluates another server's tables.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from fab_tpu_torch.ops import build as build_lib
from fab_tpu_torch.targets import aldp_ff as ff

SRC = pathlib.Path(__file__).parent / "csrc" / "aldp_energy.cpp"
N_ATOMS = 22


def build() -> pathlib.Path:
    """Compile the server with g++ (if its source changed) and return the library."""
    return build_lib.build(SRC, host=True)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    c_int_p = np.ctypeslib.ndpointer(np.int32, flags="C")
    c_dbl_p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.aldp_ff_init.restype = None
    lib.aldp_ff_init.argtypes = [
        ctypes.c_int, ctypes.c_int, c_int_p, c_dbl_p, c_dbl_p,
        ctypes.c_int, c_int_p, c_dbl_p, c_dbl_p,
        ctypes.c_int, c_int_p, c_dbl_p, c_int_p, c_dbl_p,
        ctypes.c_int, c_int_p, c_dbl_p, c_dbl_p, c_dbl_p,
        ctypes.c_int,
    ]
    lib.aldp_gb_init.restype = None
    lib.aldp_gb_init.argtypes = [
        ctypes.c_int, c_dbl_p, c_dbl_p, c_dbl_p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int,
    ]
    dbl_ptr = ctypes.POINTER(ctypes.c_double)
    lib.aldp_energy_batch.restype = None
    lib.aldp_energy_batch.argtypes = [dbl_ptr, ctypes.c_int, dbl_ptr, dbl_ptr]
    return lib


class AldpEnergyServer:
    """ctypes wrapper of the C++ batched energy/force evaluation; ``gb=True`` adds
    the GBSA-OBC2 implicit-solvent term. ``calls`` counts the batches evaluated, over
    every server."""

    calls = 0
    _active = None  # the server whose tables the library holds

    def __init__(self, tables: ff.AldpForceFieldTables, n_threads: int = 4,
                 gb: bool = False):
        self.lib = _library()
        self.tables = tables
        self.n_threads = int(n_threads)
        self.gb = bool(gb)
        self.n_atoms = N_ATOMS
        self.dim = 3 * N_ATOMS
        self._activate()

    def _activate(self) -> None:
        """Install this server's tables and GB flag in the library."""
        t, i32, f64 = self.tables, np.int32, np.float64
        arr = lambda a, dtype: np.ascontiguousarray(a, dtype)
        self.lib.aldp_ff_init(
            N_ATOMS,
            len(t.bond_k), arr(t.bond_idx, i32), arr(t.bond_k, f64), arr(t.bond_r0, f64),
            len(t.angle_k), arr(t.angle_idx, i32), arr(t.angle_k, f64),
            arr(t.angle_t0, f64),
            len(t.torsion_k), arr(t.torsion_idx, i32), arr(t.torsion_k, f64),
            arr(t.torsion_n, i32), arr(t.torsion_phase, f64),
            len(t.pair_qq), arr(t.pair_idx, i32), arr(t.pair_qq, f64),
            arr(t.pair_eps, f64), arr(t.pair_rmin, f64),
            self.n_threads,
        )
        self.lib.aldp_gb_init(
            N_ATOMS, arr(t.charges, f64), arr(t.gb_radius, f64), arr(t.gb_scale, f64),
            float(ff.GB_OFFSET), float(ff.COULOMB_CONST), float(ff.SOLUTE_DIELECTRIC),
            float(ff.SOLVENT_DIELECTRIC), float(ff.GB_PROBE), float(ff.GB_SA_FACTOR),
            float(ff.GB_ALPHA), float(ff.GB_BETA), float(ff.GB_GAMMA), int(self.gb),
        )
        AldpEnergyServer._active = self

    def energy_and_force(self, pos: np.ndarray, with_force: bool = True):
        """pos [B, 22, 3] (Angstrom) -> (energy [B] kcal/mol, force [B, 22, 3] or
        None), float64 numpy."""
        if AldpEnergyServer._active is not self:
            self._activate()
        pos = np.ascontiguousarray(pos.reshape(-1, self.dim), np.float64)
        batch = pos.shape[0]
        energy = np.empty(batch, np.float64)
        force = np.empty((batch, self.dim), np.float64) if with_force else None
        dbl_ptr = ctypes.POINTER(ctypes.c_double)
        self.lib.aldp_energy_batch(
            pos.ctypes.data_as(dbl_ptr), batch, energy.ctypes.data_as(dbl_ptr),
            force.ctypes.data_as(dbl_ptr) if with_force else None,
        )
        AldpEnergyServer.calls += 1
        return energy, (force.reshape(batch, N_ATOMS, 3) if with_force else None)

    def n_atoms_out(self) -> int:
        return N_ATOMS

    def energy(self, pos: torch.Tensor) -> torch.Tensor:
        """Differentiable energy: pos [..., 22, 3] -> [...] kcal/mol, in pos's dtype
        on its device; the gradient is the C++ server's -force."""
        return _HostEnergy.apply(pos, self)


class _HostEnergy(torch.autograd.Function):
    """Energy by the host server; the forward saves -force (only if pos needs a
    gradient), the backward is g[..., None, None] * (-force)."""

    @staticmethod
    def forward(ctx, pos, server):
        batch_shape = pos.shape[:-2]
        host = pos.detach().reshape(-1, N_ATOMS, 3).cpu().numpy()
        need_grad = ctx.needs_input_grad[0]
        e, f = server.energy_and_force(host, with_force=need_grad)
        like = dict(dtype=pos.dtype, device=pos.device)
        if need_grad:
            # Cast, then negate, as the repository's VJP does.
            ctx.save_for_backward(-torch.from_numpy(f).to(**like).reshape(pos.shape))
        return torch.from_numpy(e).to(**like).reshape(batch_shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (neg_force,) = ctx.saved_tensors
        return g[..., None, None] * neg_force, None
