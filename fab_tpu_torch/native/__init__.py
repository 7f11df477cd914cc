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

**Inside a compiled program** (``graph.Program``; ``fab_tpu``'s ``pure_callback``
inside its jit) the round trip cannot read the device on the host. There, under
``host_calls(plan)``, each server call is three steps on the current stream: the f64
positions copied into a pinned buffer (``cuMemcpyDtoHAsync``), the C host function
``aldp_energy_host_fn`` launched on them (``cuLaunchHostFunc``; it makes no CUDA
call and never takes the GIL), and the energy and force copied back
(``cuMemcpyHtoDAsync``). The warm-up enqueues them, a capture records them as
memcpy, host and memcpy nodes. ``HostCalls`` holds one set of buffers per call site,
recorded in call order by the first run; a later run that calls differently raises.
The program installs its server's tables before each replay; installing another
server's tables first waits for the host functions already enqueued. On the CPU
the same plan calls the host function directly. Either way the host function runs
the C++ of an eager call on the same f64 positions, so the energies are equal bit
for bit.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import pathlib
from typing import List, Optional

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
    lib.aldp_energy_host_fn.restype = None
    lib.aldp_energy_host_fn.argtypes = [ctypes.c_void_p]
    return lib


class HostArgs(ctypes.Structure):
    """``AldpHostArgs`` of ``csrc/aldp_energy.cpp``: the host function's buffers."""

    _fields_ = [("pos", ctypes.c_void_p), ("energy", ctypes.c_void_p),
                ("force", ctypes.c_void_p), ("batch", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    """libcuda, as torch loaded it: stream-ordered copies and host functions through
    its C API, without a second CUDA runtime."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuLaunchHostFunc.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    cu.cuMemcpyDtoHAsync_v2.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_size_t,
                                        ctypes.c_void_p]
    cu.cuMemcpyHtoDAsync_v2.argtypes = [ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p]
    return cu


def _check(result: int, call: str) -> None:
    if result != 0:
        raise RuntimeError(f"{call} failed: CUresult {result}")


# Devices with host functions enqueued since the tables were last installed.
_ENQUEUED = set()


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
        """Install this server's tables and GB flag in the library, once the host
        functions already enqueued have run on the tables they were given."""
        for device in _ENQUEUED:
            torch.cuda.synchronize(device)
        _ENQUEUED.clear()
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

    def __deepcopy__(self, memo) -> "AldpEnergyServer":
        """A server is a handle on the library's one parameter set: a deep copy of a
        model that holds it shares it."""
        return self

    def n_atoms_out(self) -> int:
        return N_ATOMS

    def energy(self, pos: torch.Tensor) -> torch.Tensor:
        """Differentiable energy: pos [..., 22, 3] -> [...] kcal/mol, in pos's dtype
        on its device; the gradient is the C++ server's -force."""
        return _HostEnergy.apply(pos, self)


class _Site:
    """One server call of a program: its server, batch and whether it returns forces,
    its f64 buffers (pinned on the card) and the host function's arguments."""

    def __init__(self, server: AldpEnergyServer, batch: int, with_force: bool,
                 device: torch.device):
        new = lambda *shape: torch.empty(shape, dtype=torch.float64,
                                         pin_memory=device.type == "cuda")
        self.server, self.batch, self.with_force = server, batch, with_force
        self.pos = new(batch, 3 * N_ATOMS)
        self.energy = new(batch)
        self.force = new(batch, 3 * N_ATOMS) if with_force else None
        self.args = HostArgs(self.pos.data_ptr(), self.energy.data_ptr(),
                             self.force.data_ptr() if with_force else None, batch)

    def key(self) -> tuple:
        """What a later run's call at this site must match."""
        return self.server, self.batch, self.with_force


class HostCalls:
    """The server calls of one compiled program, in call order: ``sites`` holds one
    ``_Site`` per call, recorded by the first run (``begin`` ... ``end``); each later
    run must make the same calls (server, batch, forces or not) and raises at the
    first that differs. One program calls one server: a graph cannot switch the
    library's tables between its host nodes."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.sites: List[_Site] = []
        self.recorded = False
        self._cursor = 0

    @property
    def server(self) -> Optional[AldpEnergyServer]:
        return self.sites[0].server if self.sites else None

    def activate(self) -> None:
        """Install the program's server's tables (before a replay)."""
        if self.sites and AldpEnergyServer._active is not self.server:
            self.server._activate()

    def begin(self) -> None:
        self._cursor = 0

    def end(self) -> None:
        if self._cursor != len(self.sites):
            raise RuntimeError(f"the program made {self._cursor} server calls, its plan "
                               f"{len(self.sites)}")
        self.recorded = True

    def _site(self, server: AldpEnergyServer, batch: int, with_force: bool) -> _Site:
        call = (server, batch, with_force)
        if self.recorded:
            have = self.sites[self._cursor].key() if self._cursor < len(self.sites) else None
            if have != call:
                raise RuntimeError(f"the program's server calls changed: call {self._cursor} "
                                   f"is (batch {batch}, forces {with_force}) on {server!r}, "
                                   f"its plan has {have}")
        else:
            if self.sites and server is not self.server:
                raise RuntimeError("one compiled program calls two energy servers; the "
                                   "library holds one server's tables at a time")
            self.sites.append(_Site(server, batch, with_force, self.device))
        self._cursor += 1
        return self.sites[self._cursor - 1]

    def call(self, server: AldpEnergyServer, pos: torch.Tensor, with_force: bool):
        """pos [B, 66] f64 on the program's device -> (energy [B], force [B, 66] or
        None), f64 on that device, enqueued on the current stream (see the module
        docstring)."""
        site = self._site(server, pos.shape[0], with_force)
        if AldpEnergyServer._active is not server:
            server._activate()
        AldpEnergyServer.calls += 1
        if self.device.type != "cuda":
            site.pos.copy_(pos)
            server.lib.aldp_energy_host_fn(ctypes.byref(site.args))
            return site.energy.clone(), (site.force.clone() if with_force else None)
        cu, stream = _libcuda(), torch.cuda.current_stream(self.device).cuda_stream
        pos = pos.contiguous()
        _check(cu.cuMemcpyDtoHAsync_v2(site.pos.data_ptr(), pos.data_ptr(),
                                       pos.numel() * 8, stream), "cuMemcpyDtoHAsync")
        host_fn = ctypes.cast(server.lib.aldp_energy_host_fn, ctypes.c_void_p)
        _check(cu.cuLaunchHostFunc(stream, host_fn, ctypes.addressof(site.args)),
               "cuLaunchHostFunc")
        _ENQUEUED.add(self.device)
        out = []
        for host in (site.energy, site.force if with_force else None):
            if host is None:
                out.append(None)
                continue
            dev = torch.empty(host.shape, dtype=torch.float64, device=self.device)
            _check(cu.cuMemcpyHtoDAsync_v2(dev.data_ptr(), host.data_ptr(), host.numel() * 8,
                                           stream), "cuMemcpyHtoDAsync")
            out.append(dev)
        return tuple(out)


_PLAN: Optional[HostCalls] = None


@contextlib.contextmanager
def host_calls(plan: HostCalls):
    """Within, every server call goes through ``plan`` (a compiled program's run); a
    run that ends without error completes or matches it."""
    global _PLAN
    saved, _PLAN = _PLAN, plan
    plan.begin()
    try:
        yield plan
        plan.end()
    finally:
        _PLAN = saved


class _HostEnergy(torch.autograd.Function):
    """Energy by the host server; the forward saves -force (only if pos needs a
    gradient), the backward is g[..., None, None] * (-force). Inside a program
    (``host_calls``) the call goes through its plan, with no host read."""

    @staticmethod
    def forward(ctx, pos, server):
        batch_shape = pos.shape[:-2]
        need_grad = ctx.needs_input_grad[0]
        if _PLAN is not None:
            e, f = _PLAN.call(server, pos.detach().reshape(-1, 3 * N_ATOMS).to(torch.float64),
                              need_grad)
        else:
            host = pos.detach().reshape(-1, N_ATOMS, 3).cpu().numpy()
            e, f = server.energy_and_force(host, with_force=need_grad)
            e, f = torch.from_numpy(e), (torch.from_numpy(f) if need_grad else None)
        like = dict(dtype=pos.dtype, device=pos.device)
        if need_grad:
            # Cast, then negate, as the repository's VJP does.
            ctx.save_for_backward(-f.to(**like).reshape(pos.shape))
        return e.to(**like).reshape(batch_shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (neg_force,) = ctx.saved_tensors
        return g[..., None, None] * neg_force, None
