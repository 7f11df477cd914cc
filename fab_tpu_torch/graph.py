"""Compiled programs: a function of a state and a key captured as a CUDA graph and
replayed (``fab_tpu``'s ``jax.jit`` of its train step, ``fab_tpu/train.py:226-245``;
of its buffer fill, ``:441-452`` and ``:603-620``; of the ALDP ML step,
``experiments/run_aldp.py:148-167``).

``Program(fn, module, device)`` runs ``fn(state, key) -> (state, info)`` eagerly on
static tensors, so the graph replays exactly the kernels the eager function
launches. ``module`` holds the tensors ``fn`` moves in place (the flow's parameters
and buffers). Three users go through it: ``StepProgram`` (``make_train_step`` and
``make_scanned_train_step``), the buffer trainers' fill pass (``train.py``) and
the ALDP ML step (``experiments/run_aldp.py``).

- **State.** The state's tensors (a train state's transition state, Adam's count
  and moments and buffer; a fill pass's transition state and buffer) are copied once
  into static tensors; the module's tensors are static already (``fn`` updates them
  in place). At the end of each call the new state is copied back into the static
  one (the buffer's ``index_put`` is out of place), so a call's input is the last
  one's output. The state a call returns holds those static tensors: the next call
  overwrites them, as a donated buffer is gone after a jitted call in ``fab_tpu``.
- **Noise.** ``fn`` draws through a ``random.Tape`` (see ``random.py``): each call
  first replays the tape on the caller's generator (the *noise pass*), then runs
  ``fn``, which reads its draws from the tape's static tensors. The draws are the
  eager function's, bit for bit.
- **Build.** The first call runs ``fn`` once eagerly, recording the tape (on the
  card on a side stream, so cuBLAS, NCCL's communicator and the allocator are set up
  before capture, and every cache a module builds on first use is built then),
  restores every module and state tensor it moved, and, on the card, captures one
  call into a ``torch.cuda.CUDAGraph`` (with the kernels' host caches emptied first,
  so the graph rebuilds K2's prepared weights where a steady-state eager call does).
  Python's cyclic collector is off during the capture (``collector_paused``): a
  collection then could free an earlier program's graph or a process group, whose
  CUDA calls invalidate the capture. On the CPU there is no graph: every call runs
  ``fn`` through the same static tensors and tape. A capture or replay that fails
  raises; nothing falls back to the eager function.
- **Host draws.** A draw whose count depends on the data (ManyWell's and
  DoubleWell's rejection sampling) or that draws outside ``random`` (a wrapped
  torch distribution) is one ``random.host_draw`` op of the tape: it runs in the
  noise pass, on the host, before each call, so the graph holds none of it.
- **Host calls.** The C++ energy server (``system.backend: host_cpp``) is called
  through ``native.HostCalls``: pinned copies and a C host function on the stream,
  recorded as memcpy and host nodes (``fab_tpu``'s ``pure_callback``). Each call
  first installs the program's server's tables.
- **Global generators.** ``fn`` must draw through ``random`` only. A module that
  draws from torch's default CPU or CUDA generator would replay the capture's noise;
  the build compares their states across the warm-up and raises ``ValueError``,
  naming the module, before any capture.
- **Counts.** The kernels' wrappers, the mesh's collectives (``mesh.COUNTS``) and the
  energy server (``AldpEnergyServer.calls``, as "server calls") count on the host,
  which a replay does not reach: ``captured_counts`` holds what one captured call
  counted and ``replays`` the calls since (on the CPU, the eager runs of ``fn``), so
  the replays launched ``captured_counts`` times ``replays`` beside what the
  counters saw themselves (warm-up and capture).

``graph_supported(trainer)`` (``supported(model, device)``) is the static test of
which configurations take this path, decided from the configuration before any
capture; the others keep the eager functions, for the reason it gives.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from fab_tpu_torch import native, random
from fab_tpu_torch.flows.fused import FusedPass
from fab_tpu_torch.ops import coupling_kernel, realnvp_kernel
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.wrappers.module import WrappedModuleFlow
from fab_tpu_torch.wrappers.torch_dist import WrappedTorchDist

# Why a configuration keeps the eager functions (ROADMAP "Also open").
REFUSED = {
    "model_axis": "a mesh with a model axis (n_model > 1): one card cannot form an NCCL "
                  "model group (NCCL refuses two ranks on one device), and the gloo grid "
                  "that runs there cannot be captured",
    "gloo_on_card": "a data mesh over gloo on the card: gloo carries the CUDA tensors "
                    "through the host, which no CUDA graph can hold",
}
# A wrapped distribution that validates its arguments reads a device boolean on the
# host in every log_prob; the check is kept, so on the card the configuration stays
# eager (on the CPU the program runs eagerly and the check with it).
VALIDATING = ("a wrapped torch distribution that validates its arguments (validate_args): "
              "the check reads the device on the host, which no CUDA graph can hold; "
              "build it with validate_args=False to compile")


def _validates(dist) -> bool:
    """Whether ``dist`` or a distribution inside it (a mixture's components, an
    ``Independent``'s base) validates its arguments."""
    if not isinstance(dist, torch.distributions.Distribution):
        return False
    return bool(dist._validate_args) or any(_validates(v) for v in vars(dist).values())


def supported(model, device) -> Tuple[bool, str]:
    """(whether ``model``'s functions on ``device`` run as compiled programs under
    the active mesh, why): decided from the configuration alone, before any
    capture."""
    device = torch.device(device)
    active = mesh.active_mesh()
    if active is not None and active.n_model > 1:
        return False, REFUSED["model_axis"]
    if device.type == "cuda" and any(isinstance(part, WrappedTorchDist) and _validates(part.dist)
                                     for part in (model.flow, model.target)):
        return False, VALIDATING
    collectives = ""
    if active is not None:
        backend = dist.get_backend(active.data_group)
        if device.type == "cuda" and backend != "nccl":
            return False, REFUSED["gloo_on_card"]
        collectives = f", its {backend} collectives over {active.n_data} data ranks within"
    if device.type == "cuda":
        return True, f"captured as a CUDA graph on {device}{collectives}, replayed"
    return True, (f"no CUDA graph on {device}: each call runs eagerly through the same "
                  f"static tensors and noise tape{collectives}")


def graph_supported(trainer) -> Tuple[bool, str]:
    """(whether ``trainer``'s ``run`` and fill go through compiled programs, why):
    ``supported`` of its model on its device."""
    return supported(trainer.model, trainer.device)


def counts() -> Dict[str, int]:
    """The kernels' host counters: K1's launches and backward recomputes, K2's
    launches, recomputes and prepared-weight rebuilds."""
    return {
        "k1": realnvp_kernel.fused_realnvp_pass.launches,
        "k1_recomputes": FusedPass.recomputes,
        "k2": coupling_kernel.fused_coupling_apply.launches,
        "k2_recomputes": coupling_kernel.FusedCoupling.recomputes,
        "k2_rebuilds": coupling_kernel.prepared_weight.rebuilds,
    }


def _host_counts() -> Dict[str, int]:
    """``counts()``, the mesh's collectives as ``"<axis> <kind>"`` and the energy
    server's calls."""
    return dict(counts(), **{f"{axis} {kind}": n for (axis, kind), n in mesh.COUNTS.items()},
                **{"server calls": native.AldpEnergyServer.calls})


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic garbage collector off within, as it was after. A collection
    inside a capture runs the finalizers of whatever dead cycles it finds (an earlier
    program's ``CUDAGraph``, a process group); their CUDA calls are not allowed while
    a stream captures, and the capture ends invalidated."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _ordered(tree):
    """``tree`` with every dict's keys sorted."""
    if isinstance(tree, dict):
        return {k: _ordered(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_ordered(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_ordered(v) for v in tree)
    return tree


def _flatten(tree):
    """``pytree.tree_flatten`` of ``tree`` with every dict's keys sorted (as JAX
    flattens a dict), so states whose dicts differ in key order alone share one
    structure."""
    return pytree.tree_flatten(_ordered(tree))


def _like(tree, template):
    """``tree`` with every dict's keys in ``template``'s order."""
    if isinstance(tree, dict):
        return {k: _like(tree[k], template[k]) for k in template}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_like(a, b) for a, b in zip(tree, template)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(a, b) for a, b in zip(tree, template))
    return tree


def _module_tensors(module: nn.Module) -> List[torch.Tensor]:
    """Every parameter and buffer of ``module`` (persistent or not), once each."""
    return [*module.parameters(), *module.buffers()]


class Program:
    """``fn(state, key) -> (state, info)`` on static tensors, captured as a CUDA graph
    on the card (see the module docstring); ``module`` holds the tensors ``fn``
    moves in place. ``__call__(state, generator, n)`` makes n calls."""

    def __init__(self, fn: Callable, module: nn.Module, device):
        self.fn, self.module = fn, module
        self.device = torch.device(device)
        self.tape = random.Tape(self.device)
        self.host_calls = native.HostCalls(self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: Optional[List[torch.Tensor]] = None
        self.replays = 0
        self.captured_counts: Dict[str, int] = {}
        self.capture_s = self.instantiate_s = None
        self.pool_bytes = None
        self._module_tensors = _module_tensors(module)

    def _run(self) -> Dict[str, Any]:
        """``fn`` on the static state, its draws served by the tape, and its new state
        copied into the static one. Returns its info."""
        state = _like(pytree.tree_unflatten(self.static, self._spec), self._in)
        with random.taped(self.tape) as key, native.host_calls(self.host_calls):
            new_state, info = self.fn(state, key)
        new, spec = _flatten(new_state)
        assert spec == self._spec, "the program changed its state's structure"
        # The structure ``fn`` returns, dicts in its order, for the states handed out.
        self._out = pytree.tree_map(lambda _: None, new_state)
        static_storage = {_storage(t) for t in self.static}
        # Info that aliases the state would read the new state after the copy back.
        info = pytree.tree_map(
            lambda v: v.clone() if torch.is_tensor(v) and _storage(v) in static_storage else v,
            info)
        # A new leaf that aliases another static tensor is read before it is written.
        new = [t.clone() if _storage(t) in static_storage and _storage(t) != _storage(s)
               else t for t, s in zip(new, self.static)]
        with torch.no_grad():
            for s, t in zip(self.static, new):
                if t.data_ptr() != s.data_ptr():
                    s.copy_(t)
        return info

    def _build(self, state) -> None:
        leaves, self._spec = _flatten(state)
        assert all(torch.is_tensor(t) for t in leaves), "a program's state holds tensors only"
        # The first state's structure, dicts in the caller's order, as ``fn`` sees it.
        self._in = pytree.tree_map(lambda _: None, state)
        self.static = [t.detach().clone() for t in leaves]
        saved = [t.detach().clone() for t in self._module_tensors]
        cuda = self.device.type == "cuda"
        generators = [torch.default_generator] + (
            [torch.cuda.default_generators[self.device.index if self.device.index is not None
                                           else torch.cuda.current_device()]] if cuda else [])
        generator_states = [g.get_state() for g in generators]
        if cuda:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._run()
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            self._run()
        # The warm-up moved the state and the module: put back everything it moved.
        with torch.no_grad():
            for s, t in zip(self.static, leaves):
                s.copy_(t)
            for m, t in zip(self._module_tensors, saved):
                m.copy_(t)
        del saved
        if any(not torch.equal(g.get_state(), st) for g, st in zip(generators, generator_states)):
            for g, st in zip(generators, generator_states):
                g.set_state(st)
            module = self.module
            if isinstance(module, WrappedModuleFlow):
                module = module.module
            raise ValueError(
                f"{type(module).__name__} drew from torch's global generator during the "
                "program's warm-up: a compiled program would replay that noise. Draw through "
                "fab_tpu_torch.random with the generator it is given")
        if not cuda:
            return
        self.host_calls.activate()
        coupling_kernel.forget_prepared()
        before = _host_counts()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with collector_paused(), torch.cuda.graph(self.graph):
            self._info = self._run()
        self.capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.graph.instantiate()
        self.instantiate_s = time.perf_counter() - t0
        pool = tuple(self.graph.pool())
        self.pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                              if tuple(seg.get("segment_pool_id", ())) == pool)
        after = _host_counts()
        self.captured_counts = {k: v - before.get(k, 0) for k, v in after.items()
                                if k in before or v}
        # The cache's entries now name the capture's planes under the weights'
        # versions at its end, which a replay does not move.
        coupling_kernel.forget_prepared()

    def _load(self, state) -> None:
        if self.static is None:
            try:
                self._build(state)
            except BaseException:
                # Nothing half-built is kept: the next call builds again (and fails again).
                self.static = self.graph = None
                self.tape, self.host_calls = random.Tape(self.device), native.HostCalls(self.device)
                raise
        leaves, spec = _flatten(state)
        if spec != self._spec:
            raise ValueError("the state's structure differs from the captured program's")
        if [id(t) for t in self._module_tensors] != [id(t) for t in _module_tensors(self.module)]:
            raise RuntimeError("the module's parameters were replaced since the program was "
                               "captured: make a new one")
        with torch.no_grad():
            for s, t in zip(self.static, leaves):
                if t is not s:
                    s.copy_(t)

    def _replay(self, generator) -> Dict[str, Any]:
        random.noise_pass(self.tape, generator)
        self.replays += 1
        if self.graph is None:
            return self._run()
        self.host_calls.activate()
        self.graph.replay()
        # A replay moves the weights but not their versions: K2's prepared copies
        # of them are stale for an eager pass.
        coupling_kernel.forget_prepared()
        return self._info

    def __call__(self, state, generator, n_calls: int = 1):
        """``n_calls`` calls from ``state``, each after its own noise pass, with no
        host read between them; (the state after the last, its info). Both hold
        tensors the next call overwrites."""
        self._load(state)
        for _ in range(n_calls):
            info = self._replay(generator)
        # The caller's containers, as ``fn`` returns them, around the static tensors.
        return (_like(pytree.tree_unflatten(self.static, self._spec), self._out),
                pytree.tree_map(lambda v: v, info))


class StepProgram(Program):
    """One train step of ``trainer`` at ``batch_size`` as a ``Program`` over the
    train state's tensors (all fields but the last, ``step``, which the caller's
    state carries on the host)."""

    def __init__(self, trainer, batch_size: int):
        ok, reason = graph_supported(trainer)
        if not ok:
            raise ValueError(f"this configuration has no compiled step: {reason}")
        self.trainer, self.batch_size = trainer, batch_size
        self._state_type = None
        super().__init__(self._step, trainer.model.flow, trainer.device)

    def _step(self, fields, key):
        new_state, info = self.trainer.train_step(self._state_type(*fields, 0), key,
                                                  self.batch_size)
        return tuple(new_state)[:-1], info

    def __call__(self, state, generator, n_steps: int = 1):
        """``n_steps`` steps from ``state``: (the state after the last, its info)."""
        assert state._fields[-1] == "step", state._fields
        self._state_type = self._state_type or type(state)
        fields, info = super().__call__(tuple(state)[:-1], generator, n_steps)
        return self._state_type(*fields, state.step + n_steps), info
