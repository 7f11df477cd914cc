"""The compiled train step: one whole iteration captured as a CUDA graph and replayed
(``fab_tpu/train.py:226-245``: a ``jax.jit`` of the step, its state donated).

``StepProgram(trainer, batch_size)`` runs the trainer's own eager ``train_step`` on
static tensors, so the graph replays exactly the kernels the eager step launches:

- **State.** The state's tensors (transition state, Adam's count and moments, the
  buffer) are copied once into static tensors; the flow's parameters are static
  already (the step updates them in place). At the end of each step the new state
  is copied back into the static one (the buffer's ``index_put`` is out of place),
  so a step's input is the last one's output. The state a call returns holds those
  static tensors: the next call overwrites them, as a donated buffer is gone after
  a jitted call in ``fab_tpu``.
- **Noise.** The step draws through a ``random.Tape`` (see ``random.py``): each
  call first replays the tape on the caller's generator (the *noise pass*), then
  runs the step, which reads its draws from the tape's static tensors. The draws
  are the eager step's, bit for bit.
- **Build.** The first call runs one eager step that records the tape (on the card
  on a side stream, so cuBLAS and the allocator are set up before capture),
  restores every parameter, buffer and state tensor it moved, and, on
  the card, captures one step into a ``torch.cuda.CUDAGraph`` (with the kernels'
  host caches emptied first, so the graph rebuilds K2's prepared weights where a
  steady-state eager step does). On the CPU there is no graph: every call runs the
  step through the same static tensors and tape.
- **Counts.** The kernels' wrappers count launches on the host, which a replay
  does not reach: ``captured_counts`` holds what one captured step counted and
  ``replays`` the steps taken since (on the CPU, the eager runs of the step), so the
  replays launched ``captured_counts`` times ``replays`` beside what the wrappers
  counted themselves (warm-up and capture).

``graph_supported(trainer)`` is the static test of which configurations take this
path; the others keep the eager ``train_step``, for the reason it gives.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from fab_tpu_torch import random
from fab_tpu_torch.flows.base import is_stochastic
from fab_tpu_torch.flows.fused import FusedPass
from fab_tpu_torch.flows.resampled import ResampledGaussianBase
from fab_tpu_torch.flows.splines import PeriodicShift, SplineCoupling
from fab_tpu_torch.ops import coupling_kernel, realnvp_kernel
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.targets.double_well import DoubleWellEnergy
from fab_tpu_torch.targets.many_well import ManyWellEnergy
from fab_tpu_torch.wrappers.module import WrappedModuleFlow
from fab_tpu_torch.wrappers.torch_dist import WrappedTorchDist

# Why a configuration keeps the eager step (ROADMAP "Also open" orders them).
REFUSED = {
    "mesh": "an active data or model mesh: its collectives are not captured (gloo "
            "carries CUDA tensors through the host; NCCL at world size 1 is not yet "
            "captured)",
    "host_cpp": "system.backend host_cpp: every target evaluation is a round trip to "
                "the host C++ energy server, which no CUDA graph can hold",
    "lars": "the resampled (LARS) base: not yet captured",
    "snf": "a stochastic normalizing flow (SNF): not yet captured",
    "splines": "a spline flow (ALDP): not yet captured",
    "wrappers": "a wrapped external module or torch distribution: its draws need not go "
                "through fab_tpu_torch.random, so a tape cannot hold them",
    "rejection": "target_forward_kl on ManyWell: its exact draws are rejection sampling, "
                 "a loop that reads the device on the host",
}


def graph_supported(trainer) -> Tuple[bool, str]:
    """(whether ``trainer``'s ``run`` goes through ``make_train_step``, why): decided
    from the configuration alone, before any capture."""
    model = trainer.model
    flow, target = model.flow, model.target
    modules = list(flow.modules()) if isinstance(flow, torch.nn.Module) else []
    if mesh.active_mesh() is not None:
        return False, REFUSED["mesh"]
    if getattr(target, "backend", None) == "host_cpp":
        return False, REFUSED["host_cpp"]
    if isinstance(flow, WrappedModuleFlow) or isinstance(target, WrappedTorchDist):
        return False, REFUSED["wrappers"]
    if is_stochastic(flow):
        return False, REFUSED["snf"]
    if any(isinstance(m, ResampledGaussianBase) for m in modules):
        return False, REFUSED["lars"]
    if any(isinstance(m, (SplineCoupling, PeriodicShift)) for m in modules):
        return False, REFUSED["splines"]
    if model.loss_type == "target_forward_kl" and isinstance(
            target, (ManyWellEnergy, DoubleWellEnergy)):
        return False, REFUSED["rejection"]
    if trainer.device.type == "cuda":
        return True, f"one step captured as a CUDA graph on {trainer.device}, replayed"
    return True, (f"no CUDA graph on {trainer.device}: each step runs eagerly through the "
                  "same static tensors and noise tape")


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


def _leaves(state) -> Tuple[List[torch.Tensor], Any]:
    """The tensors of a train state (all fields but the last, ``step``) and their
    structure."""
    assert state._fields[-1] == "step", state._fields
    return pytree.tree_flatten(tuple(state)[:-1])


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class StepProgram:
    """One train step of ``trainer`` at ``batch_size`` on static tensors, captured as
    a CUDA graph on the card (see the module docstring). ``__call__(state,
    generator, n)`` takes n steps."""

    def __init__(self, trainer, batch_size: int):
        supported, reason = graph_supported(trainer)
        if not supported:
            raise ValueError(f"this configuration has no compiled step: {reason}")
        self.trainer, self.batch_size = trainer, batch_size
        self.device = trainer.device
        self.tape = random.Tape()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: Optional[List[torch.Tensor]] = None
        self.replays = 0
        self.captured_counts: Dict[str, int] = {}
        self.capture_s = self.instantiate_s = None
        self.pool_bytes = None
        self._module_tensors = list(trainer.model.flow.state_dict(keep_vars=True).values())

    # ------------------------------------------------------------------ the step

    def _step(self) -> Dict[str, Any]:
        """The eager step on the static state, its draws served by the tape, and its
        new state copied into the static one. Returns its info."""
        trainer = self.trainer
        state = self._state_type(*pytree.tree_unflatten(self.static, self._spec), 0)
        with random.taped(self.tape) as key:
            new_state, info = trainer.train_step(state, key, self.batch_size)
        new, spec = _leaves(new_state)
        assert spec == self._spec, "the step changed the state's structure"
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
        leaves, self._spec = _leaves(state)
        self._state_type = type(state)
        self.static = [t.detach().clone() for t in leaves]
        saved = [t.detach().clone() for t in self._module_tensors]
        cuda = self.device.type == "cuda"
        if cuda:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._step()
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            self._step()
        # The warm-up trained: put back everything it moved.
        with torch.no_grad():
            for s, t in zip(self.static, leaves):
                s.copy_(t)
            for m, t in zip(self._module_tensors, saved):
                m.copy_(t)
        del saved
        if not cuda:
            return
        coupling_kernel.forget_prepared()
        before = counts()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            self._info = self._step()
        self.capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.graph.instantiate()
        self.instantiate_s = time.perf_counter() - t0
        pool = tuple(self.graph.pool())
        self.pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                              if tuple(seg.get("segment_pool_id", ())) == pool)
        after = counts()
        self.captured_counts = {k: after[k] - before[k] for k in after}
        # The cache's entries now name the capture's planes under the weights'
        # versions at its end, which a replay does not move.
        coupling_kernel.forget_prepared()

    def _load(self, state) -> None:
        if self.static is None:
            self._build(state)
        leaves, spec = _leaves(state)
        if spec != self._spec:
            raise ValueError("the state's structure differs from the captured step's")
        if [id(t) for t in self._module_tensors] != [
                id(t) for t in self.trainer.model.flow.state_dict(keep_vars=True).values()]:
            raise RuntimeError("the flow's parameters were replaced since the step was "
                               "captured: make a new step")
        with torch.no_grad():
            for s, t in zip(self.static, leaves):
                if t is not s:
                    s.copy_(t)

    def _replay(self, generator) -> Dict[str, Any]:
        random.noise_pass(self.tape, generator)
        self.replays += 1
        if self.graph is None:
            return self._step()
        self.graph.replay()
        # A replay moves the weights but not their versions: K2's prepared copies
        # of them are stale for an eager pass.
        coupling_kernel.forget_prepared()
        return self._info

    def __call__(self, state, generator, n_steps: int = 1):
        """``n_steps`` steps from ``state``, each after its own noise pass, with no
        host read between them; (the state after the last, its info). Both hold
        tensors the next call overwrites."""
        self._load(state)
        for _ in range(n_steps):
            info = self._replay(generator)
        new_state = self._state_type(*pytree.tree_unflatten(self.static, self._spec),
                                     state.step + n_steps)
        return new_state, pytree.tree_map(lambda v: v, info)  # the caller's containers
