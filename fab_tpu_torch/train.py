"""FAB trainers, guarded update and optimizer (``fab_tpu/train.py``).

The optimizer is a small functional Adam (or Adamax) with global-norm clipping and
an optional LR schedule that keeps the JAX package's semantics
(``fab_tpu/train.py:57-156``), which ``torch.optim`` does not:

- ``clip_by_global_norm`` scales by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm`` (no ``+1e-6`` in the divisor);
- ``guarded_update`` takes the grad norm before clipping, scrubs NaN grads, and on
  a skipped step (non-finite loss, grad norm or update) leaves the parameters and
  the whole optimizer state, Adam's count included, unchanged. The skip is a
  ``torch.where`` select, so no step waits for the device.

``Trainer`` is plain FAB training (loss, gradient, guarded step); ``run`` is the
training loop with its eval, checkpoint and time-limit schedule
(``fab_tpu/train.py:168-394``), shared by ``BufferTrainer`` (a uniform or
recency-weighted replay buffer) and ``PrioritisedBufferTrainer``.

**Data parallel.** Under a data mesh (``parallel/mesh.py``) every trainer runs on
each rank with ``batch_size`` the global batch: the rank's loss is its share of the
global loss, and the gradients and the loss are all-reduced as one flattened bucket
per update before the guard and the clip see them, so every rank takes the same
step. Info means, extremes and the log-weight clip are global; checkpoints hold the
buffer in the one-process layout (gathered on save, scattered on load), written by
rank 0 only, which also alone plots; every rank evaluates (evaluation has
collectives).

**Model axis.** Under a mesh with ``n_model > 1`` ``init_state`` splits the flow's
conditioners over the model group (``parallel/tensor.py:shard_flow_params``, as
``fab_tpu``'s trainers call its ``shard_flow_params``). The gradient bucket is summed
over the data group only (the ranks of a model group hold the same rows); Adam's
moments are shaped like the shards; the guard's and the clip's global norm add the
split tensors' squares over the model group and count replicated ones once, so the
logged ``grad_norm`` is one process's. Checkpoints keep the one-process layout:
split parameters and moments are gathered on save and cut on load; DCP saves them
as DTensors sharded over the model axis. With a model-split flow every rank runs
the plotter (a flow pass needs its model group), and rank 0 alone saves the figures.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pathlib
from time import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fab_tpu_torch import checkpoint, graph
from fab_tpu_torch import losses as losses_lib
from fab_tpu_torch.buffer import (
    PrioritisedBufferState,
    PrioritisedReplayBuffer,
    ReplayBuffer,
    UniformBufferState,
)
from fab_tpu_torch.convert import from_jax_params, to_jax_params
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows.base import flow_log_prob, log_q_noise
from fab_tpu_torch.model import FABModel, format_transition_info
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.parallel import tensor as model_axis
from fab_tpu_torch.parallel.distributed import is_primary
from fab_tpu_torch.parallel.tensor import global_norm
from fab_tpu_torch.utils.logging import ListLogger, Logger
from fab_tpu_torch.utils.plotting import pyplot


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


# The pieces take the integer update count and keep the dtypes fab_tpu's schedules
# have: the linear and exponential pieces divide an int32 count, which gives
# float32; the cosine gives the default float (float64 here). A float32 piece makes
# the whole joined schedule float32 (``LRSchedule.__call__``).


def _linear(count, init: float, end: float, steps: int):
    """Linear from init to end over ``steps`` updates, then end."""
    frac = 1 - count.clamp(0, steps).to(torch.float32) / steps
    return (init - end) * frac + end


def _cosine(count, init: float, steps: int, alpha: float):
    """Cosine decay from init to alpha * init over ``steps`` updates, then flat."""
    count = count.to(torch.float64).clamp(max=float(steps))
    return init * ((1 - alpha) * (0.5 * (1 + torch.cos(math.pi * count / steps))) + alpha)


def _exponential(count, init: float, steps: int, rate: float):
    """Exponential decay: init * rate ** (count / steps)."""
    p = count.to(torch.float32) / steps
    return torch.where(count <= 0, init, init * rate**p)


def _join(pieces, boundaries, count):
    """Joined schedules: piece i+1 takes over at boundary i, with its count
    restarted there."""
    out = pieces[0](count)
    for boundary, piece in zip(boundaries, pieces[1:]):
        out = torch.where(count < boundary, out, piece(count - boundary))
    return out


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    """The learning rate per optimizer update (``fab_tpu/train.py:106-144``):
    ``"cosine"`` (to ``decay_rate * lr`` at ``total_steps``), ``"cosine_restart"``
    (cosines of ``restart_period`` updates, default ``total_steps // 4``, joined),
    ``"exponential"`` (``lr * decay_rate ** (t / total_steps)``) or None (constant),
    each after an optional linear warm-up from 0 over ``warmup_steps``.

    Called with the update count before its increment, as fab_tpu's is, so with a
    warm-up the first update has learning rate 0. Evaluated on the device: no step
    waits for the host.
    """

    lr: float
    schedule: Optional[str] = None
    total_steps: Optional[int] = None
    warmup_steps: int = 0
    decay_rate: float = 0.1
    restart_period: Optional[int] = None

    def __post_init__(self):
        if self.schedule not in (None, "cosine", "cosine_restart", "exponential"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.schedule and self.total_steps is None:
            raise ValueError("scheduled LR needs total_steps")

    def _main(self, count):
        lr, rate = self.lr, float(self.decay_rate)
        span = max((self.total_steps or 0) - self.warmup_steps, 1)
        if self.schedule == "cosine":
            return _cosine(count, lr, span, rate)
        if self.schedule == "cosine_restart":
            period = int(self.restart_period or max(self.total_steps // 4, 1))
            n_pieces = -(-self.total_steps // period)
            return _join(
                [lambda c: _cosine(c, lr, period, rate)] * n_pieces,
                [period * (i + 1) for i in range(self.total_steps // period)],
                count,
            )
        if self.schedule == "exponential":
            return _exponential(count, lr, span, rate)
        return torch.full(count.shape, lr, dtype=torch.float64, device=count.device)

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        count = count.to(torch.int64)
        if self.warmup_steps > 0:
            lr = _join(
                [lambda c: _linear(c, 0.0, self.lr, self.warmup_steps), self._main],
                [self.warmup_steps],
                count,
            )
        else:
            lr = self._main(count)
        if self.warmup_steps > 0 or self.schedule == "exponential":
            lr = lr.to(torch.float32)
        return lr


@dataclasses.dataclass(frozen=True)
class ClippedAdam:
    """Global-norm clipping then Adam, or Adamax with ``adamax``
    (``fab_tpu/train.py:146-156``). ``lr`` is a constant or an ``LRSchedule`` read
    at the update count."""

    lr: Union[float, LRSchedule]
    max_gradient_norm: Optional[float] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    adamax: bool = False

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        zeros = lambda: [torch.zeros_like(p) for p in params]
        count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        return AdamState(count, zeros(), zeros())

    def learning_rate(self, count: torch.Tensor):
        """The learning rate of the update made at ``count`` (before increment)."""
        return self.lr(count) if isinstance(self.lr, LRSchedule) else self.lr

    def update(
        self, grads: Sequence[torch.Tensor], state: AdamState,
        split: Optional[Sequence[bool]] = None, model_mesh=None,
    ) -> Tuple[List[torch.Tensor], AdamState]:
        """Adam's step on ``grads``; ``split`` / ``model_mesh`` as ``global_norm``'s."""
        if self.max_gradient_norm is not None:
            g_norm = global_norm(grads, split, model_mesh)
            trigger = g_norm < self.max_gradient_norm
            grads = [
                torch.where(trigger, g, g / g_norm * self.max_gradient_norm) for g in grads
            ]
        mu = [(1 - self.b1) * g + self.b1 * m for g, m in zip(grads, state.mu)]
        if self.adamax:
            # Infinity norm: no bias correction and no square root.
            nu = [torch.maximum(g.abs() + self.eps, self.b2 * v) for g, v in zip(grads, state.nu)]
        else:
            nu = [(1 - self.b2) * g * g + self.b2 * v for g, v in zip(grads, state.nu)]
        lr = self.learning_rate(state.count)
        count = torch.where(
            state.count < 2**31 - 1, state.count + 1, state.count
        ).to(torch.int32)
        updates = []
        for m, v in zip(mu, nu):
            c = count.to(m.dtype)
            m_hat = m / (1 - self.b1**c)
            if self.adamax:
                direction = m_hat / v
            else:
                direction = m_hat / (torch.sqrt(v / (1 - self.b2**c)) + self.eps)
            step = -lr if isinstance(lr, float) else -lr.to(m.dtype)
            updates.append(step * direction)
        return updates, AdamState(count, mu, nu)


def make_optimizer(
    lr: float,
    max_gradient_norm: Optional[float] = None,
    optimizer: str = "adam",
    schedule: Optional[str] = None,
    total_steps: Optional[int] = None,
    warmup_steps: int = 0,
    decay_rate: float = 0.1,
    restart_period: Optional[int] = None,
) -> ClippedAdam:
    """Adam or Adamax with optional global-norm clipping and an optional LR schedule
    (``fab_tpu/train.py:make_optimizer``; see ``LRSchedule``). ``total_steps``
    counts optimizer updates: a buffer trainer makes several per iteration."""
    if optimizer not in ("adam", "adamax"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    lr = float(lr)
    if schedule or warmup_steps > 0:
        lr = LRSchedule(lr, schedule, total_steps, int(warmup_steps), float(decay_rate),
                        restart_period)
    return ClippedAdam(
        lr, None if max_gradient_norm is None else float(max_gradient_norm),
        adamax=optimizer == "adamax",
    )


def _schedule(n_iterations: int, n_points: Optional[int]) -> set:
    """Iterations (1-based) of ``n_points`` evals or checkpoints spread over a run."""
    if not n_points:
        return set()
    if n_points == 1:
        # np.linspace(1, n, 1) == [1]; a single checkpoint/eval belongs at the END.
        return {n_iterations}
    return set(np.linspace(1, n_iterations, n_points, dtype=int).tolist())


def _all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def all_reduce_gradients(grads: Sequence[torch.Tensor], loss: torch.Tensor):
    """Every data rank's gradients and loss share summed over the data group, as one
    flattened bucket (one collective per update); returns (grads, loss) over the
    global batch. Split parameters' gradients are this rank's shards: the ranks of
    its model group hold the other shards of the same rows, so nothing is summed
    over the model axis."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    flat = mesh.all_reduce(flat)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return out, flat[offset]


def guarded_update(
    optimizer: ClippedAdam,
    grads: Sequence[torch.Tensor],
    opt_state: AdamState,
    flow_params: Sequence[torch.Tensor],
    loss: torch.Tensor,
    split: Optional[Sequence[bool]] = None,
    model_mesh=None,
) -> Tuple[AdamState, torch.Tensor, torch.Tensor]:
    """Apply an optimizer update to ``flow_params`` in place unless loss/grads are
    non-finite. Returns (new_opt_state, grad_norm, applied). ``split`` /
    ``model_mesh``: as ``global_norm``'s, for parameters split over a model axis."""
    grad_norm = global_norm(grads, split, model_mesh)
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    safe_grads = [torch.nan_to_num(g) for g in grads]
    updates, new_state = optimizer.update(safe_grads, opt_state, split, model_mesh)
    ok = ok & _all_finite(updates)
    with torch.no_grad():
        for p, u in zip(flow_params, updates):
            p.copy_(torch.where(ok, p + u, p))
    new_state = AdamState(
        torch.where(ok, new_state.count, opt_state.count),
        [torch.where(ok, a, b) for a, b in zip(new_state.mu, opt_state.mu)],
        [torch.where(ok, a, b) for a, b in zip(new_state.nu, opt_state.nu)],
    )
    return new_state, grad_norm, ok


class TrainState(NamedTuple):
    transition_state: Dict[str, torch.Tensor]
    opt_state: AdamState
    step: int


class BufferTrainState(NamedTuple):
    transition_state: Dict[str, torch.Tensor]
    opt_state: AdamState
    buffer_state: Any  # PrioritisedBufferState | UniformBufferState
    step: int


class Trainer:
    """Plain FAB trainer (``fab_tpu/train.py:168-394``): per iteration the model's
    loss (for FAB, an AIS pass), its gradient and a guarded optimizer step.

    The flow's parameters live in ``model.flow`` and are updated in place; the
    flow is moved to ``device`` and ``dtype`` here.
    """

    state_type = TrainState

    def __init__(
        self,
        model: FABModel,
        optimizer: ClippedAdam,
        logger: Optional[Logger] = None,
        plotter: Optional[Callable] = None,
        save_path: str = "",
        dtype=torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.logger = logger if logger is not None else ListLogger()
        self.plotter = plotter
        self.plots_dir = os.path.join(save_path, "plots")
        self.checkpoints_dir = os.path.join(save_path, "model_checkpoints")
        self.dtype = dtype
        self.model.flow.to(device=self.device, dtype=dtype)
        self._programs: Dict[int, graph.StepProgram] = {}  # compiled steps by batch size
        self.fill_program: Optional[graph.Program] = None  # a buffer trainer's last fill

    @property
    def params(self) -> List[torch.nn.Parameter]:
        """The flow's trainable parameters, in the optimizer state's order."""
        return [p for p in self.model.flow.parameters() if p.requires_grad]

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Initialise the flow (split over the model axis of the active mesh, if it
        has one), the transition state and the optimizer."""
        transition_state = self.model.init(generator)
        model_axis.shard_flow_params(self.model.flow)
        return TrainState(transition_state, self.optimizer.init(self.params), 0)

    def _split(self):
        """(split flags of ``params``, their mesh) under a model mesh, else (None,
        None)."""
        active = mesh.active_mesh()
        if active is None or active.n_model == 1:
            return None, None
        return (model_axis.split_flags(self.model.flow, self._param_names()),
                model_axis.model_mesh(self.model.flow))

    def _step(self, loss: torch.Tensor, opt_state: AdamState):
        """The guarded optimizer step on ``loss``'s gradient (under a mesh, on the
        all-reduced gradients and loss); (opt_state, grad_norm, applied, loss)."""
        params = self.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        if mesh.active_mesh() is not None:
            grads, loss = all_reduce_gradients(grads, loss)
        split, model_mesh = self._split()
        return (*guarded_update(self.optimizer, grads, opt_state, params, loss, split,
                                model_mesh), loss.detach())

    def train_step(
        self, state: TrainState, generator: torch.Generator, batch_size: int
    ) -> Tuple[TrainState, Dict[str, Any]]:
        mesh.check_batch(batch_size)
        loss, transition_state, info = self.model.loss_and_info(
            state.transition_state, generator, batch_size, tune=True
        )
        opt_state, grad_norm, ok, loss = self._step(loss, state.opt_state)
        info = dict(info, loss=loss, grad_norm=grad_norm, update_applied=ok)
        return TrainState(transition_state, opt_state, state.step + 1), info

    # ------------------------------------------------------- the compiled step

    def _program(self, batch_size: int) -> graph.StepProgram:
        if batch_size not in self._programs:
            self._programs[batch_size] = graph.StepProgram(self, batch_size)
        return self._programs[batch_size]

    def make_train_step(self, batch_size: int):
        """``step(state, generator) -> (state, info)``: ``train_step`` compiled
        (``fab_tpu``'s ``jax.jit`` of it). On the card its first call captures one
        step as a CUDA graph, after one warm-up step whose effects it undoes, and
        every call replays it after drawing the step's noise from ``generator``; on
        the CPU it runs the same static-tensor and noise-tape path without a graph
        (``graph.py``). The draws, and so the steps, are ``train_step``'s.

        Donation: the state a call returns holds the step's static tensors, which the
        next call of any step of this trainer at this batch size overwrites; the
        state passed in is read, not kept. Copy what must outlive the next step. One
        program per batch size, shared with ``make_scanned_train_step``."""
        program = self._program(batch_size)
        return lambda state, generator: program(state, generator)

    def make_scanned_train_step(self, batch_size: int, n_steps: int):
        """``steps(state, generator) -> (state, info)``: ``n_steps`` replays of
        ``make_train_step``'s program, each after its own noise pass, enqueued with
        no host read between them (``fab_tpu``'s ``lax.scan`` in one dispatch).
        Returns the state after the last and the last step's info, with the same
        donation as ``make_train_step``."""
        program = self._program(batch_size)
        return lambda state, generator: program(state, generator, n_steps)

    # ------------------------------------------------------------ run loop

    def _param_names(self) -> List[str]:
        return [n for n, p in self.model.flow.named_parameters() if p.requires_grad]

    def save_checkpoint(self, state, i: int) -> None:
        """``<save_path>/model_checkpoints/iter_<i>/state.pkl``; the flow's
        parameters in ``fab_tpu``'s pytree layout, Adam's moments keyed by the
        parameters' names, and the buffer, if the state has one, in the one-process
        layout. Under a mesh every rank calls it (the buffer and split parameters and
        moments are gathered) and rank 0 writes."""
        names = self._param_names()
        opt = state.opt_state
        flow = self.model.flow
        whole = lambda values: model_axis.gather_state(flow, dict(zip(names, values)))
        payload = {
            "params": {
                "flow": to_jax_params(flow.state_dict(), len(flow.bijectors), flow=flow),
                "transition": dict(state.transition_state),
            },
            "opt_state": {
                "count": opt.count,
                "mu": whole(opt.mu),
                "nu": whole(opt.nu),
            },
            "step": state.step,
        }
        if hasattr(state, "buffer_state"):
            payload["buffer_state"] = self.buffer.gather(state.buffer_state)._asdict()
        if is_primary():
            checkpoint.save_checkpoint(
                os.path.join(self.checkpoints_dir, f"iter_{i}", "state.pkl"), payload
            )

    def load_state(self, path: str):
        """Load a checkpoint written by ``save_checkpoint`` at any world size, or by
        ``fab_tpu``'s trainers (its Adam state read from the optimizer library's
        records, its buffer from its named tuple): the flow's parameters go into the
        model in place, the buffer is cut to this rank's shard and, under a model
        mesh, split parameters and moments to this rank's shards; returns (state,
        step)."""
        raw = checkpoint.load_checkpoint(path)
        tensor = lambda a: torch.as_tensor(a, device=self.device)
        flow = self.model.flow
        model_axis.shard_flow_params(flow)
        flow.load_state_dict(from_jax_params(raw["params"]["flow"], self.device, flow=flow))
        names = self._param_names()
        opt = raw["opt_state"]
        if isinstance(opt, (tuple, checkpoint.Opaque)):
            opt = _adam_state(opt)
        own = lambda moments: [v for v in model_axis.cut_state(
            flow, {n: tensor(moments[n]) for n in names}).values()]
        fields = dict(
            transition_state={k: tensor(v) for k, v in raw["params"]["transition"].items()},
            opt_state=AdamState(tensor(opt["count"]), own(opt["mu"]), own(opt["nu"])),
            step=int(raw["step"]),
        )
        if "buffer_state" in raw:
            buffer = raw["buffer_state"]
            values = (buffer.args if isinstance(buffer, checkpoint.Opaque)
                      else [buffer[k] for k in self.buffer_state_type._fields])
            fields["buffer_state"] = self.buffer.scatter(
                self.buffer_state_type(*(tensor(v) for v in values)))
        state = self.state_type(**fields)
        return state, state.step

    # -------------------------------------------- torch.distributed.checkpoint

    def _dcp_tree(self, state) -> Dict[str, Any]:
        """The state as ``checkpoint.save_checkpoint_dcp`` takes it: the flow's state
        dict (its tensors alias the parameters), the transition state, Adam's moments
        by parameter name, the step, and the buffer's slot fields as blocks of
        ``buffer_blocks``. Split parameters and their moments are DTensors sharded
        over the model axis (``checkpoint.model_split``)."""
        opt = state.opt_state
        names = self._param_names()
        flow = self.model.flow
        split = lambda tree: checkpoint.model_split(flow, tree)
        tree = {
            "flow": split({k: v.detach() for k, v in flow.state_dict().items()}),
            "transition": dict(state.transition_state),
            "opt_state": {"count": opt.count, "mu": split(dict(zip(names, opt.mu))),
                          "nu": split(dict(zip(names, opt.nu)))},
            "step": torch.tensor(state.step),
        }
        if hasattr(state, "buffer_state"):
            tree["buffer_state"] = checkpoint.buffer_blocks(self.buffer, state.buffer_state)
        return tree

    def save_checkpoint_dcp(self, state, path: str) -> None:
        """Write the state to the directory ``path`` with ``torch.distributed.checkpoint``
        (``checkpoint.save_checkpoint_dcp``): every rank calls it and writes its
        shard of the buffer; replicated leaves are written once."""
        checkpoint.save_checkpoint_dcp(path, self._dcp_tree(state))

    def load_state_dcp(self, path: str):
        """Load a ``save_checkpoint_dcp`` directory written by any world size onto
        this one (any mesh shape): the flow's parameters in place, the buffer and
        split parameters re-sharded; returns (state, step)."""
        model_axis.shard_flow_params(self.model.flow)
        dim, dtype, device = self.model.flow.dim, self.dtype, self.device
        template = dict(
            transition_state=(self.model.ais.transition_operator.init_state(
                dim, dtype=dtype, device=device) if self.model.ais is not None else {}),
            opt_state=self.optimizer.init(self.params),
            step=0,
        )
        if hasattr(self, "buffer"):
            template["buffer_state"] = self.buffer.init(dtype, device)
        target = self._dcp_tree(self.state_type(**template))
        tree = checkpoint.load_checkpoint_dcp(path, target)
        local = checkpoint.to_local
        with torch.no_grad():
            for name, value in self.model.flow.state_dict(keep_vars=True).items():
                value.copy_(local(tree["flow"][name]))
        names = self._param_names()
        opt = tree["opt_state"]
        fields = dict(
            transition_state=tree["transition"],
            opt_state=AdamState(opt["count"], [local(opt["mu"][n]) for n in names],
                                [local(opt["nu"][n]) for n in names]),
            step=int(tree["step"]),
        )
        if "buffer_state" in tree:
            fields["buffer_state"] = checkpoint.buffer_from_blocks(
                self.buffer, self.buffer_state_type, tree["buffer_state"])
        state = self.state_type(**fields)
        return state, state.step

    def perform_eval(
        self, state, generator: torch.Generator, i: int, eval_batch_size: int,
        batch_size: int,
    ) -> None:
        """Evaluate with AIS targeting p and log the metrics."""
        eval_info = self.model.get_eval_info(
            state.transition_state, generator, eval_batch_size, batch_size, p_target=True
        )
        eval_info["step"] = i
        self.logger.write(eval_info)

    def _plots(self, state, generator: torch.Generator, i: int, save: bool) -> None:
        """``plotter(model, transition_state, generator) -> [figure]``, each figure
        saved as ``<plots_dir>/<j>_iter_<i>.png``. The plotter draws from a
        generator of its own (seeded with ``i``), so plotting leaves the training
        draws as they would be without it. Under a mesh rank 0 alone plots, whole,
        with the mesh off; with a model-split flow every rank plots (a flow pass needs
        its model group) and rank 0 alone saves."""
        if self.plotter is None or not (is_primary() or model_axis.model_mesh(self.model.flow)):
            return
        plt = pyplot()
        plot_generator = torch.Generator(device=self.device).manual_seed(i)
        with mesh.use_mesh(None):
            figures = self.plotter(self.model, state.transition_state, plot_generator)
        for j, figure in enumerate(figures or []):
            if save and is_primary():
                figure.savefig(os.path.join(self.plots_dir, f"{j}_iter_{i}.png"))
            plt.close(figure)

    def _all_agree(self, stop: bool) -> bool:
        """Whether any rank says stop (every rank then stops at the same iteration)."""
        if mesh.active_mesh() is None:
            return stop
        flag = torch.tensor(float(stop), device=self.device)
        return bool(mesh.max_all(flag) > 0)

    def run(
        self,
        generator: torch.Generator,
        n_iterations: int,
        batch_size: int,
        eval_batch_size: Optional[int] = None,
        n_eval: Optional[int] = None,
        n_plot: Optional[int] = None,
        n_checkpoints: Optional[int] = None,
        save: bool = True,
        tlimit: Optional[float] = None,
        state=None,
        start_iter: int = 0,
        log_every: int = 1,
    ):
        """Training loop with linspace-scheduled eval/plot/checkpoint and a graceful
        stop at ``tlimit`` hours (``fab_tpu/train.py:277-394``).

        Steps run in chunks of up to ``log_every`` iterations that stop at every
        scheduled event, each chunk one call of ``make_train_step`` (one step) or
        ``make_scanned_train_step`` (more), as in ``fab_tpu``; the logger gets the
        last step of each chunk. A configuration ``graph.graph_supported`` refuses
        (the host C++ server, the wrappers, ManyWell's rejection-sampled
        ``target_forward_kl``, the model axis, gloo on the card) takes the eager
        ``train_step`` instead; the choice and its reason are printed once. Without
        ``state``, ``init_state`` makes one (a buffer trainer fills its buffer with its
        default batch through its compiled fill pass where the step is compiled, as
        ``fab_tpu``'s jitted fill does). The state returned is the compiled step's
        (see ``make_train_step``).
        """
        if save and is_primary():
            pathlib.Path(self.plots_dir).mkdir(parents=True, exist_ok=True)
            pathlib.Path(self.checkpoints_dir).mkdir(parents=True, exist_ok=True)
        checkpoint_iter = _schedule(n_iterations, n_checkpoints)
        eval_iter = _schedule(n_iterations, n_eval)
        plot_iter = _schedule(n_iterations, n_plot)
        if n_eval and eval_batch_size is None:
            raise ValueError("n_eval needs eval_batch_size")
        if state is None:
            state = self.init_state(generator)
        compiled, reason = graph.graph_supported(self)
        if is_primary():
            print(f"train step: {'compiled' if compiled else 'eager'} ({reason})", flush=True)

        def run_chunk(state, k: int):
            if compiled:
                step = (self.make_train_step(batch_size) if k == 1
                        else self.make_scanned_train_step(batch_size, k))
                return step(state, generator)
            for _ in range(k):
                state, info = self.train_step(state, generator, batch_size)
            return state, info

        events = sorted({n_iterations} | checkpoint_iter | eval_iter | plot_iter)
        start_time = time()
        max_it_time = 0.0
        # The first chunk of each length is left out of the time projection: it
        # carries one-off costs (the kernels' first build, library handles).
        warm_ks: set = set()
        last_progress = 0.0
        chunk_ms: List[float] = []  # per-iteration ms of each warm full-length chunk

        i = start_iter
        while i < n_iterations:
            it_start = time()
            next_event = min(e for e in events if e > i)
            k = max(min(log_every, next_event - i), 1)
            state, info = run_chunk(state, k)
            i += k
            t_info = info.pop("transition", None)
            host_info = {name: float(v) for name, v in info.items()}
            if t_info is not None and self.model.ais is not None:
                n_dists = self.model.ais.n_intermediate_distributions
                host_info.update(
                    {name: float(v) for name, v in format_transition_info(t_info, n_dists).items()}
                )
            host_info["step"] = i
            self.logger.write(host_info)
            if k in warm_ks:
                max_it_time = max(max_it_time, (time() - it_start) / k)
                if k == log_every:
                    chunk_ms.append(1e3 * (time() - it_start) / k)
            warm_ks.add(k)
            now = time()
            if now - last_progress > 60.0 and is_primary():  # one line a minute at most
                last_progress = now
                parts = [f"iter {i}/{n_iterations}"]
                for name in ("loss", "ess_ais", "ess_base", "n_valid"):
                    if name in host_info:
                        parts.append(f"{name}={host_info[name]:.4g}")
                print("  ".join(parts), flush=True)
            if i in eval_iter:
                self.perform_eval(state, generator, i, eval_batch_size, batch_size)
            if i in plot_iter:
                self._plots(state, generator, i, save)
            if i in checkpoint_iter and save:
                self.save_checkpoint(state, i)
            # Stop early enough that the next chunk, at the measured rate, would not
            # overshoot; before a rate is known, plain wall-clock checking.
            if tlimit is not None:
                hours = (time() - start_time) / 3600
                if self._all_agree(hours + max_it_time * k / 3600 > tlimit):
                    if save and i not in checkpoint_iter:
                        self.save_checkpoint(state, i)
                    if n_eval and i not in eval_iter:
                        self.perform_eval(state, generator, i, eval_batch_size, batch_size)
                    self.logger.close()
                    self._print_timing(start_iter, i, time() - start_time, chunk_ms)
                    print(f"Ending training at iteration {i}: tlimit reached.")
                    return state
        self.logger.close()
        self._print_timing(start_iter, i, time() - start_time, chunk_ms)
        return state

    @staticmethod
    def _print_timing(start: int, end: int, wall_s: float, chunk_ms: List[float]) -> None:
        """One line: the loop's wall time (evals and checkpoints included) and the
        median per-iteration time of its last 10 warm full-length chunks (the host
        clock around a chunk and its logging, which reads the chunk's results)."""
        if not is_primary():
            return
        median = f"{float(np.median(chunk_ms[-10:])):.2f} ms" if chunk_ms else "not measured"
        print(f"run timing: iterations {start}-{end} in {wall_s:.1f} s; median step over "
              f"the last 10 chunks {median}", flush=True)


def _adam_state(tree) -> Dict[str, Any]:
    """count, mu and nu (by parameter name) from ``fab_tpu``'s pickled optimizer
    state: its ``ScaleByAdamState`` record (``checkpoint.Opaque``)."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, checkpoint.Opaque):
            if node.name == "ScaleByAdamState":
                count, mu, nu = node.args
                return {"count": count, "mu": from_jax_params(mu),
                        "nu": from_jax_params(nu)}
            stack.extend(node.args)
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
    raise ValueError("the checkpoint's optimizer state holds no Adam state")


def _fill_buffer(trainer, generator: torch.Generator, batch_size: int, add) -> BufferTrainState:
    """A buffer trainer's initial state: the flow and transition state initialised,
    the buffer filled to its minimum length with AIS samples, and the optimizer.

    ``model.init``, ``buffer.init`` and ``optimizer.init`` run once, eagerly. Each
    fill pass (an AIS pass, then ``add(buffer_state, result)``) is one call of a
    compiled program where ``graph.graph_supported`` admits the configuration
    (``fab_tpu``'s jitted ``fill_step``; ``trainer.fill_program``), else eager; the
    choice and its reason are printed once. Between passes the loop reads the
    buffer's ``n_added`` on the host, as ``fab_tpu``'s does."""
    model, buffer = trainer.model, trainer.buffer
    transition_state = model.init(generator)
    model_axis.shard_flow_params(model.flow)
    buffer_state = buffer.init(trainer.dtype, trainer.device)

    def fill_pass(state, key):
        transition, buffer_state = state
        result = model.ais.sample_and_log_weights(transition, key, batch_size,
                                                  p_target=False, tune=True)
        return (result.transition_state, add(buffer_state, result)), {}

    compiled, reason = graph.graph_supported(trainer)
    if is_primary():
        print(f"buffer fill: {'compiled' if compiled else 'eager'} ({reason})", flush=True)
    trainer.fill_program = (graph.Program(fill_pass, model.flow, trainer.device)
                            if compiled else None)
    take = trainer.fill_program or fill_pass
    state = (transition_state, buffer_state)
    t0 = time()
    while int(state[1].n_added) < buffer.min_sample_length:
        state, _ = take(state, generator)
    if is_primary():
        print(f"buffer fill: {int(state[1].n_added)} rows in {time() - t0:.1f} s", flush=True)
    return BufferTrainState(
        transition_state=state[0],
        opt_state=trainer.optimizer.init(trainer.params),
        buffer_state=state[1],
        step=0,
    )


class BufferTrainer(Trainer):
    """FAB with a uniform or recency-weighted replay buffer
    (``fab_tpu/train.py:404-554``). Per iteration: one fab_alpha_div step on the fresh
    AIS batch (the top ``clip_ais_weights_frac`` of its log-weights clipped to the
    k-th largest), then n_batches_buffer_sampling replay steps on buffer draws (from
    the buffer as it was before this iteration), then the AIS batch is added.
    """

    state_type = BufferTrainState
    buffer_state_type = UniformBufferState

    def __init__(
        self,
        model: FABModel,
        optimizer: ClippedAdam,
        buffer: ReplayBuffer,
        n_batches_buffer_sampling: int = 2,
        clip_ais_weights_frac: Optional[float] = None,
        logger: Optional[Logger] = None,
        plotter: Optional[Callable] = None,
        save_path: str = "",
        dtype=torch.float32,
        device="cuda",
    ):
        super().__init__(model, optimizer, logger, plotter, save_path, dtype, device)
        self.buffer = buffer
        self.n_batches_buffer_sampling = n_batches_buffer_sampling
        self.clip_ais_weights_frac = clip_ais_weights_frac

    def init_state(self, generator: torch.Generator, batch_size: int = 128) -> BufferTrainState:
        """Initialise flow and optimizer, and fill the buffer to its minimum length
        with AIS samples."""
        return _fill_buffer(
            self, generator, batch_size,
            lambda b, r: self.buffer.add(b, r.point.x, r.log_w, r.mask),
        )

    def _inner_update(self, opt_state, x, log_w, mask, generator):
        """One fab_alpha_div step on the given points and weights; rows whose log q
        is not finite are probed out and zero-filled first. One log-q key (a
        stochastic flow's noise) is drawn from ``generator`` for the probe and the
        differentiated pass. (opt_state, loss, grad_norm)."""
        flow = self.model.flow
        key_lq = log_q_noise(flow, generator)
        with torch.no_grad():
            log_q_probe = flow_log_prob(flow, x, key_lq)
        mask = mask & torch.isfinite(log_q_probe)
        x = torch.where(mask[:, None], x, 0.0)
        loss = losses_lib.fab_alpha_div(flow_log_prob(flow, x, key_lq), log_w,
                                        self.model.alpha, mask)
        opt_state, grad_norm, _, loss = self._step(loss, opt_state)
        return opt_state, loss, grad_norm

    def train_step(
        self, state: BufferTrainState, generator: torch.Generator, batch_size: int
    ) -> Tuple[BufferTrainState, Dict[str, Any]]:
        mesh.check_batch(batch_size)
        result = self.model.ais.sample_and_log_weights(
            state.transition_state, generator, batch_size, p_target=False, tune=True
        )
        log_w_ais = result.log_w
        if self.clip_ais_weights_frac is not None:
            k = max(2, int(self.clip_ais_weights_frac * batch_size))
            log_w_ais = torch.minimum(log_w_ais, mesh.kth_largest(log_w_ais, k))
        opt_state, loss, grad_norm = self._inner_update(
            state.opt_state, result.point.x, log_w_ais, result.mask, generator
        )
        for _ in range(self.n_batches_buffer_sampling):
            x, log_w = self.buffer.sample(state.buffer_state, generator, batch_size)
            opt_state, replay_loss, _ = self._inner_update(
                opt_state, x, log_w, torch.isfinite(log_w), generator
            )
        buffer_state = self.buffer.add(
            state.buffer_state, result.point.x, log_w_ais, result.mask
        )
        info = dict(result.info, loss=loss, grad_norm=grad_norm, replay_loss=replay_loss)
        return BufferTrainState(
            result.transition_state, opt_state, buffer_state, state.step + 1
        ), info


class PrioritisedBufferTrainer(Trainer):
    """FAB + prioritised replay buffer (``fab_tpu/train.py:557-784``).

    The flow's parameters live in ``model.flow`` and are updated in place. Per
    iteration:
      1. an AIS pass targeting g = p^alpha q^(1-alpha), added to the buffer; rows the
         model's train-time ``sample_filter`` rejects go in with priority -inf;
      2. one Gumbel-top-k draw of n_batches_buffer_sampling x batch rows;
      3. per replay batch: a no-grad probe of log q (non-finite rows are masked and
         zero-filled), a guarded gradient step on the w-adjusted loss, and the
         priority adjustment, or, with ``w_adjust_in_buffer_after_update``, one
         adjustment pass over every replay batch after the last step.
    """

    state_type = BufferTrainState
    buffer_state_type = PrioritisedBufferState

    def __init__(
        self,
        model: FABModel,
        optimizer: ClippedAdam,
        buffer: PrioritisedReplayBuffer,
        n_batches_buffer_sampling: int = 2,
        w_adjust_max_clip: Optional[float] = 10.0,
        w_adjust_in_buffer_after_update: bool = False,
        logger: Optional[Logger] = None,
        plotter: Optional[Callable] = None,
        save_path: str = "",
        dtype=torch.float32,
        device="cuda",
    ):
        super().__init__(model, optimizer, logger, plotter, save_path, dtype, device)
        self.buffer = buffer
        self.n_batches_buffer_sampling = n_batches_buffer_sampling
        self.w_adjust_max_clip = w_adjust_max_clip
        self.w_adjust_in_buffer_after_update = w_adjust_in_buffer_after_update

    def init_state(self, generator: torch.Generator, batch_size: int = 128) -> BufferTrainState:
        """Initialise flow and optimizer, and fill the buffer to its minimum length
        with AIS samples (unfiltered, as ``fab_tpu``'s fill is)."""
        return _fill_buffer(
            self, generator, batch_size,
            lambda b, r: self.buffer.add(b, r.point.x, r.log_w, r.point.log_q, r.mask),
        )

    def train_step(
        self, state: BufferTrainState, generator: torch.Generator, batch_size: int
    ) -> Tuple[BufferTrainState, Dict[str, Any]]:
        model, buffer, flow = self.model, self.buffer, self.model.flow
        alpha = model.alpha
        mesh.check_batch(batch_size)

        # 1. AIS pass + buffer add, the train-time filter's rejects at -inf.
        result = model.ais.sample_and_log_weights(
            state.transition_state, generator, batch_size, p_target=False, tune=True
        )
        add_mask = model.filter_batch(result.point.x, result.mask)
        filter_info = {}
        if model.sample_filter is not None:
            passed, n_valid = (add_mask & result.mask).sum(), result.mask.sum()
            if mesh.active_mesh() is not None:
                passed, n_valid = mesh.all_reduce(torch.stack([passed, n_valid]))
            filter_info["frac_filter_pass"] = passed / n_valid.clamp(min=1)
        buffer_state = buffer.add(
            state.buffer_state, result.point.x, result.log_w, result.point.log_q, add_mask
        )
        # 2. Replay batches, each [n_batches, batch, ...].
        xs, log_ws, log_q_olds, idxs = buffer.sample_n_batches(
            buffer_state, generator, batch_size, self.n_batches_buffer_sampling
        )
        # One log-q key per replay batch (a stochastic flow's noise), shared by its
        # probe, its differentiated pass and its adjustment.
        keys = [log_q_noise(flow, generator) for _ in range(self.n_batches_buffer_sampling)]
        # 3. Replay gradient steps.
        opt_state = state.opt_state
        last = None
        for x, log_w_b, log_q_old, idx, key_lq in zip(xs, log_ws, log_q_olds, idxs, keys):
            row_ok = torch.isfinite(log_w_b)  # killed / unwritten rows
            # Probe: rows whose log q is non-finite are excluded from the loss and
            # killed in the buffer, and zero-filled before the differentiated pass.
            with torch.no_grad():
                log_q_probe = flow_log_prob(flow, x, key_lq)
            row_ok = row_ok & torch.isfinite(log_q_probe)
            x = torch.where(row_ok[:, None], x, 0.0)

            log_q_x = flow_log_prob(flow, x, key_lq)
            loss, log_w_adjust, w_pre = losses_lib.buffer_replay_loss(
                log_q_x, log_q_old, alpha, self.w_adjust_max_clip, row_ok
            )
            opt_state, grad_norm, ok, loss = self._step(loss, opt_state)
            if not self.w_adjust_in_buffer_after_update:
                buffer_state = buffer.adjust(
                    buffer_state,
                    torch.where(row_ok, log_w_adjust, torch.nan),
                    log_q_x.detach(),
                    idx,
                )
            last = (loss, grad_norm, ok, w_pre, row_ok, log_q_x.detach())
        step_info: Dict[str, Any] = {}
        if last is not None:
            # fab_tpu logs the last replay batch's values.
            loss, grad_norm, ok, w_pre, row_ok, log_q_x = last
            step_info = {
                "loss": loss,
                "grad_norm": grad_norm,
                "update_applied": ok,
                "w_adjust_mean": mesh.mean_all(torch.where(row_ok, w_pre, 0.0)),
                "w_adjust_min": mesh.min_all(torch.where(row_ok, w_pre, torch.inf)),
                "w_adjust_max": mesh.max_all(torch.where(row_ok, w_pre, -torch.inf)),
                "log_q_x_mean": mesh.mean_all(torch.where(row_ok, log_q_x, 0.0)),
            }
        if self.w_adjust_in_buffer_after_update:
            # One adjustment pass over the same replay batches with the final flow:
            # the raw rows (not the zero-filled ones), as fab_tpu does.
            for x, log_w_b, log_q_old, idx, key_lq in zip(xs, log_ws, log_q_olds, idxs, keys):
                with torch.no_grad():
                    log_q_new = flow_log_prob(flow, x, key_lq)
                log_w_adjust = (1 - alpha) * (log_q_new - log_q_old)
                buffer_state = buffer.adjust(
                    buffer_state,
                    torch.where(torch.isfinite(log_w_b), log_w_adjust, torch.nan),
                    log_q_new,
                    idx,
                )

        sampled_log_w = torch.where(torch.isfinite(log_ws), log_ws, 0.0)
        info = dict(
            result.info,
            **filter_info,
            **step_info,
            sampled_log_w_mean=mesh.mean_all(sampled_log_w),
            sampled_log_w_std=mesh.std_all(sampled_log_w),
        )
        new_state = BufferTrainState(
            transition_state=result.transition_state,
            opt_state=opt_state,
            buffer_state=buffer_state,
            step=state.step + 1,
        )
        return new_state, info

    def perform_eval(
        self, state: BufferTrainState, generator: torch.Generator, i: int,
        eval_batch_size: int, batch_size: int,
    ) -> None:
        """Evaluate with AIS targeting p, then with the min-variance target
        (``fab_tpu/train.py:796-816``), and log both under suffixed keys."""
        info_p = self.model.get_eval_info(
            state.transition_state, generator, eval_batch_size, batch_size, p_target=True
        )
        info_mv = self.model.get_eval_info(
            state.transition_state, generator, eval_batch_size, batch_size,
            p_target=False, ais_only=True,
        )
        eval_info = {k + "_p_target": v for k, v in info_p.items()}
        eval_info.update({k + "_min_var_target": v for k, v in info_mv.items()})
        eval_info["step"] = i
        self.logger.write(eval_info)
