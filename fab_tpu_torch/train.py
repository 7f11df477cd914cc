"""Prioritised-buffer FAB trainer, guarded update and optimizer (``fab_tpu/train.py``).

The optimizer is a small functional Adam with global-norm clipping that keeps
the JAX package's semantics (``fab_tpu/train.py:57-156``), which ``torch.optim``
does not:

- ``clip_by_global_norm`` scales by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm`` (no ``+1e-6`` in the divisor);
- ``guarded_update`` takes the grad norm before clipping, scrubs NaN grads, and on
  a skipped step (non-finite loss, grad norm or update) leaves the parameters and
  the whole optimizer state, Adam's count included, unchanged. The skip is a
  ``torch.where`` select, so no step waits for the device.

The run loop, evaluation and checkpoints are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from fab_tpu_torch import losses as losses_lib
from fab_tpu_torch.buffer import PrioritisedBufferState, PrioritisedReplayBuffer
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows.base import flow_log_prob
from fab_tpu_torch.model import FABModel


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((t * t).sum() for t in tensors))


@dataclasses.dataclass(frozen=True)
class ClippedAdam:
    """Global-norm clipping then Adam, with a constant lr (``fab_tpu/train.py:146-156``)."""

    lr: float
    max_gradient_norm: Optional[float] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        zeros = lambda: [torch.zeros_like(p) for p in params]
        count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        return AdamState(count, zeros(), zeros())

    def update(
        self, grads: Sequence[torch.Tensor], state: AdamState
    ) -> Tuple[List[torch.Tensor], AdamState]:
        if self.max_gradient_norm is not None:
            g_norm = global_norm(grads)
            trigger = g_norm < self.max_gradient_norm
            grads = [
                torch.where(trigger, g, g / g_norm * self.max_gradient_norm) for g in grads
            ]
        mu = [(1 - self.b1) * g + self.b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - self.b2) * g * g + self.b2 * v for g, v in zip(grads, state.nu)]
        count = torch.where(
            state.count < 2**31 - 1, state.count + 1, state.count
        ).to(torch.int32)
        updates = []
        for m, v in zip(mu, nu):
            c = count.to(m.dtype)
            m_hat = m / (1 - self.b1**c)
            v_hat = v / (1 - self.b2**c)
            updates.append(-self.lr * (m_hat / (torch.sqrt(v_hat) + self.eps)))
        return updates, AdamState(count, mu, nu)


def make_optimizer(lr: float, max_gradient_norm: Optional[float] = None) -> ClippedAdam:
    """Constant-LR Adam with optional global-norm clipping. The LR schedules and
    Adamax of ``fab_tpu/train.py:make_optimizer`` are not ported yet."""
    return ClippedAdam(
        float(lr), None if max_gradient_norm is None else float(max_gradient_norm)
    )


def _all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def guarded_update(
    optimizer: ClippedAdam,
    grads: Sequence[torch.Tensor],
    opt_state: AdamState,
    params: Sequence[torch.Tensor],
    loss: torch.Tensor,
) -> Tuple[AdamState, torch.Tensor, torch.Tensor]:
    """Apply an optimizer update to ``params`` in place unless loss/grads are
    non-finite. Returns (new_opt_state, grad_norm, applied)."""
    grad_norm = global_norm(grads)
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    safe_grads = [torch.nan_to_num(g) for g in grads]
    updates, new_state = optimizer.update(safe_grads, opt_state)
    ok = ok & _all_finite(updates)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.copy_(torch.where(ok, p + u, p))
    new_state = AdamState(
        torch.where(ok, new_state.count, opt_state.count),
        [torch.where(ok, a, b) for a, b in zip(new_state.mu, opt_state.mu)],
        [torch.where(ok, a, b) for a, b in zip(new_state.nu, opt_state.nu)],
    )
    return new_state, grad_norm, ok


class BufferTrainState(NamedTuple):
    transition_state: Dict[str, torch.Tensor]
    opt_state: AdamState
    buffer_state: PrioritisedBufferState
    step: int


class PrioritisedBufferTrainer:
    """FAB + prioritised replay buffer (``fab_tpu/train.py:557-784``).

    The flow's parameters live in ``model.flow`` and are updated in place. Per
    iteration:
      1. an AIS pass targeting g = p^alpha q^(1-alpha), added to the buffer;
      2. one Gumbel-top-k draw of n_batches_buffer_sampling x batch rows;
      3. per replay batch: a no-grad probe of log q (non-finite rows are masked and
         zero-filled), a guarded gradient step on the w-adjusted loss, and the
         priority adjustment.
    """

    def __init__(
        self,
        model: FABModel,
        optimizer: ClippedAdam,
        buffer: PrioritisedReplayBuffer,
        n_batches_buffer_sampling: int = 2,
        w_adjust_max_clip: Optional[float] = 10.0,
        dtype=torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.buffer = buffer
        self.n_batches_buffer_sampling = n_batches_buffer_sampling
        self.w_adjust_max_clip = w_adjust_max_clip
        self.dtype = dtype
        self.model.flow.to(device=self.device, dtype=dtype)

    @property
    def params(self) -> List[torch.nn.Parameter]:
        """The flow's trainable parameters, in the optimizer state's order."""
        return [p for p in self.model.flow.parameters() if p.requires_grad]

    def init_state(self, generator: torch.Generator, batch_size: int = 128) -> BufferTrainState:
        """Initialise flow and optimizer, and fill the buffer to its minimum length
        with AIS samples."""
        transition_state = self.model.init(generator)
        buffer_state = self.buffer.init(self.dtype, self.device)
        while int(buffer_state.n_added) < self.buffer.min_sample_length:
            result = self.model.ais.sample_and_log_weights(
                transition_state, generator, batch_size, p_target=False, tune=True
            )
            transition_state = result.transition_state
            buffer_state = self.buffer.add(
                buffer_state, result.point.x, result.log_w, result.point.log_q,
                result.mask,
            )
        return BufferTrainState(
            transition_state=transition_state,
            opt_state=self.optimizer.init(self.params),
            buffer_state=buffer_state,
            step=0,
        )

    def train_step(
        self, state: BufferTrainState, generator: torch.Generator, batch_size: int
    ) -> Tuple[BufferTrainState, Dict[str, Any]]:
        model, buffer, flow = self.model, self.buffer, self.model.flow
        alpha = model.alpha
        params = self.params

        # 1. AIS pass + buffer add.
        result = model.ais.sample_and_log_weights(
            state.transition_state, generator, batch_size, p_target=False, tune=True
        )
        buffer_state = buffer.add(
            state.buffer_state, result.point.x, result.log_w, result.point.log_q,
            result.mask,
        )
        # 2. Replay batches, each [n_batches, batch, ...].
        xs, log_ws, log_q_olds, idxs = buffer.sample_n_batches(
            buffer_state, generator, batch_size, self.n_batches_buffer_sampling
        )
        # 3. Replay gradient steps.
        opt_state = state.opt_state
        step_info: Dict[str, Any] = {}
        for x, log_w_b, log_q_old, idx in zip(xs, log_ws, log_q_olds, idxs):
            row_ok = torch.isfinite(log_w_b)  # killed / unwritten rows
            # Probe: rows whose log q is non-finite are excluded from the loss and
            # killed in the buffer, and zero-filled before the differentiated pass.
            with torch.no_grad():
                log_q_probe = flow_log_prob(flow, x)
            row_ok = row_ok & torch.isfinite(log_q_probe)
            x = torch.where(row_ok[:, None], x, 0.0)

            log_q_x = flow_log_prob(flow, x)
            loss, log_w_adjust, w_pre = losses_lib.buffer_replay_loss(
                log_q_x, log_q_old, alpha, self.w_adjust_max_clip, row_ok
            )
            grads = torch.autograd.grad(loss, params)
            opt_state, grad_norm, ok = guarded_update(
                self.optimizer, grads, opt_state, params, loss
            )
            buffer_state = buffer.adjust(
                buffer_state,
                torch.where(row_ok, log_w_adjust, torch.nan),
                log_q_x.detach(),
                idx,
            )
            # fab_tpu logs the last replay batch's values.
            step_info = {
                "loss": loss.detach(),
                "grad_norm": grad_norm,
                "update_applied": ok,
                "w_adjust_mean": torch.where(row_ok, w_pre, 0.0).mean(),
                "w_adjust_min": torch.where(row_ok, w_pre, torch.inf).min(),
                "w_adjust_max": torch.where(row_ok, w_pre, -torch.inf).max(),
                "log_q_x_mean": torch.where(row_ok, log_q_x.detach(), 0.0).mean(),
            }

        sampled_log_w = torch.where(torch.isfinite(log_ws), log_ws, 0.0)
        info = dict(
            result.info,
            **step_info,
            sampled_log_w_mean=sampled_log_w.mean(),
            sampled_log_w_std=sampled_log_w.std(correction=0),
        )
        new_state = BufferTrainState(
            transition_state=result.transition_state,
            opt_state=opt_state,
            buffer_state=buffer_state,
            step=state.step + 1,
        )
        return new_state, info
