"""Replay buffers as fixed-shape device tensors (``fab_tpu/buffer.py``).

``PrioritisedReplayBuffer``:
- add: ring write at (arange + cursor) % max_length; invalid rows get priority -inf.
- sample: priority ~ softmax(log_w), without replacement by Gumbel-top-k, or with
  replacement (``sample_with_replacement``) by a categorical draw; unwritten and
  killed rows carry -inf and are never drawn while finite rows remain.
- adjust: log_w += adjustment and log_q_old refreshed at the sampled rows; rows whose
  adjustment or log q is non-finite are killed (priority -inf).

``ReplayBuffer`` (for ``BufferTrainer``): a ring of (x, log_w) rows drawn with
replacement, by recency weight (1 / rank)^temperature over the written rows (rank 1
is the newest).

Every method returns a new state and leaves its argument untouched.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from fab_tpu_torch import random


class PrioritisedBufferState(NamedTuple):
    """Ring storage: x [N, D], log_w [N] (priority), log_q_old [N], cursor, n_added."""

    x: torch.Tensor
    log_w: torch.Tensor
    log_q_old: torch.Tensor
    cursor: torch.Tensor  # int32 scalar: next write position
    n_added: torch.Tensor  # int32 scalar: rows ever written (saturating)


@dataclasses.dataclass(frozen=True)
class PrioritisedReplayBuffer:
    dim: int
    max_length: int
    min_sample_length: int
    sample_with_replacement: bool = False

    def __post_init__(self):
        if not self.min_sample_length < self.max_length:
            raise ValueError("min_sample_length must be below max_length")

    def init(self, dtype=torch.float32, device=None) -> PrioritisedBufferState:
        n = self.max_length
        return PrioritisedBufferState(
            x=torch.zeros((n, self.dim), dtype=dtype, device=device),
            log_w=torch.full((n,), -math.inf, dtype=dtype, device=device),
            log_q_old=torch.zeros((n,), dtype=dtype, device=device),
            cursor=torch.zeros((), dtype=torch.int32, device=device),
            n_added=torch.zeros((), dtype=torch.int32, device=device),
        )

    def can_sample(self, state: PrioritisedBufferState) -> torch.Tensor:
        return state.n_added >= self.min_sample_length

    def add(
        self,
        state: PrioritisedBufferState,
        x: torch.Tensor,
        log_w: torch.Tensor,
        log_q_old: torch.Tensor,
        mask: torch.Tensor = None,
    ) -> PrioritisedBufferState:
        """Ring-write a batch; invalid rows consume slots with priority -inf."""
        batch = x.shape[0]
        if mask is not None:
            log_w = torch.where(mask, log_w, -math.inf)
        log_w = torch.where(torch.isfinite(log_w), log_w, -math.inf)
        idx = (torch.arange(batch, device=x.device) + state.cursor) % self.max_length
        return PrioritisedBufferState(
            x=state.x.index_put((idx,), x.detach()),
            log_w=state.log_w.index_put((idx,), log_w.detach()),
            log_q_old=state.log_q_old.index_put((idx,), log_q_old.detach()),
            cursor=(state.cursor + batch) % self.max_length,
            n_added=(state.n_added.to(torch.int64) + batch)
            .clamp(max=2**31 - 1)
            .to(torch.int32),
        )

    def sample(
        self, state: PrioritisedBufferState, generator: torch.Generator, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Priority ~ softmax(log_w): without replacement by Gumbel-top-k, or with
        replacement by a categorical draw. Returns (x, log_w, log_q_old, indices)."""
        if self.sample_with_replacement:
            indices = random.categorical(generator, state.log_w, batch_size)
        else:
            g = random.gumbel(
                generator, state.log_w.shape, state.log_w.dtype, state.log_w.device
            )
            perturbed = torch.where(torch.isfinite(state.log_w), state.log_w + g, -math.inf)
            indices = torch.topk(perturbed, batch_size).indices
        return state.x[indices], state.log_w[indices], state.log_q_old[indices], indices

    def sample_n_batches(
        self,
        state: PrioritisedBufferState,
        generator: torch.Generator,
        batch_size: int,
        n_batches: int,
    ):
        """One draw of n_batches * batch_size rows, chunked to a leading n_batches axis."""
        out = self.sample(state, generator, batch_size * n_batches)
        return tuple(a.reshape((n_batches, batch_size) + a.shape[1:]) for a in out)

    def adjust(
        self,
        state: PrioritisedBufferState,
        log_w_adjustment: torch.Tensor,
        log_q: torch.Tensor,
        indices: torch.Tensor,
    ) -> PrioritisedBufferState:
        """log_w += adjustment, log_q_old <- log q at ``indices``; kill non-finite rows."""
        valid = torch.isfinite(log_w_adjustment) & torch.isfinite(log_q)
        new_log_w = torch.where(valid, state.log_w[indices] + log_w_adjustment, -math.inf)
        new_log_q = torch.where(valid, log_q, state.log_q_old[indices])
        return state._replace(
            log_w=state.log_w.index_put((indices,), new_log_w.detach()),
            log_q_old=state.log_q_old.index_put((indices,), new_log_q.detach()),
        )


class UniformBufferState(NamedTuple):
    """Ring storage: x [N, D], log_w [N], add_count [N] (insertion counter per row,
    -1 unwritten), cursor, n_added."""

    x: torch.Tensor
    log_w: torch.Tensor
    add_count: torch.Tensor
    cursor: torch.Tensor
    n_added: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ReplayBuffer:
    dim: int
    max_length: int
    min_sample_length: int
    temperature: float = 0.0  # recency weighting (1/rank)^temperature

    def __post_init__(self):
        if not self.min_sample_length <= self.max_length:
            raise ValueError("min_sample_length must not exceed max_length")

    def init(self, dtype=torch.float32, device=None) -> UniformBufferState:
        n = self.max_length
        return UniformBufferState(
            x=torch.zeros((n, self.dim), dtype=dtype, device=device),
            log_w=torch.full((n,), -math.inf, dtype=dtype, device=device),
            add_count=torch.full((n,), -1, dtype=torch.int32, device=device),
            cursor=torch.zeros((), dtype=torch.int32, device=device),
            n_added=torch.zeros((), dtype=torch.int32, device=device),
        )

    def can_sample(self, state: UniformBufferState) -> torch.Tensor:
        return state.n_added >= self.min_sample_length

    def add(
        self,
        state: UniformBufferState,
        x: torch.Tensor,
        log_w: torch.Tensor,
        mask: torch.Tensor = None,
    ) -> UniformBufferState:
        """Ring-write a batch; masked rows get log_w -inf."""
        batch = x.shape[0]
        if mask is not None:
            log_w = torch.where(mask, log_w, -math.inf)
        rows = torch.arange(batch, device=x.device)
        idx = (rows + state.cursor) % self.max_length
        return UniformBufferState(
            x=state.x.index_put((idx,), x.detach().to(state.x.dtype)),
            log_w=state.log_w.index_put((idx,), log_w.detach().to(state.log_w.dtype)),
            add_count=state.add_count.index_put((idx,), (state.n_added + rows).to(torch.int32)),
            cursor=(state.cursor + batch) % self.max_length,
            n_added=(state.n_added.to(torch.int64) + batch)
            .clamp(max=2**31 - 1)
            .to(torch.int32),
        )

    def sample(
        self, state: UniformBufferState, generator: torch.Generator, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch_size rows with replacement, by recency weight over the written rows.
        Returns (x, log_w)."""
        written = state.add_count >= 0
        rank = (state.n_added - state.add_count).to(torch.float32)
        logits = torch.where(written, -self.temperature * torch.log(rank), -math.inf)
        indices = random.categorical(generator, logits, batch_size)
        return state.x[indices], state.log_w[indices]
