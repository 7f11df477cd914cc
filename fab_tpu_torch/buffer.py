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

**Sharded rows.** Under a data mesh of n ranks (``parallel/mesh.py``) each rank holds
L / n of the L slots (r below is the rank's data index; the ranks of one model group
hold equal shards, and every collective here runs over the data group); ``cursor`` and ``n_added`` stay global (replicated). Slot
indices handed out (``sample``'s indices, ``adjust``'s) are the one-process slots.
With B the rows of each add (``batch_size``) and b = B / n, global slot
g = q B + r b + i (0 <= i < b) lives on rank r at local slot m = q b + i. Rank r
holds rows [r b, (r + 1) b) of every AIS batch, and one process writes batch row
j at slot cursor + j, so each rank's rows of an add land in its own shard at local
slots cursor / n + i: ``add`` moves no row. It needs L and the cursor to be
multiples of B (the cursor only ever moves by B). With one rank g = m.

- ``sample``: the Gumbel noise is drawn over the L global slots in the one-process
  order on every rank and cut to the rank's slots; each rank takes its local top-k
  and all-gathers (value, slot, row); the merged top-k is the one-process draw, and
  each rank keeps its rows of every replay batch. With replacement, each of the K
  categorical draws takes its best slot per rank, then the best rank.
- ``adjust``: every rank's (slot, adjustment, log q) is all-gathered and each rank
  applies those of the slots it owns.
- ``gather`` / ``scatter``: the one-process layout, for checkpoints that cross
  world sizes and packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from fab_tpu_torch import random
from fab_tpu_torch.parallel import mesh as mesh_lib


class PrioritisedBufferState(NamedTuple):
    """Ring storage: x [N, D], log_w [N] (priority), log_q_old [N], cursor, n_added."""

    x: torch.Tensor
    log_w: torch.Tensor
    log_q_old: torch.Tensor
    cursor: torch.Tensor  # int32 scalar: next write position
    n_added: torch.Tensor  # int32 scalar: rows ever written (saturating)


def _saturating_add(n_added: torch.Tensor, batch: int) -> torch.Tensor:
    return (n_added.to(torch.int64) + batch).clamp(max=2**31 - 1).to(torch.int32)


class _ShardedSlots:
    """The slot layout of one buffer on the active mesh (see the module docstring)."""

    def __init__(self, buffer, mesh):
        self.n, self.rank = mesh.n_data, mesh.data_index
        self.length = buffer.max_length
        if self.n > 1:
            B = buffer.batch_size
            if B is None or B % self.n or self.length % B:
                raise ValueError(
                    f"a buffer sharded over {self.n} ranks needs batch_size (the rows of "
                    f"each add, here {B}) divisible by {self.n} and dividing max_length "
                    f"({self.length})"
                )
            self.B, self.b = B, B // self.n
        self.local_length = self.length // self.n

    def global_slots(self, device) -> torch.Tensor:
        """The one-process slot of each of this rank's local slots."""
        m = torch.arange(self.local_length, device=device)
        if self.n == 1:
            return m
        return (m // self.b) * self.B + self.rank * self.b + m % self.b

    def owner_and_local(self, g: torch.Tensor):
        """(rank, local slot) of one-process slots ``g``."""
        if self.n == 1:
            return torch.zeros_like(g), g
        return (g // self.b) % self.n, (g // self.B) * self.b + g % self.b

    def write_index(self, cursor: torch.Tensor, rows: int, device) -> torch.Tensor:
        """Local slots of this rank's ``rows`` rows of an add at ``cursor``."""
        start = cursor if self.n == 1 else cursor // self.n
        return (torch.arange(rows, device=device) + start) % self.local_length

    # ---------------------------------------------------------- collectives

    def draw(self, rows, log_w, generator, n_batches, batch_size, with_replacement):
        """The one-process draw of n_batches x batch_size slots by priority
        ``log_w`` (this rank's slots), merged across ranks; this rank's rows of each
        replay batch: (fields of ``rows`` at the drawn slots, slots), each
        [n_batches, batch_size / n, ...]."""
        mesh_lib.check_batch(batch_size, "replay batch_size")
        device, dtype = log_w.device, log_w.dtype
        K = n_batches * batch_size
        slots = self.global_slots(device)
        if with_replacement:
            # categorical's Gumbel-max over [K, L]: the best slot per rank, then rank.
            g = random.gumbel(generator, (K, self.length), dtype, device)
            value, loc = (g[:, slots] + log_w).max(dim=1)
        else:
            g = random.gumbel(generator, (self.length,), dtype, device)
            perturbed = torch.where(torch.isfinite(log_w), log_w + g[slots], -math.inf)
            value, loc = torch.topk(perturbed, min(K, self.local_length))
        payload = torch.cat(
            [value[:, None].double(), slots[loc][:, None].double()]
            + [f[loc].reshape(loc.shape[0], -1).double() for f in rows], dim=1)
        gathered = mesh_lib.all_gather_rows(payload)
        if with_replacement:
            gathered = gathered.reshape(self.n, K, -1)
            best = gathered[..., 0].argmax(0)
            merged = gathered[best, torch.arange(K, device=device)]
        else:
            merged = gathered[torch.topk(gathered[:, 0], K).indices]
        b = batch_size // self.n
        mine = merged.reshape(n_batches, batch_size, -1)[:, self.rank * b:(self.rank + 1) * b]
        out, col = [], 2
        for f in rows:
            width = f[0].numel()
            out.append(mine[..., col:col + width].reshape(
                (n_batches, b) + tuple(f.shape[1:])).to(f.dtype))
            col += width
        return out, mine[..., 1].long()

    def adjust(self, log_w, log_q_old, slots, adjustment, log_q):
        """All-gather every rank's (slot, adjustment, log q) and apply, on this
        rank, those of the slots it owns (``PrioritisedReplayBuffer.adjust``'s
        update); the others go to a pad slot that is dropped. New (log_w,
        log_q_old)."""
        payload = torch.stack([slots.reshape(-1).double(), adjustment.reshape(-1).double(),
                               log_q.reshape(-1).double()], dim=1)
        gathered = mesh_lib.all_gather_rows(payload)
        owner, local = self.owner_and_local(gathered[:, 0].long())
        mine = owner == self.rank
        at = torch.where(mine, local, 0)
        adjustment, log_q = gathered[:, 1].to(log_w.dtype), gathered[:, 2].to(log_w.dtype)
        valid = torch.isfinite(adjustment) & torch.isfinite(log_q)
        new_log_w = torch.where(valid, log_w[at] + adjustment, -math.inf)
        new_log_q = torch.where(valid, log_q, log_q_old[at])
        target = torch.where(mine, local, self.local_length)
        out = []
        for field, value in ((log_w, new_log_w), (log_q_old, new_log_q)):
            padded = torch.cat([field, field[:1]])
            padded.index_put_((target,), value)
            out.append(padded[:-1])
        return out

    def gather(self, rows):
        """Every slot of ``rows`` (this rank's local fields) in the one-process
        layout, on every rank (one all-gather; values pass through float64)."""
        local = self.local_length
        payload = torch.cat([f.reshape(local, -1).double() for f in rows], dim=1)
        gathered = mesh_lib.all_gather_rows(payload)
        owner, m = self.owner_and_local(torch.arange(self.length, device=payload.device))
        full = gathered[owner * local + m]
        out, col = [], 0
        for f in rows:
            width = f[0].numel() if f.dim() > 1 else 1
            out.append(full[:, col:col + width].reshape((self.length,) + tuple(f.shape[1:]))
                       .to(f.dtype))
            col += width
        return out

    def scatter(self, rows):
        """This rank's slots of one-process-layout fields."""
        slots = self.global_slots(rows[0].device)
        return [f[slots] for f in rows]


def _layout(buffer) -> Optional[_ShardedSlots]:
    mesh = mesh_lib.active_mesh()
    return None if mesh is None else _ShardedSlots(buffer, mesh)


@dataclasses.dataclass(frozen=True)
class PrioritisedReplayBuffer:
    """``batch_size``: the rows of each add (the AIS batch); a buffer sharded over
    more than one rank lays its slots out by it (module docstring)."""

    dim: int
    max_length: int
    min_sample_length: int
    sample_with_replacement: bool = False
    batch_size: Optional[int] = None

    def __post_init__(self):
        if not self.min_sample_length < self.max_length:
            raise ValueError("min_sample_length must be below max_length")

    def init(self, dtype=torch.float32, device=None) -> PrioritisedBufferState:
        layout = _layout(self)
        n = self.max_length if layout is None else layout.local_length
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
        """Ring-write a batch (this rank's rows of it under a mesh); invalid rows
        consume slots with priority -inf."""
        layout = _layout(self)
        rows = x.shape[0]
        if mask is not None:
            log_w = torch.where(mask, log_w, -math.inf)
        log_w = torch.where(torch.isfinite(log_w), log_w, -math.inf)
        if layout is None:
            idx = (torch.arange(rows, device=x.device) + state.cursor) % self.max_length
            batch = rows
        else:
            idx = layout.write_index(state.cursor, rows, x.device)
            batch = rows * layout.n
        return PrioritisedBufferState(
            x=state.x.index_put((idx,), x.detach()),
            log_w=state.log_w.index_put((idx,), log_w.detach()),
            log_q_old=state.log_q_old.index_put((idx,), log_q_old.detach()),
            cursor=(state.cursor + batch) % self.max_length,
            n_added=_saturating_add(state.n_added, batch),
        )

    def sample(
        self, state: PrioritisedBufferState, generator: torch.Generator, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Priority ~ softmax(log_w): without replacement by Gumbel-top-k, or with
        replacement by a categorical draw. Returns (x, log_w, log_q_old, indices):
        under a mesh this rank's rows of the global ``batch_size``, indices being
        one-process slots."""
        if _layout(self) is not None:
            return tuple(a[0] for a in self.sample_n_batches(state, generator, batch_size, 1))
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
        layout = _layout(self)
        if layout is not None:
            (x, log_w, log_q_old), slots = layout.draw(
                (state.x, state.log_w, state.log_q_old), state.log_w, generator,
                n_batches, batch_size, self.sample_with_replacement)
            return x, log_w, log_q_old, slots
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
        layout = _layout(self)
        if layout is not None:
            log_w, log_q_old = layout.adjust(state.log_w, state.log_q_old, indices,
                                             log_w_adjustment.detach(), log_q.detach())
            return state._replace(log_w=log_w, log_q_old=log_q_old)
        valid = torch.isfinite(log_w_adjustment) & torch.isfinite(log_q)
        new_log_w = torch.where(valid, state.log_w[indices] + log_w_adjustment, -math.inf)
        new_log_q = torch.where(valid, log_q, state.log_q_old[indices])
        return state._replace(
            log_w=state.log_w.index_put((indices,), new_log_w.detach()),
            log_q_old=state.log_q_old.index_put((indices,), new_log_q.detach()),
        )

    def gather(self, state: PrioritisedBufferState) -> PrioritisedBufferState:
        """The state in the one-process layout, on every rank (a collective under a
        mesh; ``state`` itself without one)."""
        layout = _layout(self)
        if layout is None:
            return state
        x, log_w, log_q_old = layout.gather((state.x, state.log_w, state.log_q_old))
        return state._replace(x=x, log_w=log_w, log_q_old=log_q_old)

    def scatter(self, state: PrioritisedBufferState) -> PrioritisedBufferState:
        """This rank's shard of a one-process-layout state (no collective)."""
        layout = _layout(self)
        if layout is None:
            return state
        _check_cursor(state, layout)
        x, log_w, log_q_old = layout.scatter((state.x, state.log_w, state.log_q_old))
        return state._replace(x=x, log_w=log_w, log_q_old=log_q_old)


def _check_cursor(state, layout: _ShardedSlots) -> None:
    if layout.n > 1 and int(state.cursor) % layout.B:
        raise ValueError(
            f"a buffer sharded over {layout.n} ranks needs its cursor ({int(state.cursor)}) "
            f"to be a multiple of its batch_size ({layout.B})"
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
    """``batch_size``: the rows of each add, as for ``PrioritisedReplayBuffer``."""

    dim: int
    max_length: int
    min_sample_length: int
    temperature: float = 0.0  # recency weighting (1/rank)^temperature
    batch_size: Optional[int] = None

    def __post_init__(self):
        if not self.min_sample_length <= self.max_length:
            raise ValueError("min_sample_length must not exceed max_length")

    def init(self, dtype=torch.float32, device=None) -> UniformBufferState:
        layout = _layout(self)
        n = self.max_length if layout is None else layout.local_length
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
        """Ring-write a batch (this rank's rows of it under a mesh); masked rows get
        log_w -inf."""
        layout = _layout(self)
        rows = x.shape[0]
        if mask is not None:
            log_w = torch.where(mask, log_w, -math.inf)
        order = torch.arange(rows, device=x.device)
        if layout is None:
            idx = (order + state.cursor) % self.max_length
            batch = rows
        else:
            idx = layout.write_index(state.cursor, rows, x.device)
            batch = rows * layout.n
            order = order + layout.rank * rows  # the rows' places in the global batch
        return UniformBufferState(
            x=state.x.index_put((idx,), x.detach().to(state.x.dtype)),
            log_w=state.log_w.index_put((idx,), log_w.detach().to(state.log_w.dtype)),
            add_count=state.add_count.index_put((idx,), (state.n_added + order).to(torch.int32)),
            cursor=(state.cursor + batch) % self.max_length,
            n_added=_saturating_add(state.n_added, batch),
        )

    def sample(
        self, state: UniformBufferState, generator: torch.Generator, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch_size rows with replacement, by recency weight over the written rows.
        Returns (x, log_w): under a mesh this rank's rows of the global batch."""
        written = state.add_count >= 0
        rank = (state.n_added - state.add_count).to(torch.float32)
        logits = torch.where(written, -self.temperature * torch.log(rank), -math.inf)
        layout = _layout(self)
        if layout is not None:
            (x, log_w), _ = layout.draw((state.x, state.log_w), logits, generator, 1,
                                        batch_size, with_replacement=True)
            return x[0], log_w[0]
        indices = random.categorical(generator, logits, batch_size)
        return state.x[indices], state.log_w[indices]

    def gather(self, state: UniformBufferState) -> UniformBufferState:
        """The state in the one-process layout (as ``PrioritisedReplayBuffer``'s)."""
        layout = _layout(self)
        if layout is None:
            return state
        x, log_w, add_count = layout.gather((state.x, state.log_w, state.add_count))
        return state._replace(x=x, log_w=log_w, add_count=add_count)

    def scatter(self, state: UniformBufferState) -> UniformBufferState:
        """This rank's shard of a one-process-layout state."""
        layout = _layout(self)
        if layout is None:
            return state
        _check_cursor(state, layout)
        x, log_w, add_count = layout.scatter((state.x, state.log_w, state.add_count))
        return state._replace(x=x, log_w=log_w, add_count=add_count)
