"""The ("data", "model") mesh over processes (``fab_tpu/parallel/mesh.py``).

``fab_tpu`` shards the particle axis of every tensor over the "data" axis of a
("data", "model") device mesh, the coupling MLPs' hidden widths over its "model"
axis, and lets XLA insert the collectives. The port runs one process per card, on
a grid of ``n_data`` x ``n_model`` processes: rank r sits at data index
r // n_model and model index r % n_model (``fab_tpu``'s
``np.asarray(devices).reshape(n_data, n_model)``). The ranks of one model group (one
data index) hold the same rows and split the conditioner weights between them
(``parallel/tensor.py``); the ranks of one data group (one model index) hold
different rows.

Data index d of n_data holds rows ``[d * B / n_data, (d + 1) * B / n_data)`` of every
tensor along the particle axis (flow samples, AIS chains, HMC and Metropolis
states, replay batches; the buffer holds L / n_data of its L slots,
``fab_tpu_torch/buffer.py``), and every reduction across that axis is a collective
over the data group: a reduction over the world would count each row n_model
times. Replicated state (the transition state, the step, Adam's count, unsplit
parameters) stays equal by construction: the same seed, all-reduced gradients,
acceptance rates reduced over the data group.

**Equal to one process by construction.** Every draw over the particle axis is made
at its global shape from the shared generator on every rank and cut to the data
index's rows (``constrain_batch``, ``draw_rows``), as ``jax.random`` draws are the
same under any sharding. Every rank's generator then moves in step with one
process's.

A batch that the data axis does not divide (an odd evaluation chunk, a plot grid)
is computed whole on every rank: ``constrain_batch`` leaves it alone, and the code
that makes one runs it with the mesh off (``use_mesh(None)``), so its reductions
stay local. A model-split flow keeps its model-axis collectives there: its modules
hold the mesh they were split over.

Without an active mesh every helper is the plain expression the one-process code
had, so that path is unchanged. With one, the reductions are collectives on the
device (no host read); ``COUNTS`` counts them by (axis, kind). With ``n_model == 1``
the data group is the whole world and no model group exists.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Collectives issued, by (axis, kind): axis "data", "model" or "world" (replicate's
# broadcast), kind "all_reduce", "all_gather" or "broadcast"; a caller zeroes it
# with COUNTS.clear().
COUNTS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``n_data`` x ``n_model`` grid over the processes of the default process
    group, this process being ``rank``; ``data_group`` / ``model_group`` are the
    process groups of this rank's column and row of the grid (None: the world, or
    no group at all for a model axis of one)."""

    n_data: int
    rank: int
    n_model: int = 1
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def data_index(self) -> int:
        """This rank's place on the data axis: which rows of a global batch it holds."""
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        """This rank's place on the model axis: which shard of a split weight it holds."""
        return self.rank % self.n_model


_ACTIVE_MESH: Optional[Mesh] = None
_DEVICE_MESHES: dict = {}
_GROUPS: dict = {}  # (n_data, n_model) -> (data groups, model groups), made once


def _grid_groups(n_data: int, n_model: int):
    """The process groups of every column (data groups, one per model index) and row
    (model groups, one per data index) of the grid. Every rank makes every group,
    in the same order, once per shape."""
    if (n_data, n_model) not in _GROUPS:
        data = [dist.new_group([d * n_model + m for d in range(n_data)])
                for m in range(n_model)]
        model = [dist.new_group([d * n_model + m for m in range(n_model)])
                 for d in range(n_data)]
        _GROUPS[(n_data, n_model)] = (data, model)
    return _GROUPS[(n_data, n_model)]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The (data, model) grid over the process group: ``n_data`` null means the
    world size over ``n_model``; n_data x n_model must equal the world size (one
    process per card). ``devices``, if given, lists the grid's cards, one per
    process in rank order, so there must be as many as processes."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: start one process per card with "
            "python3 -m torch.distributed.run and call "
            "fab_tpu_torch.parallel.initialize()"
        )
    world, n_model = dist.get_world_size(), int(n_model)
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} processes: the port runs one "
                         "process per card")
    if n_model < 1 or world % n_model:
        raise ValueError(f"mesh.n_model={n_model} does not divide the {world} processes "
                         "launched")
    n_data = world // n_model if n_data is None else int(n_data)
    if n_data * n_model != world:
        grid = f"mesh.n_data={n_data}" + (f" x mesh.n_model={n_model}" if n_model > 1 else "")
        raise ValueError(
            f"{grid} but {world} processes were launched: the port runs one process per "
            + ("data shard" if n_model == 1 else "card of the (data, model) grid"))
    rank = dist.get_rank()
    if n_model == 1:
        return Mesh(n_data, rank)
    data, model = _grid_groups(n_data, n_model)
    return Mesh(n_data, rank, n_model, data[rank % n_model], model[rank // n_model])


def activate_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Activate ``mesh`` inside the block (None: compute whole, with local
    reductions); the previous mesh comes back on exit."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def divides(n: int) -> bool:
    """Whether the data axis divides a global batch of ``n`` rows (True without a
    mesh)."""
    return _ACTIVE_MESH is None or n % _ACTIVE_MESH.n_data == 0


def check_batch(n: int, what: str = "batch_size") -> None:
    """Raise unless the data axis divides ``n``."""
    if not divides(n):
        raise ValueError(
            f"{what}={n} does not divide over the {_ACTIVE_MESH.n_data} ranks of the "
            "data axis"
        )


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows (by its data index) of a tensor whose leading axis is a
    global batch; ``x``
    itself without a mesh, for a scalar, or when the data axis does not divide it."""
    mesh = _ACTIVE_MESH
    if mesh is None or x.dim() == 0 or x.shape[0] % mesh.n_data != 0:
        return x
    b = x.shape[0] // mesh.n_data
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def constrain_tree_batch(tree: Any) -> Any:
    """``constrain_batch`` over every tensor of a tree of dicts, lists and tuples."""
    if torch.is_tensor(tree):
        return constrain_batch(tree)
    if isinstance(tree, dict):
        return {k: constrain_tree_batch(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(constrain_tree_batch(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(constrain_tree_batch(v) for v in tree)
    return tree


def draw_rows(draw: Callable, generator: torch.Generator, shape: Sequence[int], *args):
    """``draw(generator, shape, *args)`` for a tensor whose leading axis is this
    rank's rows of the particle axis: drawn at the global shape and cut to the rows,
    so every rank's generator moves as one process's does."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return draw(generator, shape, *args)
    return constrain_batch(draw(generator, (shape[0] * mesh.n_data, *shape[1:]), *args))


def global_rows(n_local: int) -> int:
    """The global batch whose rows this rank holds ``n_local`` of."""
    return n_local if _ACTIVE_MESH is None else n_local * _ACTIVE_MESH.n_data


# ---------------------------------------------------------------- collectives
# Over one axis of ``mesh`` (the active mesh unless given): "data" reduces over the
# ranks that hold other rows (the whole world when no mesh is active), "model" over
# the ranks that hold other weight shards.


def _group(mesh: Optional[Mesh], axis: str):
    mesh = _ACTIVE_MESH if mesh is None else mesh
    if axis == DATA_AXIS:
        return None if mesh is None else mesh.data_group
    if axis == MODEL_AXIS:
        return mesh.model_group
    raise ValueError(f"unknown mesh axis {axis!r}")


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, op: str = "sum", axis: str = DATA_AXIS,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """A new tensor: ``x`` reduced elementwise over the ranks of ``axis`` (sum, max
    or min)."""
    group = _group(mesh, axis)
    COUNTS[(axis, "all_reduce")] += 1
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def all_gather_rows(x: torch.Tensor, axis: str = DATA_AXIS,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` stacked along the leading axis, in rank order.
    On gloo (which takes no gather into one tensor of a CUDA tensor) the gather is
    into a list."""
    group = _group(mesh, axis)
    COUNTS[(axis, "all_gather")] += 1
    n = dist.get_world_size(group)
    x = x.contiguous()
    if dist.get_backend(group) == "gloo":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def replicate(tree: Any) -> Any:
    """Rank 0's ``tree`` (any picklable value) on every rank of the world, as one
    object broadcast; ``tree`` itself without a mesh."""
    if _ACTIVE_MESH is None:
        return tree
    COUNTS[("world", "broadcast")] += 1
    box = [tree]
    dist.broadcast_object_list(box, 0)
    return box[0]


def device_mesh(mesh: Optional[Mesh] = None):
    """The ``torch.distributed`` DeviceMesh of the (data, model) grid (for DTensor
    checkpoints), made once per backend and shape."""
    mesh = _ACTIVE_MESH if mesh is None else mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    key = (device_type, mesh.n_data, mesh.n_model)
    if key not in _DEVICE_MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        _DEVICE_MESHES[key] = init_device_mesh(
            device_type, (mesh.n_data, mesh.n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return _DEVICE_MESHES[key]


# ------------------------------------------------------- reductions over rows
# Each gives the value over the global batch on every rank. Without a mesh each is
# the one-process expression.


def sum_all(x: torch.Tensor) -> torch.Tensor:
    """The sum of every element."""
    s = x.sum()
    return s if _ACTIVE_MESH is None else all_reduce(s)


def max_all(x: torch.Tensor) -> torch.Tensor:
    m = x.max()
    return m if _ACTIVE_MESH is None else all_reduce(m, "max")


def min_all(x: torch.Tensor) -> torch.Tensor:
    m = x.min()
    return m if _ACTIVE_MESH is None else all_reduce(m, "min")


def mean_all(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element."""
    if _ACTIVE_MESH is None:
        return x.mean()
    return all_reduce(x.sum()) / (x.numel() * _ACTIVE_MESH.n_data)


def std_all(x: torch.Tensor) -> torch.Tensor:
    """The population standard deviation of every element (two passes)."""
    if _ACTIVE_MESH is None:
        return x.std(correction=0)
    mu = mean_all(x)
    return torch.sqrt(mean_all((x - mu) ** 2))


def masked_mean(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean of ``vals`` over the rows ``mask`` keeps (0 rows count as 1)."""
    total = torch.where(mask, vals, 0.0).sum()
    count = mask.sum()
    if _ACTIVE_MESH is not None:
        total, count = all_reduce(torch.stack([total, count.to(total.dtype)]))
    return total / count.clamp(min=1)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the (1-D) global batch."""
    if _ACTIVE_MESH is None:
        return torch.logsumexp(x, 0)
    m = max_all(x)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return torch.log(sum_all(torch.exp(x - m))) + m


def softmax(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the softmax over the (1-D) global batch."""
    if _ACTIVE_MESH is None:
        return torch.softmax(x, dim=0)
    return torch.exp(x - logsumexp(x))


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest value of the (1-D) global batch."""
    if _ACTIVE_MESH is None:
        return torch.topk(x, k).values.min()
    top = torch.topk(x, min(k, x.shape[0])).values
    return torch.topk(all_gather_rows(top), k).values.min()


# ---------------------------------------------------------- shares of a loss
# A loss over the global batch is written as a sum over ranks of shares: each
# share's value and gradient come from this rank's rows, so the all-reduced shares
# and gradients are the loss and its gradient (``train.py`` reduces both in one
# bucket).


def share_mean(v: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's share of the mean of ``v`` over the (masked) global batch."""
    if _ACTIVE_MESH is None:
        if mask is None:
            return v.mean()
        return torch.where(mask, v, 0.0).sum() / mask.sum().clamp(min=1)
    if mask is None:
        return v.sum() / global_rows(v.shape[0])
    return torch.where(mask, v, 0.0).sum() / sum_all(mask).clamp(min=1)


def share_logsumexp(v: torch.Tensor) -> torch.Tensor:
    """This rank's share of logsumexp over the (1-D) global batch: its gradient is
    sum over the rank's rows of softmax(v) dv, its value logsumexp / n."""
    if _ACTIVE_MESH is None:
        return torch.logsumexp(v, 0)
    lse = logsumexp(v.detach())
    w = torch.exp(v.detach() - lse)
    own = (w * torch.where(w > 0, v, 0.0)).sum()
    share = own + (lse / _ACTIVE_MESH.n_data - own).detach()
    return torch.where(torch.isfinite(lse), share, lse / _ACTIVE_MESH.n_data)
