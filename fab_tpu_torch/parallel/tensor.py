"""The model axis: conditioner MLPs split across the ranks of a model group
(``fab_tpu/flows/mlp.py:70-94``, ``fab_tpu/parallel/mesh.py:116-131``).

``fab_tpu`` writes this layer as PartitionSpecs (``Flow.param_sharding``) and lets
XLA partition the program. The port writes it out, in Megatron's form:

- ``mlp_param_sharding(sizes)``: per Dense layer ``COLUMN`` (w split by columns,
  b split), ``ROW`` (w split by rows, b replicated) or None (replicated), the
  pattern of ``fab_tpu``'s ``mlp_param_sharding``: column / row pairs, and a layer
  left over after the last pair replicated.
- A column layer's input goes through ``copy_to_model`` (identity forward, model
  all-reduce of the input gradient backward): each rank's input gradient is the
  part its columns contribute. A row layer's product goes through
  ``reduce_from_model`` (model all-reduce forward, identity backward) before its
  replicated bias is added. A column / row pair costs one all-reduce forward and,
  when the input needs a gradient, one backward.
- ``gather_shards``: a split weight made whole for a kernel that takes it whole (K1
  through ``flows/fused.py``, K2 through ``flows/large_coupling.py``), as XLA
  replicates a ``pallas_call``'s operands. Its backward takes this rank's slice of
  the gradient and sums nothing: every rank of a model group computes the same
  whole-weight gradient from the same rows, so a reduce-scatter would scale it by
  n_model.
- ``shard_flow_params(flow)``: split a flow's conditioners in place, as
  ``fab_tpu``'s ``shard_flow_params`` places them. Nothing happens without a mesh or
  with ``n_model == 1``, so the plain and data-parallel paths are unchanged. Only
  modules whose ``fab_tpu`` counterpart has a split spec are split (the affine,
  spline and MADE couplings); bases (the LARS acceptance net too), ``LULinear``,
  ``ActNorm``, ``PeriodicShift``, SNF's MH layers, a defensive mixture and wrapped
  flows stay replicated.

A split module keeps the mesh it was split over, so its collectives run whether or
not a mesh is active (a batch computed whole with ``use_mesh(None)`` still reduces
over the model group). Gradients of split parameters are this rank's shards; the
trainers sum them over the data group only (``train.py``), and a global norm adds
the split tensors' squares over the model group and the replicated ones once
(``global_norm``). Checkpoints and ``convert`` see whole tensors: ``gather_state``
and ``cut_state`` move between the shards and the one-process layout.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from fab_tpu_torch.parallel import mesh as mesh_lib

COLUMN = "column"
ROW = "row"


def mlp_param_sharding(sizes: Sequence[int]) -> Tuple[Optional[str], ...]:
    """The split of each Dense layer of an MLP ``sizes`` (``fab_tpu``'s pattern):
    COLUMN, ROW or None."""
    specs: List[Optional[str]] = []
    n = len(sizes) - 1
    pending_row = False
    for i in range(n):
        if not pending_row and i + 1 < n:
            specs.append(COLUMN)
            pending_row = True
        elif pending_row:
            specs.append(ROW)
            pending_row = False
        else:
            specs.append(None)
    return tuple(specs)


# ------------------------------------------------------------ autograd Functions


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the input gradient all-reduced over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return mesh_lib.all_reduce(grad, axis=mesh_lib.MODEL_AXIS, mesh=ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """Partial products all-reduced over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh_lib.all_reduce(x, axis=mesh_lib.MODEL_AXIS, mesh=mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherShards(torch.autograd.Function):
    """The model group's shards concatenated along ``dim``; backward: this rank's
    slice of the gradient."""

    @staticmethod
    def forward(ctx, shard, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _gather(shard, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return own_shard(grad, ctx.dim, ctx.mesh), None, None


def own_shard(whole: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's slice of ``whole`` along ``dim`` (its model index's part)."""
    size = whole.shape[dim] // mesh.n_model
    return whole.narrow(dim, mesh.model_index * size, size)


def _gather(shard: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    parts = mesh_lib.all_gather_rows(shard.movedim(dim, 0), axis=mesh_lib.MODEL_AXIS,
                                     mesh=mesh)
    return parts.movedim(0, dim).contiguous()


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_shards(shard: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The whole tensor from this rank's ``shard`` (split along ``dim``); the
    gradient flows back to the shard as its slice."""
    return _GatherShards.apply(shard, dim, mesh)


class GatheredWeights:
    """Whole weights for a kernel that caches per weight (K2's prepared copies,
    ``ops/coupling_kernel.py:prepared_weight``). ``specs`` holds, per operand, None
    (replicated) or (split dim, mesh). Each split operand's whole tensor lives in one
    buffer, gathered again (in place) only when the shard's ``_version`` has moved,
    so the kernel sees the same tensor between updates and rebuilds its copies once
    per update, as with unsplit weights. No autograd here: the kernel's Function
    takes ``whole`` in its forward and ``own`` in its backward
    (``ops/coupling_kernel.py:FusedCoupling``)."""

    def __init__(self, specs: Sequence[Optional[tuple]]):
        self.specs = tuple(specs)
        self._entries: Dict[int, tuple] = {}

    def _whole(self, shard: torch.Tensor, dim: int, mesh) -> torch.Tensor:
        key = (shard.data_ptr(), shard._version)
        entry = self._entries.get(id(shard))
        if entry is not None and entry[0] == key:
            return entry[1]
        with torch.no_grad():
            whole = _gather(shard.detach(), dim, mesh)
            if entry is not None and entry[1].shape == whole.shape:
                entry[1].copy_(whole)
                whole = entry[1]
        self._entries[id(shard)] = (key, whole)
        return whole

    def whole(self, operands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every operand whole (split ones from their buffers)."""
        return [t if s is None else self._whole(t, *s) for t, s in zip(operands, self.specs)]

    def own(self, grads: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        """Whole-operand gradients -> this rank's slices of the split ones."""
        return [g if g is None or s is None else own_shard(g, *s)
                for g, s in zip(grads, self.specs)]


# ------------------------------------------------------------ flows and states


def shard_flow_params(flow, mesh=None):
    """Split ``flow``'s conditioners over the model axis of ``mesh`` (the active mesh
    unless given), in place; returns ``flow``. Nothing without a mesh, with
    ``n_model == 1``, or for a flow with no split spec (a defensive mixture, a
    wrapped flow: replicated, as ``fab_tpu`` places them)."""
    mesh = mesh_lib.active_mesh() if mesh is None else mesh
    if mesh is None or mesh.n_model == 1 or not hasattr(flow, "shard_model_axis"):
        return flow
    flow.shard_model_axis(mesh)
    return flow


def split_layers(flow) -> Dict[str, Tuple[int, object]]:
    """{parameter name: (split dim, mesh)} of every split parameter of ``flow``."""
    from fab_tpu_torch.flows.mlp import Dense

    out = {}
    for prefix, module in flow.named_modules():
        if isinstance(module, Dense) and module.split is not None:
            for name, dim in module.split_dims().items():
                out[f"{prefix}.{name}" if prefix else name] = (dim, module.mesh)
    return out


def model_mesh(flow):
    """The mesh ``flow``'s conditioners are split over, or None."""
    return next((mesh for _, mesh in split_layers(flow).values()), None)


def split_flags(flow, names: Sequence[str]) -> List[bool]:
    """For each parameter name, whether it is split (for ``global_norm``)."""
    split = split_layers(flow)
    return [n in split for n in names]


def gather_state(flow, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state`` (parameter name -> tensor shaped like the parameter: values, Adam
    moments) with every split entry made whole (one model all-gather each; every
    rank of the model group calls it)."""
    split = split_layers(flow)
    return {k: _gather(v.detach(), *split[k]) if k in split else v for k, v in state.items()}


def cut_state(flow, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state`` in the one-process layout with every split entry cut to this
    rank's shard."""
    split = split_layers(flow)
    return {k: own_shard(v, *split[k]).clone() if k in split else v for k, v in state.items()}


def global_norm(tensors: Sequence[torch.Tensor], split: Optional[Sequence[bool]] = None,
                mesh=None) -> torch.Tensor:
    """The L2 norm of the whole tree: the squares of split tensors summed over the
    model group, replicated tensors counted once. Without split tensors, the plain
    norm."""
    if not split or not any(split):
        return torch.sqrt(sum((t * t).sum() for t in tensors))
    own = sum((t * t).sum() for t, s in zip(tensors, split) if s)
    rest = sum(((t * t).sum() for t, s in zip(tensors, split) if not s),
               torch.zeros((), dtype=own.dtype, device=own.device))
    return torch.sqrt(mesh_lib.all_reduce(own, axis=mesh_lib.MODEL_AXIS, mesh=mesh) + rest)
