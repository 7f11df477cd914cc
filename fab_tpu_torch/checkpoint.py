"""Single-host pickle checkpoints (``fab_tpu/checkpoint.py``).

One file per checkpoint, ``<dir>/iter_<n>/state.pkl``, written to a ``.tmp`` file
and renamed into place. The file holds plain dicts, lists and tuples of numpy
arrays and Python scalars (tensors are copied to the host on save), never pickled
torch or port classes, so the layout is the repository's JAX package's and a
checkpoint written by either package loads in the other.

``load_checkpoint`` rebuilds only Python's and numpy's own types. Any other class
in the file (the JAX package pickles its optimizer and buffer states as named
tuples of its libraries) loads as an ``Opaque`` record of its module, name and
arguments, so reading such a file imports nothing of those libraries; the flow
parameters, transition state and step are plain data either way. Unpickling numpy
objects still runs code: only load files that a trusted run wrote.

The sharded backend (``fab_tpu``'s orbax pair) is ``save_checkpoint_dcp`` /
``load_checkpoint_dcp`` over ``torch.distributed.checkpoint``: one directory, every
rank writing its shards of ``DTensor`` leaves and replicated tensors written once;
loading re-shards onto the current world size. No runner uses it by default.
``buffer_blocks`` lays a replay buffer's slots out for it so that they re-shard
across world sizes; ``model_split`` makes parameters split over a model axis
DTensors, so they re-shard across mesh shapes too. The DTensors live on the 2-D
(data, model) device mesh: buffer blocks ``Shard(1)`` over data and replicated over
model, split parameters replicated over data and ``Shard(dim)`` over model.
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Optional

import torch

from fab_tpu_torch.parallel import mesh


def _to_host(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` (dicts/lists/tuples of tensors, arrays and scalars)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(state), f)
    os.replace(tmp, path)


class Opaque:
    """A pickled object of a class this package does not rebuild: ``module`` and
    ``name`` of its class, its constructor arguments and its state."""

    module = name = ""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state) -> None:
        self.state = state

    def __repr__(self) -> str:
        return f"Opaque({self.module}.{self.name})"


_REBUILT_MODULES = ("builtins", "collections", "copyreg", "_codecs", "numpy")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _REBUILT_MODULES:
            return super().find_class(module, name)
        return type(name, (Opaque,), {"module": module, "name": name})


def load_checkpoint(path: str) -> Any:
    """The checkpoint at ``path``, with classes other than Python's and numpy's
    loaded as ``Opaque``."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def latest_checkpoint(checkpoints_dir: str) -> Optional[str]:
    """The ``state.pkl`` of the highest ``iter_<n>`` directory, or None."""
    if not os.path.isdir(checkpoints_dir):
        return None
    best, best_iter = None, -1
    for name in os.listdir(checkpoints_dir):
        m = re.fullmatch(r"iter_(\d+)", name)
        if m and int(m.group(1)) > best_iter:
            candidate = os.path.join(checkpoints_dir, name, "state.pkl")
            if os.path.exists(candidate):
                best, best_iter = candidate, int(m.group(1))
    return best


# ------------------------------------------------------------------ sharded (DCP)


def save_checkpoint_dcp(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` (nested dicts of tensors; ``DTensor`` leaves are sharded,
    plain tensors replicated) to the directory ``path``. Under a process group every
    rank calls it and writes its shards; a replicated tensor is written once."""
    import torch.distributed.checkpoint as dcp

    dcp.save(state, checkpoint_id=os.path.abspath(path))


def load_checkpoint_dcp(path: str, target: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Read a ``save_checkpoint_dcp`` directory into ``target`` (the same tree with
    tensors or ``DTensor``s of the saved global shapes, loaded in place: a DTensor
    gets this rank's shard, whatever world size wrote it) and return it. ``target``
    None reads every tensor whole onto the CPU, in one process."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if target is None:
        target = _whole_target(dcp.FileSystemReader(path).read_metadata())
    dcp.load(target, checkpoint_id=path)
    return target


def _whole_target(metadata) -> Dict[str, Any]:
    """Empty CPU tensors of every saved tensor's global shape, nested as saved."""
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    tree: Dict[str, Any] = {}
    for fqn, meta in metadata.state_dict_metadata.items():
        keys = metadata.planner_data.get(fqn, (fqn,)) if metadata.planner_data else (fqn,)
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        if isinstance(meta, TensorStorageMetadata):
            node[keys[-1]] = torch.empty(tuple(meta.size), dtype=meta.properties.dtype)
        else:
            node[keys[-1]] = None
    return tree


def buffer_blocks(buffer, state) -> Dict[str, torch.Tensor]:
    """A replay buffer state's fields for ``save_checkpoint_dcp``: cursor and
    n_added replicated, each slot field viewed as [L / B, B, ...] (B the buffer's
    ``batch_size``) in the one-process slot order. Under a mesh of n ranks this
    rank's L / n local slots are exactly columns [r B / n, (r + 1) B / n) of that
    view (``fab_tpu_torch/buffer.py``), so they are a DTensor sharded on dim 1, which
    DCP re-shards onto any world size that divides B."""
    B = buffer.batch_size
    if B is None or buffer.max_length % B:
        raise ValueError(
            f"a buffer checkpoint needs batch_size (here {B}) dividing max_length "
            f"({buffer.max_length}): its slots are saved in blocks of batch_size"
        )
    active = mesh.active_mesh()
    out = {}
    for name, value in state._asdict().items():
        if value.dim() == 0:
            out[name] = value
            continue
        blocks = value.reshape((buffer.max_length // B, -1) + tuple(value.shape[1:]))
        if active is not None:
            from torch.distributed.tensor import DTensor, Replicate, Shard

            blocks = DTensor.from_local(blocks, mesh.device_mesh(), [Shard(1), Replicate()],
                                        run_check=False)
        out[name] = blocks
    return out


def model_split(flow, tree: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``tree`` (parameter name -> tensor shaped like the parameter) with every entry
    of a parameter split over a model axis (``parallel/tensor.py``) as a DTensor
    sharded along its split dim over the model axis; the rest as it is."""
    from fab_tpu_torch.parallel.tensor import split_layers

    split = split_layers(flow)
    if not split:
        return tree
    from torch.distributed.tensor import DTensor, Replicate, Shard

    return {k: DTensor.from_local(v, mesh.device_mesh(split[k][1]),
                                  [Replicate(), Shard(split[k][0])], run_check=False)
            if k in split else v for k, v in tree.items()}


def to_local(value):
    """This rank's tensor of a DTensor leaf; a plain tensor as it is."""
    return value.to_local() if hasattr(value, "to_local") else value


def buffer_from_blocks(buffer, state_type, blocks: Dict[str, torch.Tensor]):
    """The buffer state (this rank's slots) from ``buffer_blocks``' tree."""
    fields = {}
    for name, value in blocks.items():
        value = value.to_local() if hasattr(value, "to_local") else value
        fields[name] = value if value.dim() == 0 else value.reshape(
            (-1,) + tuple(value.shape[2:]))
    return state_type(**fields)
