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
objects still runs code: only load files that a trusted run wrote. The orbax
(multi-host) backend is not ported yet.
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Any, Optional

import torch


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
