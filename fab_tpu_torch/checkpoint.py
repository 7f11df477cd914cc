"""Single-host pickle checkpoints (``fab_tpu/checkpoint.py``).

One file per checkpoint, ``<dir>/iter_<n>/state.pkl``, written to a ``.tmp`` file
and renamed into place. The file holds plain dicts, lists and tuples of numpy
arrays and Python scalars (tensors are copied to the host on save), never pickled
torch or port classes. Only load files this program wrote: unpickling runs code.
The orbax (multi-host) backend is not ported yet.
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


def load_checkpoint(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


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
