"""Minimal MLP used by coupling-layer conditioners (``fab_tpu/flows/mlp.py``).

Weights are row-major [in, out], as in ``fab_tpu``, so parameters convert one to one
and the fused kernel reads them as they are. Under a model mesh a ``Dense`` layer
may hold a shard of its weight (``parallel/tensor.py``): its columns (``COLUMN``)
or its rows (``ROW``); ``assign`` takes whole values and keeps the shard.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from fab_tpu_torch.parallel.tensor import (
    COLUMN,
    ROW,
    copy_to_model,
    mlp_param_sharding,
    own_shard,
    reduce_from_model,
)


class Dense(nn.Module):
    """y = x @ w + b with w [d_in, d_out]; under a model split, this rank's shard
    (``split``: COLUMN, ROW or None; ``mesh``: the mesh it was split over)."""

    def __init__(self, d_in: int, d_out: int, dtype=torch.float32, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((d_in, d_out), dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros((d_out,), dtype=dtype, device=device))
        self.split = None
        self.mesh = None

    def split_dims(self) -> dict:
        """{parameter: the dim it is split along} of a split layer."""
        if self.split == COLUMN:
            return {"w": 1, "b": 0}
        return {"w": 0} if self.split == ROW else {}

    def _cut(self, name: str, value: torch.Tensor) -> torch.Tensor:
        dim = self.split_dims().get(name)
        return value if dim is None else own_shard(value, dim, self.mesh)

    def shard_model_axis(self, split, mesh, name: str = "Dense") -> None:
        """Keep only this rank's shard of the layer (``split`` COLUMN or ROW; None
        leaves it whole). A width the model axis does not divide raises."""
        if split is None or self.split is not None:
            return
        width = self.w.shape[1 if split == COLUMN else 0]
        if width % mesh.n_model:
            raise ValueError(
                f"{name}: its {'output' if split == COLUMN else 'input'} width {width} "
                f"does not divide over the {mesh.n_model} ranks of the model axis")
        self.split, self.mesh = split, mesh
        for key in self.split_dims():
            old = getattr(self, key)
            setattr(self, key, nn.Parameter(self._cut(key, old.detach()).clone(),
                                            requires_grad=old.requires_grad))

    def assign(self, w: torch.Tensor, b: torch.Tensor) -> None:
        """Set the layer from whole values (this rank's shard of them if split)."""
        with torch.no_grad():
            self.w.copy_(self._cut("w", w))
            self.b.copy_(self._cut("b", b))

    def affine(self, x: torch.Tensor, mask: torch.Tensor = None) -> torch.Tensor:
        """x @ (w * mask) + b; a split layer reduces over its model group (Megatron's
        column / row pair, ``parallel/tensor.py``). ``mask`` is cut like ``w``."""
        w = self.w if mask is None else self.w * mask
        if self.split == COLUMN:
            return copy_to_model(x, self.mesh) @ w + self.b
        if self.split == ROW:
            return reduce_from_model(x @ w, self.mesh) + self.b
        return x @ w + self.b


def shard_mlp(layers, sizes: Sequence[int], mesh, name: str) -> None:
    """Split an MLP's layers as ``mlp_param_sharding(sizes)`` says."""
    for j, (layer, split) in enumerate(zip(layers, mlp_param_sharding(sizes))):
        layer.shard_model_axis(split, mesh, f"{name}.mlp.{j}")


def mlp_init(
    sizes: Sequence[int],
    generator: torch.Generator,
    zero_init_last: bool = True,
    dtype=torch.float32,
    device=None,
    init_mode: str = "he_normal",
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Initial (w, b) per layer; the last layer is zero if ``zero_init_last``.

    ``init_mode``:
      - ``"he_normal"``: w ~ N(0, 2/fan_in), b = 0.
      - ``"torch"``: torch.nn.Linear's defaults, w and b ~ U(-1/sqrt(fan_in),
        1/sqrt(fan_in)).
    """
    if init_mode not in ("he_normal", "torch"):
        raise ValueError(f"unknown init_mode {init_mode!r}")
    out = []
    for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        w = torch.zeros((d_in, d_out), dtype=dtype, device=device)
        b = torch.zeros((d_out,), dtype=dtype, device=device)
        if last and zero_init_last:
            pass
        elif init_mode == "torch":
            bound = 1.0 / math.sqrt(d_in)
            w.uniform_(-bound, bound, generator=generator)
            b.uniform_(-bound, bound, generator=generator)
        else:
            w.normal_(0.0, math.sqrt(2.0 / d_in), generator=generator)
        out.append((w, b))
    return out


def mlp_apply(layers: Sequence[Dense], x: torch.Tensor) -> torch.Tensor:
    """Forward pass; ReLU between layers, linear output."""
    for i, layer in enumerate(layers):
        x = layer.affine(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x
