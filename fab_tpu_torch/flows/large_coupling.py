"""Affine coupling backed by K2, the large-event-dim fused kernel
(``fab_tpu/flows/large_coupling.py``).

A drop-in for AffineCoupling aimed at LGCP-1600-class shapes. The parameters are
AffineCoupling's, except that the conditioner's last layer is stored padded to a
multiple of 128 columns (zero at init, like the whole last layer; only the first
2 * d_trans columns are read, so the pad gets zero gradient and stays zero).
``fab_tpu``'s parameters load unchanged through ``convert.from_jax_params``.

Dispatch, as ``fab_tpu``'s gates (``large_coupling.py:54-64``): an input goes
through ``FusedCoupling`` (K2 forward for CUDA tensors, its plain version for CPU
tensors) when the conditioner has 2 hidden layers, its width is a multiple of 128
and the input is float32; anything else (an f64 input, say) takes AffineCoupling's
plain path. There is no batch-tile gate: the kernel masks a ragged last tile. An
input [..., D] is flattened to one [N, D] call and reshaped back.

Under a model mesh the conditioner is split as ``fab_tpu``'s spec says (w1, b1 by
columns, w2 by rows, the padded last layer replicated). K2 takes whole weights:
``GatheredWeights`` keeps each split weight whole in a buffer that is gathered
again only when its shard changes, so K2's prepared copies are rebuilt once per
update, as without a split; the gradients go back to the shards as their slices.
The plain path (an f64 input) runs the split MLP itself.
"""
from __future__ import annotations

from typing import Tuple

import torch

from fab_tpu_torch.flows.coupling import AffineCoupling
from fab_tpu_torch.ops.coupling_kernel import FusedCoupling, _round128
from fab_tpu_torch.parallel.tensor import GatheredWeights


class LargeFusedCoupling(AffineCoupling):
    _gathered = None

    def _out_width(self) -> int:
        return _round128(2 * self.d_trans)

    def shard_model_axis(self, mesh, name: str = "large coupling") -> None:
        super().shard_model_axis(mesh, name)
        specs = []
        for layer in self.mlp:
            dims = layer.split_dims()
            specs += [None if dims.get(k) is None else (dims[k], layer.mesh)
                      for k in ("w", "b")]
        if any(specs):
            self._gathered = GatheredWeights(specs)

    def _kernel_ok(self, z: torch.Tensor) -> bool:
        return (
            self.n_hidden_layers == 2
            and self.hidden_units % 128 == 0
            and z.dtype == torch.float32
        )

    def _apply_kernel(self, z: torch.Tensor, inverse: bool):
        flat = z.reshape(-1, self.dim)
        z_cond, z_trans = self._split(flat)
        l1, l2, l3 = self.mlp
        y_trans, log_det = FusedCoupling.apply(
            self.scale_cap, inverse, z_cond.contiguous(), z_trans.contiguous(),
            l1.w, l1.b, l2.w, l2.b, l3.w, l3.b,
            *(() if self._gathered is None else (self._gathered,)),
        )
        return (
            self._merge(z_cond, y_trans).reshape(z.shape),
            log_det.reshape(z.shape[:-1]),
        )

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._kernel_ok(z):
            return self._apply_kernel(z, inverse=False)
        return super().forward_and_log_det(z)

    def inverse_and_log_det(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._kernel_ok(x):
            return self._apply_kernel(x, inverse=True)
        return super().inverse_and_log_det(x)
