"""FusedRealNVPFlow: a Flow whose whole forward/inverse pass is one K1 launch
(``fab_tpu/flows/fused.py``).

Drop-in for a [AffineCoupling(2 hidden layers), LULinear] x L Flow. The parameters
are the same modules as the plain Flow's; ``_stack_params`` stacks them (and builds W
or W^-1 from the LU factors) outside the autograd Function, so LU parameters get
gradients through ordinary autograd. The Function's forward is the kernel; its
backward recomputes the chain with PyTorch ops and returns the VJP, as ``_fused_bwd``
does in JAX (there is no backward kernel on the TPU either).

Under a model mesh the couplings hold shards of w1, b1 (columns) and w2 (rows);
``_stack_params`` stacks the shards and gathers each stack whole over the model
group (``parallel/tensor.py:gather_shards``, three all-gathers per pass), so K1
runs the whole chain on this rank's rows, as XLA all-gathers ``fab_tpu``'s split
parameters before its ``pallas_call``. The gradients flow back to the shards as
their slices.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from fab_tpu_torch.flows.base import Bijector, Flow
from fab_tpu_torch.flows.coupling import AffineCoupling
from fab_tpu_torch.flows.linear import LULinear, lu_weight
from fab_tpu_torch.ops.realnvp_kernel import (
    fused_realnvp_pass,
    fused_realnvp_pass_reference,
)
from fab_tpu_torch.parallel.tensor import gather_shards

_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "wlin", "lu_ld")


def _stack_params(flow: Flow, inverse: bool) -> Dict[str, torch.Tensor]:
    """Per-layer parameters -> the kernel's stacked operands (split ones gathered
    whole)."""
    couplings = flow.bijectors[0::2]
    lus = flow.bijectors[1::2]
    stacked = {}
    for i, name in enumerate(("1", "2", "3")):
        dims = couplings[0].mlp[i].split_dims()
        for key in ("w", "b"):
            value = torch.stack([getattr(c.mlp[i], key) for c in couplings])
            if key in dims:
                value = gather_shards(value, dims[key] + 1, couplings[0].mlp[i].mesh)
            stacked[key + name] = value
    stacked["wlin"] = torch.stack([lu_weight(lu, inverse) for lu in lus])
    stacked["lu_ld"] = torch.stack([lu.log_s.sum()[None] for lu in lus])
    return stacked


class FusedPass(torch.autograd.Function):
    """K1 forward; backward by recomputing the plain chain under autograd.

    ``FusedPass.recomputes`` counts backward recomputations.
    """

    recomputes = 0

    @staticmethod
    def forward(ctx, inverse: bool, x, w1, b1, w2, b2, w3, b3, wlin, lu_ld):
        ctx.inverse = inverse
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3, wlin, lu_ld)
        return fused_realnvp_pass(x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, inverse)

    @staticmethod
    def backward(ctx, grad_y, grad_ld):
        FusedPass.recomputes += 1
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [
                t.detach().requires_grad_(need)
                for t, need in zip(ctx.saved_tensors, needs)
            ]
            y, ld = fused_realnvp_pass_reference(*inputs, ctx.inverse)
            wanted = [t for t, need in zip(inputs, needs) if need]
            grads = iter(
                torch.autograd.grad((y, ld), wanted, (grad_y, grad_ld), allow_unused=True)
            )
        return (None, *(next(grads) if need else None for need in needs))


def fusable_structure(bijectors: Sequence[Bijector]) -> bool:
    """Strictly alternating plain coupling (2 hidden layers; not the padded
    LargeFusedCoupling) / LU-linear."""
    if len(bijectors) == 0 or len(bijectors) % 2 != 0:
        return False
    for i, b in enumerate(bijectors):
        if i % 2 == 0 and not (
            type(b) is AffineCoupling
            and b.n_hidden_layers == 2
            and not b.swap
            and b.scale_cap == 0.0
        ):
            return False
        if i % 2 == 1 and not isinstance(b, LULinear):
            return False
    return True


class FusedRealNVPFlow(Flow):
    """Flow whose forward/inverse passes run through K1. Inputs of shape [..., D]
    are flattened to one [N, D] batch for the launch and reshaped back."""

    def __init__(self, dim, bijectors, base):
        if not fusable_structure(bijectors):
            raise ValueError(
                "FusedRealNVPFlow needs alternating AffineCoupling(2 hidden layers, "
                "no swap, no scale cap) / LULinear bijectors"
            )
        super().__init__(dim, bijectors, base)

    def _pass(self, x: torch.Tensor, inverse: bool):
        stacked = _stack_params(self, inverse)
        y, log_det = FusedPass.apply(
            inverse, x.reshape(-1, x.shape[-1]), *(stacked[k] for k in _KEYS)
        )
        return y.reshape(x.shape), log_det.reshape(x.shape[:-1])

    def forward_and_log_det(self, z: torch.Tensor):
        return self._pass(z, inverse=False)

    def inverse_and_log_det(self, x: torch.Tensor):
        return self._pass(x, inverse=True)
