"""Batched rejection sampling (``fab_tpu/sampling/rejection.py``).

Fixed-size batches of proposals fill an output buffer with the accepted draws, in
draw order, until it is full; the surplus of the last batch is dropped. The loop
reads the filled count on the host once per batch, so its number of draws depends on
the data: the whole loop is one ``random.host_draw``, which a compiled step takes in
its noise pass, before the step (``fab_tpu``'s ``lax.while_loop`` inside the jit).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from fab_tpu_torch import random


def rejection_sampling(
    generator: torch.Generator,
    n_samples: int,
    proposal_sample: Callable[[torch.Generator, int], torch.Tensor],
    proposal_log_prob: Callable[[torch.Tensor], torch.Tensor],
    target_log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    k: float,
    batch_multiplier: int = 2,
) -> torch.Tensor:
    """n_samples draws from the (unnormalised) target under the envelope
    k * proposal. ``proposal_sample(generator, n)`` returns [n] or [n, D] draws; a
    draw z is accepted when log u < log target(z) - log proposal(z) - log k."""
    return random.host_draw(generator, _fill, n_samples, proposal_sample, proposal_log_prob,
                            target_log_prob_fn, k, batch_multiplier)


def _fill(generator, n_samples, proposal_sample, proposal_log_prob, target_log_prob_fn, k,
          batch_multiplier):
    log_k = math.log(k)
    batch = n_samples * batch_multiplier
    out, n_filled = None, 0
    while n_filled < n_samples:
        z = proposal_sample(generator, batch)
        if out is None:
            out = z.new_zeros((n_samples,) + z.shape[1:])
        log_u = torch.log(random.uniform(generator, (batch,), z.dtype, z.device))
        accept = log_u < target_log_prob_fn(z) - (proposal_log_prob(z) + log_k)
        taken = z[accept][: n_samples - n_filled]
        out[n_filled:n_filled + taken.shape[0]] = taken
        n_filled += taken.shape[0]
    return out
