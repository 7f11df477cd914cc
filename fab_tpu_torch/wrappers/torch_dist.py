"""A ``torch.distributions`` object, or a pair of callables, on the port's flow
surface (``fab_tpu/wrappers/torch_dist.py`` and ``jax_dist.py``).

``fab_tpu`` bridges a torch distribution into JAX through a host callback and casts
its values to float32 (``fab_tpu/wrappers/torch_dist.py:60-70``); here it runs
natively, in the distribution's own dtype and on its own device, and ``log_prob``
is differentiable by torch's autograd (gradient-based transitions such as HMC work
through it). ``sample`` draws one integer seed from the caller's generator (a
``random.split``: the generator's host-side state, no wait for the device) and
samples under ``torch.random.fork_rng`` seeded with it, as ``fab_tpu`` seeds torch
from its key; the global generators are left as they were. No trainable
parameters: it serves as a target, an AIS base or a fixed flow.

Inside a compiled program (``graph.py``) a draw is one ``random.host_draw``: the
sample function runs in the noise pass, before each call, on the caller's generator
(``fab_tpu``'s sample is a host callback inside its jit). ``log_prob`` runs on the
device and is captured; a distribution that validates its arguments reads the device
on the host there, so ``graph.supported`` keeps such a configuration eager on the
card (build it with ``validate_args=False`` to compile it).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from fab_tpu_torch import random
from fab_tpu_torch.parallel.mesh import constrain_batch


class WrappedTorchDist:
    """``sample_fn(generator, n) -> [n, dim]`` and ``log_prob_fn(x) -> [...]``."""

    def __init__(self, sample_fn: Callable[[torch.Generator, int], torch.Tensor],
                 log_prob_fn: Callable[[torch.Tensor], torch.Tensor], dim: int,
                 dist: Any = None):
        self.sample_fn, self.log_prob_fn, self.dim, self.dist = sample_fn, log_prob_fn, dim, dist

    @classmethod
    def wrap(cls, dist: Any) -> "WrappedTorchDist":
        """A ``torch.distributions.Distribution`` with a 1-D event shape."""
        event_shape = tuple(dist.event_shape)
        if len(event_shape) != 1:
            raise ValueError(
                f"expected a 1-D event shape, got {event_shape} "
                "(batch the distribution over a single event axis)"
            )
        wrapper = cls(None, dist.log_prob, int(event_shape[0]), dist)
        wrapper.sample_fn = lambda generator, n: wrapper.sample_seeded(
            random.split(generator).initial_seed(), n)
        return wrapper

    @classmethod
    def from_callables(cls, sample_fn: Callable[[torch.Generator, int], torch.Tensor],
                       log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
                       dim: int) -> "WrappedTorchDist":
        """``fab_tpu``'s ``WrappedJaxDist.from_callables``: the sample function takes
        the caller's generator."""
        return cls(sample_fn, log_prob_fn, dim)

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return (self.dim,)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """No parameters to initialise."""

    def sample_seeded(self, seed: int, n: int) -> torch.Tensor:
        """``n`` draws of the wrapped distribution with torch's generators seeded
        with ``seed`` inside ``fork_rng`` (``fab_tpu``'s ``_host_sample``)."""
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            return self.dist.sample((n,))

    def sample(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """This rank's rows of ``n`` draws (the global batch under a data mesh)."""
        return constrain_batch(random.host_draw(generator, self.sample_fn, n))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_prob_fn(x)

    def sample_and_log_prob(self, n: int, generator: torch.Generator):
        x = self.sample(n, generator)
        return x, self.log_prob(x)
