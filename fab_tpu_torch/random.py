"""The port's random draws, each from an explicit ``torch.Generator``.

Every draw of the port goes through these functions, so a test can replace them to
replay noise drawn elsewhere (for example by ``fab_tpu``). ``categorical`` and
``bernoulli`` are built on ``gumbel`` and ``uniform``, in the forms ``jax.random``
uses (Gumbel-max over the logits; a uniform below p), so replaying those draws
replays them too.

A stochastic flow's log q takes a *key*: a generator made by ``split`` and read
through ``restart``, so that every log-q call given one key draws the same noise, as
a JAX key does. Both work on the generators' host-side state only (a CUDA
generator's state is its Philox seed and offset), so neither waits for the device
nor launches anything.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

import torch


def split(generator: torch.Generator) -> torch.Generator:
    """A new key, seeded from ``generator``'s state; ``generator`` is re-seeded from
    the same state, so it moves on and the next split gives another key."""
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes(), digest_size=16).digest()
    generator.manual_seed(int.from_bytes(digest[8:], "little") >> 1)
    key = torch.Generator(device=generator.device)
    return key.manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def restart(key: torch.Generator) -> torch.Generator:
    """A generator at ``key``'s state. Drawing from it leaves ``key`` where it is, so
    every restart of one key gives the same draws."""
    generator = torch.Generator(device=key.device)
    generator.set_state(key.get_state())
    return generator


def normal(generator: torch.Generator, shape: Sequence[int], dtype, device) -> torch.Tensor:
    """Standard normal draws."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)


def exponential(
    generator: torch.Generator, shape: Sequence[int], dtype, device
) -> torch.Tensor:
    """Exp(1) draws."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    return out.exponential_(generator=generator)


def gumbel(generator: torch.Generator, shape: Sequence[int], dtype, device) -> torch.Tensor:
    """Standard Gumbel draws (-log of an Exp(1) draw)."""
    return -torch.log(exponential(generator, shape, dtype, device))


def uniform(generator: torch.Generator, shape: Sequence[int], dtype, device) -> torch.Tensor:
    """Uniform [0, 1) draws."""
    return torch.rand(tuple(shape), generator=generator, dtype=dtype, device=device)


def randint(generator: torch.Generator, low: int, high: int, shape: Sequence[int],
            device) -> torch.Tensor:
    """Integers uniform in [low, high), int64."""
    return torch.randint(low, high, tuple(shape), generator=generator, device=device)


def bernoulli(generator: torch.Generator, p: float, shape: Sequence[int], dtype,
              device) -> torch.Tensor:
    """True with probability p: a uniform draw below p."""
    return uniform(generator, shape, dtype, device) < p


def categorical(generator: torch.Generator, logits: torch.Tensor, n: int) -> torch.Tensor:
    """n indices drawn with replacement from softmax(logits) (1-D), by the Gumbel-max
    trick over an [n, len(logits)] draw."""
    g = gumbel(generator, (n, logits.shape[-1]), logits.dtype, logits.device)
    return torch.argmax(g + logits, dim=-1)
