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

**The noise tape.** A step captured as a CUDA graph (``graph.py``) cannot draw: a
replay would repeat the draws of the capture, and a generator cannot be re-seeded
inside a graph. Inside ``taped(tape)`` every draw, split and restart of this module
is served by a ``Tape`` instead: the first run records each call (its generator's
place, as a ``TapeKey``, and its arguments) and gives it a static tensor of its own;
every later run must make the same calls, in the same order, and gets the same
tensors back. Before each run ``noise_pass(tape, generator)`` makes those calls on
the caller's generator, with this module's functions as they stand (a test may have
replaced them), and writes the draws into the static tensors. The step then draws
exactly what the eager step draws from that generator.

**Host draws.** A draw whose number of primitive calls depends on the data
(rejection sampling loops until its buffer is full) or that draws outside this
module (a ``torch.distributions`` object under ``fork_rng``) cannot be taped call by
call. ``host_draw(generator, fn, *args)`` makes it one op: eagerly it is
``fn(generator, *args)``; on a tape the recording run calls ``fn`` on a scratch
generator (on the tape's device) with this module's own functions, and each noise
pass calls that recorded ``fn`` on the caller's generator at the op's place, with
this module's functions as they stand, and copies its result into the op's static
tensor (held to the recorded shape, dtype and device). Such a draw must depend on
the generator alone, not on the step's tensors, since it runs before the step.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
from typing import Callable, Dict, List, Sequence, Tuple

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


def host_draw(generator: torch.Generator, fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """``fn(generator, *args)``: a draw of any number of calls, one op on a tape (see
    the module docstring)."""
    return fn(generator, *args)


# ---------------------------------------------------------------- the noise tape

KINDS = ("normal", "exponential", "gumbel", "uniform", "randint")
_SERVED = KINDS + ("split", "restart", "host_draw")
# The module's own functions, for the recording run (the step is not given the
# caller's generator then, and a test's replacements must not be consumed by it).
_OWN = {name: globals()[name] for name in _SERVED}
_OWN["gumbel"] = lambda generator, *args: -torch.log(_OWN["exponential"](generator, *args))


class TapeKey:
    """A generator's place in a tape: 0 is the generator the step is given, and
    each split or restart makes the next. ``device`` is the tape's."""

    __slots__ = ("tape", "index")

    def __init__(self, tape: "Tape", index: int):
        self.tape, self.index = tape, index

    @property
    def device(self) -> torch.device:
        return self.tape.device


class Tape:
    """The draws of one step in call order: ``ops`` holds ("split", parent),
    ("restart", parent), (kind, parent, args) or ("host", parent, (shape, dtype,
    device)), ``noise`` one static tensor per draw, ``host_fns`` each host op's
    recorded (fn, args) by its place in ``ops``. Recorded by the first run inside
    ``taped``; each later run is held to it and raises at the first call that
    differs. ``device``: where a host draw's recording run draws."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.ops: List[Tuple] = []
        self.noise: List[torch.Tensor] = []
        self.host_fns: Dict[int, Tuple[Callable, Tuple]] = {}
        self.recorded = False
        self._scratch: Dict[Tuple[int, torch.device], torch.Generator] = {}

    def root(self) -> TapeKey:
        """The key that stands for the step's generator."""
        return TapeKey(self, 0)

    def _begin(self) -> None:
        self._cursor, self._n_keys, self._n_draws = 0, 1, 0

    def _end(self) -> None:
        if self._cursor != len(self.ops):
            raise RuntimeError(f"the step made {self._cursor} draws and splits, its tape "
                               f"{len(self.ops)}")
        self.recorded = True

    def _op(self, kind: str, key, args: Tuple = ()) -> int:
        if not (isinstance(key, TapeKey) and key.tape is self):
            raise RuntimeError(f"a taped step drew from {key!r}, not from its own generator "
                               "or a key split from it")
        op = (kind, key.index) + ((args,) if kind in KINDS else ())
        if self.recorded:
            have = self.ops[self._cursor] if self._cursor < len(self.ops) else None
            if have != op:
                raise RuntimeError(f"the step's draws changed: call {self._cursor} is {op}, "
                                   f"its tape has {have}")
        else:
            self.ops.append(op)
        self._cursor += 1
        return key.index

    def _scratch_generator(self, index: int, device) -> torch.Generator:
        """Real noise for the recording run, which computes on it."""
        device = torch.device(device if device is not None else "cpu")
        scratch = self._scratch.get((index, device))
        if scratch is None:
            scratch = torch.Generator(device=device).manual_seed(index)
            self._scratch[(index, device)] = scratch
        return scratch

    def _draw(self, kind: str, key, *args) -> torch.Tensor:
        index = self._op(kind, key, args)
        if not self.recorded:
            self.noise.append(_OWN[kind](self._scratch_generator(index, args[-1]), *args))
        self._n_draws += 1
        return self.noise[self._n_draws - 1]

    def _host(self, key, fn: Callable, *args) -> torch.Tensor:
        if self.recorded:
            # Held to the op's kind and generator here, to its result's shape, dtype
            # and device by each noise pass (the closure is rebuilt every step).
            have = self.ops[self._cursor] if self._cursor < len(self.ops) else None
            if not (isinstance(key, TapeKey) and key.tape is self and have is not None
                    and have[:2] == ("host", key.index)):
                self._op("host", key)  # raises, naming both
            self._cursor += 1
        else:
            index = self._op("host", key)
            served = {name: globals()[name] for name in _SERVED}
            globals().update(_OWN)
            try:
                out = fn(self._scratch_generator(index, self.device), *args)
            finally:
                globals().update(served)
            self.ops[-1] = ("host", index, _signature(out))
            self.host_fns[len(self.ops) - 1] = (fn, args)
            self.noise.append(out.detach().clone(memory_format=torch.contiguous_format))
        self._n_draws += 1
        return self.noise[self._n_draws - 1]

    def _new_key(self, kind: str, key) -> TapeKey:
        self._op(kind, key)
        self._n_keys += 1
        return TapeKey(self, self._n_keys - 1)


def _signature(t: torch.Tensor) -> Tuple:
    return tuple(t.shape), t.dtype, t.device


@contextlib.contextmanager
def taped(tape: Tape):
    """Within, this module's draws, splits and restarts are served by ``tape`` (see
    the module docstring); a run that ends without error completes or matches it."""
    saved = {name: globals()[name] for name in _SERVED}
    globals().update({kind: functools.partial(tape._draw, kind) for kind in KINDS})
    globals().update(split=functools.partial(tape._new_key, "split"),
                     restart=functools.partial(tape._new_key, "restart"),
                     host_draw=tape._host)
    tape._begin()
    try:
        yield tape.root()
        tape._end()
    finally:
        globals().update(saved)


def noise_pass(tape: Tape, generator) -> None:
    """Make the tape's calls on ``generator``, in its order, with this module's
    functions as they stand, and write each draw into its static tensor."""
    keys = [generator]
    draws = iter(tape.noise)
    for i, op in enumerate(tape.ops):
        if op[0] == "host":
            fn, args = tape.host_fns[i]
            out = fn(keys[op[1]], *args)
            if _signature(out) != op[2]:
                raise RuntimeError(f"the step's draws changed: host draw {i} gave "
                                   f"{_signature(out)}, its tape has {op[2]}")
            next(draws).copy_(out)
        elif op[0] in KINDS:
            next(draws).copy_(globals()[op[0]](keys[op[1]], *op[2]))
        else:
            keys.append(globals()[op[0]](keys[op[1]]))
