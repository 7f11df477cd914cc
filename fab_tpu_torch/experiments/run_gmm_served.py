"""``run_gmm`` with every draw of the run made by a CPU generator and moved to the
device: a diagnosis that holds a card's arithmetic to the CPU run's noise.

    python3 -m fab_tpu_torch.experiments.run_gmm_served --config experiments/configs/gmm.yaml \
        [--device cpu] [training.seed=1 ...]

Inside ``served()`` the run's generator (``setup_run.make_generator``) is a CPU
generator seeded by ``training.seed``, and ``random``'s draws and ``mlp_init`` are
replaced, as ``random``'s docstring allows, by versions that draw on their
generator's device and move the draw to the device asked for. ``init_state``'s draws,
every step's (the compiled step's through the noise tape's pass) and every in-run
evaluation's are made on that generator, so the keys split from it are CPU
generators too (``random.split``, ``random.restart``). At one seed the run therefore
computes on exactly the noise of ``run_gmm --device cpu``; on the CPU it is that run,
bit for bit. A draw from a generator on the device (the target's true-expectation
estimate) is made as ``run_gmm`` makes it. ``gmm_fab_cells --only
fab_no_buffer_served_s<N>`` runs fab_no_buffer cells through it. Arguments are
``run_gmm``'s.
"""
from __future__ import annotations

import contextlib

import torch

from fab_tpu_torch import random
from fab_tpu_torch.experiments import run_gmm, setup_run
from fab_tpu_torch.flows import autoregressive, coupling, mlp, resampled, splines

DRAWS = ("normal", "exponential", "uniform", "randint")
# The modules that hold ``mlp_init`` by name.
MLP_INIT_USERS = (coupling, splines, autoregressive, resampled)


def cpu_generator(seed: int, device) -> torch.Generator:
    """``setup_run.make_generator`` for a served run: on the CPU, whatever ``device``."""
    del device
    return torch.Generator(device="cpu").manual_seed(seed)


def _served_draw(draw):
    def served(generator, *args):  # the device asked for is the last argument
        return draw(generator, *args[:-1], generator.device).to(args[-1])
    return served


def _served_mlp_init(sizes, generator, zero_init_last=True, dtype=torch.float32,
                     device=None, init_mode="he_normal"):
    layers = _MLP_INIT(sizes, generator, zero_init_last, dtype, generator.device, init_mode)
    return layers if device is None else [(w.to(device), b.to(device)) for w, b in layers]


_MLP_INIT = mlp.mlp_init


@contextlib.contextmanager
def served():
    """Within, the run's generator is a CPU generator and every draw is made on its
    generator's device and moved to the device asked for (the module docstring)."""
    patches = [(random, kind, _served_draw(getattr(random, kind))) for kind in DRAWS]
    patches += [(m, "mlp_init", _served_mlp_init) for m in MLP_INIT_USERS]
    patches.append((setup_run, "make_generator", cpu_generator))
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, fn in patches:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def main(argv=None):
    print("noise: every draw made by CPU generators and moved to the device", flush=True)
    with served():
        return run_gmm.main(argv)


if __name__ == "__main__":
    main()
