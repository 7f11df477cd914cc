"""The port's headline benchmark (``bench.py`` of the repository): AIS samples/s per
card on ManyWell-32, FAB with a prioritised buffer, through the fused flow (K1).

    python3 -m fab_tpu_torch.bench [--device cpu] [--batch-size 2048]
        [--layer-nodes-per-dim 10] [--steps 10] [--warmup 2]

The measured program is one full training iteration, compiled as ``bench.py`` has
it ("all jit-compiled"): the port's ``make_train_step``, one step captured as a CUDA
graph and replayed (on the CPU the same static-tensor and noise-tape path without a
graph), at ``bench.py:29-78``'s settings: dim 32, RealNVP 10 x [coupling, width 320; LU] with no ActNorm, HMC with 4
intermediate distributions, 1 outer step and 5 leapfrog steps of 1.0, the
``fab_alpha_div`` loss, a prioritised buffer of 16 / 4 batches (32,768 / 8,192 rows
at batch 2048), 8 replay batches, ``w_adjust_max_clip`` 10, ``make_optimizer(3e-4,
100.0)``, batch 2048, float32 with f32 products (no TF32). The fused flow runs every
pass through K1; each step ends in ``torch.cuda.synchronize()``.

Two deliberate differences from ``bench.py``:

- ``vs_baseline`` is the compiled fused step against the port's compiled plain-flow
  step, measured in this process: two trainers from the same seed, warmed up (the
  first warm-up step captures each graph), then timed steps of each in turns (fused,
  plain, plain, fused, ...). ``bench.py`` divides by a torch-CPU figure of the
  reference's pattern, which says nothing about the card. The eager steps of both
  (``train_step``, as this bench timed before the compiled step existed) follow, in
  turns, and go to stderr.
- ``mfu`` comes from the card's own figures: the FLOPs of one plain-flow step,
  counted by ``torch.utils.flop_counter.FlopCounterMode`` on an eager step (it cannot
  see inside K1 or a graph replay; the plain step does the same products), times the
  compiled fused steps per second, over
  the H100's dense f32 peak outside the tensor cores (67 TFLOP/s SXM, 51 TFLOP/s
  PCIe; NVIDIA's data sheet). On another device, and on the CPU, ``mfu`` is null
  and stderr says why.

Prints exactly one JSON line on stdout, with ``bench.py``'s keys: ``metric``,
``value`` (AIS samples/s per card, fused), ``unit``, ``vs_baseline``, ``mfu`` and
``achieved_flops_per_s``. Every other line goes to stderr: the settings, the
captures, K1's launches and backward recomputes per eager fused step and in the
fused step's graph (38 + 29 on the card; K1's plain version runs on the CPU and
launches nothing), the median compiled and eager fused and plain steps and their
samples/s, and the card's name and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Optional

import torch

from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows import make_realnvp
from fab_tpu_torch.flows.fused import FusedPass
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.ops import realnvp_kernel
from fab_tpu_torch.sampling import HamiltonianMonteCarlo
from fab_tpu_torch.targets import ManyWellEnergy
from fab_tpu_torch.train import PrioritisedBufferTrainer, make_optimizer

DIM, N_LAYERS = 32, 10
SEED = 0  # the flow's weights come from SEED, the step's draws from SEED + 1
METRIC = "ManyWell-32 FAB+buffer AIS samples/s/card"
# Dense f32 peak outside the tensor cores (NVIDIA's H100 data sheet).
H100_F32_PEAK = {"sxm": 67e12, "pcie": 51e12}


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_trainer(device="cuda", seed: int = 0, fused: bool = True, batch_size: int = 2048,
                 layer_nodes_per_dim: int = 10) -> PrioritisedBufferTrainer:
    """bench.py's ManyWell-32 FAB + prioritised-buffer trainer (``batch_size`` is the
    global batch under a data mesh)."""
    flow = make_realnvp(DIM, N_LAYERS, layer_nodes_per_dim, fused=fused,
                        generator=torch.Generator(device=device).manual_seed(seed),
                        device=device)
    model = FABModel.create(
        flow, ManyWellEnergy(DIM, device=device),
        transition_operator=HamiltonianMonteCarlo(
            n_ais_intermediate_distributions=4, n_outer=1, n_leapfrog=5, epsilon=1.0),
        n_intermediate_distributions=4, loss_type="fab_alpha_div",
    )
    buffer = PrioritisedReplayBuffer(dim=DIM, max_length=batch_size * 16,
                                     min_sample_length=batch_size * 4, batch_size=batch_size)
    return PrioritisedBufferTrainer(model, make_optimizer(3e-4, 100.0), buffer,
                                    n_batches_buffer_sampling=8, w_adjust_max_clip=10.0,
                                    device=device)


def timed_step(trainer, state, generator, batch_size: int, device, step=None):
    """One train step ended by a device sync: ``step(state, generator)`` (a compiled
    step) or else the eager ``train_step``; (state, info, seconds)."""
    sync(device)
    t0 = time.perf_counter()
    if step is None:
        state, info = trainer.train_step(state, generator, batch_size)
    else:
        state, info = step(state, generator)
    sync(device)
    return state, info, time.perf_counter() - t0


def card_line(device: torch.device) -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for the card, None off a card."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def f32_peak(device: torch.device):
    """(peak f32 FLOP/s, None) on an H100, else (None, why)."""
    if device.type != "cuda":
        return None, f"mfu null: {device.type} is not a card with a published peak"
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        return None, f"mfu null: no f32 peak on record for {name}"
    return H100_F32_PEAK["pcie" if "pcie" in name.lower() else "sxm"], None


def count_flops(trainer, state, generator, batch_size: int) -> int:
    """FLOPs of one train step, as FlopCounterMode counts them (matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        trainer.train_step(state, generator, batch_size)
    return counter.get_total_flops()


def _k1_counts():
    return realnvp_kernel.fused_realnvp_pass.launches, FusedPass.recomputes


def measure(device="cuda", batch_size: int = 2048, layer_nodes_per_dim: int = 10,
            n_steps: int = 10, n_warmup: int = 2) -> dict:
    """Fused and plain trainers from one seed: ``n_warmup`` compiled steps of each
    (the first captures its graph), ``n_steps`` timed compiled steps of each in turns,
    then one eager warm-up step and ``n_steps`` timed eager steps of each in turns;
    the plain step's FLOPs after. The fused trainer goes first, so a K1 that does not
    build stops the run before anything plain is timed. ``seconds`` holds the
    compiled steps under "fused" / "plain" and the eager ones under "fused_eager" /
    "plain_eager"."""
    device = resolve_device(device)
    trainers = {kind: make_trainer(device, SEED, kind == "fused", batch_size,
                                   layer_nodes_per_dim) for kind in ("fused", "plain")}
    trainers["plain"].model.flow.load_state_dict(trainers["fused"].model.flow.state_dict())
    gens = {kind: torch.Generator(device=device).manual_seed(SEED + 1) for kind in trainers}
    steps = {kind: trainer.make_train_step(batch_size) for kind, trainer in trainers.items()}
    states = {}
    for kind, trainer in trainers.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # its "buffer fill: ..." line
            states[kind] = trainer.init_state(gens[kind], batch_size=batch_size)
        sync(device)
        log(f"{kind} init_state: {time.perf_counter() - t0:.2f} s")
        for j in range(n_warmup):
            states[kind], _, s = timed_step(trainer, states[kind], gens[kind], batch_size,
                                            device, steps[kind])
            if j == 0:
                program = trainer._program(batch_size)
                log(f"{kind} compiled step, first call (a warm-up step undone, the build, "
                    f"one step): {s:.2f} s" + (f"; capture {program.capture_s:.2f} s, instantiation "
                                    f"{program.instantiate_s:.3f} s, private pool "
                                    f"{program.pool_bytes / 2**20:.0f} MiB"
                                    if program.graph is not None else ""))
    seconds = {kind: [] for kind in ("fused", "plain", "fused_eager", "plain_eager")}
    k1_per_step = []
    for compiled in (True, False):
        if not compiled:
            for kind in trainers:
                states[kind], _, _ = timed_step(trainers[kind], states[kind], gens[kind],
                                                batch_size, device)
        for i in range(n_steps):
            for kind in (("fused", "plain") if i % 2 == 0 else ("plain", "fused")):
                before = _k1_counts()
                states[kind], info, s = timed_step(trainers[kind], states[kind], gens[kind],
                                                   batch_size, device,
                                                   steps[kind] if compiled else None)
                seconds[kind if compiled else kind + "_eager"].append(s)
                if kind == "fused" and not compiled:
                    k1_per_step.append(tuple(a - b for a, b in zip(_k1_counts(), before)))
                if not math.isfinite(float(info["loss"])):
                    raise RuntimeError(f"bench: the {kind} step's loss went non-finite")
    captured = trainers["fused"]._program(batch_size).captured_counts
    flops = count_flops(trainers["plain"], states["plain"], gens["plain"], batch_size)
    return {"seconds": seconds, "k1_per_step": k1_per_step, "flops_per_step": flops,
            "k1_captured": (captured.get("k1"), captured.get("k1_recomputes"))}


def result_line(batch_size: int, run: dict, peak: Optional[float]) -> dict:
    """bench.py's JSON keys from a ``measure`` run."""
    fused, plain = sum(run["seconds"]["fused"]), sum(run["seconds"]["plain"])
    n = len(run["seconds"]["fused"])
    achieved = run["flops_per_step"] * n / fused
    return {
        "metric": METRIC,
        "value": round(batch_size * n / fused, 2),
        "unit": "samples/s/card",
        "vs_baseline": round(plain / fused, 4),
        "mfu": round(achieved / peak, 6) if peak else None,
        "achieved_flops_per_s": round(achieved),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch-size", type=int, default=2048)
    parser.add_argument("--layer-nodes-per-dim", type=int, default=10)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=2)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    torch.set_float32_matmul_precision("highest")  # bench.py's "highest": no TF32
    card = card_line(device)
    log(f"card: {card or device.type}")
    log(f"ManyWell-32 FAB + prioritised buffer: batch {args.batch_size}, RealNVP "
        f"{N_LAYERS} x [coupling width {DIM * args.layer_nodes_per_dim}, LU], HMC 4 x 5 "
        f"leapfrog, buffer {16 * args.batch_size} / {4 * args.batch_size}, 8 replay "
        f"batches; {args.warmup} warm-up and {args.steps} timed steps each, fused and "
        "plain in turns")
    run = measure(device, args.batch_size, args.layer_nodes_per_dim, args.steps,
                  args.warmup)
    peak, why = f32_peak(device)
    if why:
        log(why)
    launches = sorted({p[0] for p in run["k1_per_step"]})
    recomputes = sorted({p[1] for p in run["k1_per_step"]})
    log(f"K1 per fused step: launches {launches}, recomputes {recomputes}"
        + ("" if device.type == "cuda" else " (K1's plain version runs on the CPU)"))
    if device.type == "cuda":
        log(f"K1 in the fused step's graph: launches {run['k1_captured'][0]}, recomputes "
            f"{run['k1_captured'][1]} per replay (counted at capture)")
    for suffix, what in (("_eager", "eager"), ("", "compiled")):
        ms = {kind: statistics.median(run["seconds"][kind + suffix]) * 1e3
              for kind in ("fused", "plain")}
        log(f"{what} samples/s: fused {args.batch_size / ms['fused'] * 1e3:.1f}, plain "
            f"{args.batch_size / ms['plain'] * 1e3:.1f} (median steps)")
        log(f"median {what + ' ' if suffix else ''}step: fused {ms['fused']:.1f} ms, plain "
            f"{ms['plain']:.1f} ms; all fused "
            + ", ".join(f"{s * 1e3:.1f}" for s in run["seconds"]["fused" + suffix])
            + "; all plain "
            + ", ".join(f"{s * 1e3:.1f}" for s in run["seconds"]["plain" + suffix]))
    log(f"FLOPs per step (plain flow, FlopCounterMode): {run['flops_per_step']:.4e}"
        + (f"; f32 peak {peak:.3g} FLOP/s" if peak else ""))
    line = result_line(args.batch_size, run, peak)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
