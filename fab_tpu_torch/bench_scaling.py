"""Weak scaling of the bench step over the data axis (``bench_scaling.py`` of the
repository): the ManyWell-32 FAB + prioritised-buffer step of ``fab_tpu_torch.bench``
(fused flow, K1) on a data mesh of n processes, one per device.

    python3 -m fab_tpu_torch.bench_scaling [--mesh-sizes 1 2 4] [--batch-per-device 2048]
        [--steps 10] [--warmup 2] [--check-only] [--device cpu]

The global batch is ``--batch-per-device`` x n (the buffer is sized on it, as
``bench_scaling.py:34-78`` does); ``--check-only`` means 64 rows per device, one
warm-up step and one timed step. For each size this process starts ``python3 -m
torch.distributed.run --standalone --nproc_per_node=<n> -m
fab_tpu_torch.bench_scaling --worker ...``; every rank joins the process group
(NCCL on the card, gloo on the CPU), builds the mesh ``make_mesh(n, 1)`` and runs
the step, and rank 0 prints one JSON line. This process prints one JSON line per size,
with ``bench_scaling.py``'s keys: ``n_devices``, ``samples_per_s``,
``samples_per_s_per_device`` and ``efficiency_vs_1`` (per-device rate over the
first size's).

NCCL takes one card per rank, so on the card a size above the number of cards is
not run, and stderr says so; there is no fall-back to gloo. On the CPU every size
runs over gloo (the ranks share the cores: the numbers check the sharded program,
not its efficiency).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from fab_tpu_torch.bench import SEED, log, make_trainer, sync, timed_step
from fab_tpu_torch.device import resolve_device

LAUNCH_TIMEOUT_S = 1800.0  # one size's launcher, all its ranks included


def worker(args) -> None:
    """One rank: the bench step on the data mesh over the launched processes."""
    import torch.distributed as dist

    from fab_tpu_torch.parallel import distributed, mesh

    device = resolve_device(args.device)
    if not distributed.initialize(device):
        raise RuntimeError("--worker runs under python3 -m torch.distributed.run")
    try:
        torch.set_float32_matmul_precision("highest")
        n = dist.get_world_size()
        mesh.activate_mesh(mesh.make_mesh(n, 1))
        batch = args.batch_per_device * n
        trainer = make_trainer(device, SEED, fused=True, batch_size=batch)
        generator = torch.Generator(device=device).manual_seed(SEED + 1)
        state = trainer.init_state(generator, batch_size=batch)
        for _ in range(args.warmup):
            state, _, _ = timed_step(trainer, state, generator, batch, device)
        sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, info, _ = timed_step(trainer, state, generator, batch, device)
        elapsed = torch.tensor(time.perf_counter() - t0, dtype=torch.float64, device=device)
        dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)
        if not torch.isfinite(info["loss"]):
            raise RuntimeError("bench_scaling: the loss went non-finite")
        if dist.get_rank() == 0:
            print(json.dumps({"n_devices": n, "batch": batch, "steps": args.steps,
                              "samples_per_s": batch * args.steps / float(elapsed)}),
                  flush=True)
    finally:
        mesh.activate_mesh(None)
        distributed.shutdown()


def launch(n: int, args, batch_per_device: int, steps: int, warmup: int) -> dict:
    """One size: the launcher over n ranks; rank 0's JSON line."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", "fab_tpu_torch.bench_scaling", "--worker",
           "--device", args.device, "--batch-per-device", str(batch_per_device),
           "--steps", str(steps), "--warmup", str(warmup)]
    log(" ".join(cmd[1:]))
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=LAUNCH_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"bench_scaling: {n} ranks exited {proc.returncode}:\n"
                           + proc.stdout[-4000:] + proc.stderr[-4000:])
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{") and '"n_devices"' in line]
    if len(lines) != 1:
        raise RuntimeError(f"bench_scaling: {n} ranks printed {len(lines)} result lines:\n"
                           + proc.stdout[-4000:])
    return lines[0]


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mesh-sizes", type=int, nargs="+", default=None,
                        help="process counts to sweep (default: 1..the cards, powers of 2)")
    parser.add_argument("--batch-per-device", type=int, default=2048,
                        help="weak scaling: global batch = this x n")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--check-only", action="store_true",
                        help="64 rows per device, 1 warm-up and 1 timed step")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker(args)
        return []

    device = resolve_device(args.device)
    available = torch.cuda.device_count() if device.type == "cuda" else None
    sizes = args.mesh_sizes
    if sizes is None:
        sizes, n = [], 1
        while n <= (available or 1):
            sizes.append(n)
            n *= 2
    if available is not None and any(n > available for n in sizes):
        log(f"bench_scaling: sizes {[n for n in sizes if n > available]} not run: NCCL "
            f"takes one card per rank and this machine has {available}")
        sizes = [n for n in sizes if n <= available]
    batch_per_device = 64 if args.check_only else args.batch_per_device
    steps = 1 if args.check_only else args.steps
    warmup = 1 if args.check_only else args.warmup

    lines, base = [], None
    for n in sizes:
        sps = launch(n, args, batch_per_device, steps, warmup)["samples_per_s"]
        per_device = sps / n
        base = per_device if base is None else base
        line = {"n_devices": n, "samples_per_s": round(sps, 1),
                "samples_per_s_per_device": round(per_device, 1),
                "efficiency_vs_1": round(per_device / base, 4)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
