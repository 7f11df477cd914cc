"""ALDP step profiler: the wall time of each component of one training iteration
(``experiments/profile_aldp.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.profile_aldp \
        [--config experiments/configs/aldp.yaml] [--batch 1024] [--repeats 20] \
        [--trace-dir chiprun_out/aldp_trace] [--device cpu] \
        [system.backend=host_cpp] [overrides ...]

Each row times one component at the batch size: the median of ``--repeats`` calls
(10 for the whole train step) after ``WARMUP`` (3) warm-up calls, each call ending in
a device synchronisation, on the host's clock. The components are the flow's sample and log
q, the x-gradients of log q and log p (HMC takes n_dists x (n_leapfrog + 1) of each
per iteration), the target's log p and its internal -> Cartesian transform, the flow
parameters' gradient (one per replay update), a whole AIS pass and a whole
prioritised-buffer train step; the buffer is filled to
``training.replay_buffer.min_length`` batches first. ``system.backend=host_cpp``
profiles the C++ energy server (each row then also shows its server calls per
call); ``--trace-dir`` writes a profiler trace of 3 train steps. Returns the rows
(name, seconds per call, calls per iteration).
"""
from __future__ import annotations

import argparse
import time

import torch

from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
from fab_tpu_torch.experiments.setup_run import setup_precision
from fab_tpu_torch.flows.base import flow_log_prob, log_q_noise
from fab_tpu_torch.native import AldpEnergyServer
from fab_tpu_torch.sampling.point import batched_value_and_grad
from fab_tpu_torch.train import PrioritisedBufferTrainer, make_optimizer
from fab_tpu_torch.utils.logging import ListLogger
from fab_tpu_torch.utils.profiling import trace
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64


# Warm-up calls before each component's timed ones.
WARMUP = 3


def bench(fn, device, n=20, warmup=WARMUP):
    """Median wall time of ``fn()``, each call ended by a device synchronisation."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for _ in range(warmup):
        fn()
        sync()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="experiments/configs/aldp.yaml")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--trace-dir", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    device = resolve_device(args.device)
    dtype = maybe_enable_x64(cfg)
    setup_precision(cfg)
    print(f"matmul_precision={cfg.training.get('matmul_precision', 'highest')}, "
          f"backend={cfg.system.get('backend', 'jax')}, batch {args.batch}, "
          f"{args.repeats} repeats")

    model, target = make_aldp_model(cfg, dtype, device)
    B, n_rep = args.batch, args.repeats
    flow = model.flow
    generator = torch.Generator(device=device).manual_seed(0)
    transition = model.init(generator)
    key = log_q_noise(flow, generator)  # an SNF's log-q noise; None otherwise
    log_q = lambda x_: flow_log_prob(flow, x_, key)
    with torch.no_grad():
        x, _ = flow.sample_and_log_prob(B, generator)

    rows = []

    def report(name, fn, count_per_iter, n=n_rep):
        calls = AldpEnergyServer.calls
        seconds = bench(fn, device, n=n, warmup=WARMUP)
        server = (AldpEnergyServer.calls - calls) / (n + WARMUP)
        rows.append((name, seconds, count_per_iter))
        print(f"{name:42s} {seconds * 1e3:9.2f} ms/call  x{count_per_iter:5.1f}/iter"
              f"  = {seconds * count_per_iter * 1e3:9.2f} ms/iter"
              + (f"  ({server:g} server calls/call)" if target.backend == "host_cpp" else ""),
              flush=True)

    n_dists = model.ais.n_intermediate_distributions
    n_leap = model.ais.transition_operator.n_leapfrog
    rb = cfg.training.replay_buffer
    n_replay = int(rb.n_updates)
    n_hmc = n_dists * (n_leap + 1)

    # --- leaf components
    with torch.no_grad():
        report("flow.sample_and_log_prob", lambda: flow.sample_and_log_prob(B, generator), 1)
        report("flow.log_prob (fwd)", lambda: log_q(x), 0)
    # HMC recomputes both x-gradients at every leapfrog step of every distribution,
    # plus the Metropolis endpoints.
    report("grad_x flow.log_prob", lambda: batched_value_and_grad(log_q, x), n_hmc)
    with torch.no_grad():
        report("target.log_prob (fwd)", lambda: target.log_prob(x), 0)
    report("grad_x target.log_prob", lambda: batched_value_and_grad(target.log_prob, x), n_hmc)
    with torch.no_grad():
        report("internal->cartesian transform (fwd)",
               lambda: target.transform.flow_to_cartesian(x)[0], 0)
    params = [q for q in flow.parameters() if q.requires_grad]
    report("grad_params flow.log_prob (replay core)",
           lambda: torch.autograd.grad(log_q(x).mean(), params), n_replay)

    # --- composite programs
    report(f"FULL AIS pass (sample + {n_dists}-dist HMC)",
           lambda: model.ais.sample_and_log_weights(transition, generator, B,
                                                    p_target=False, tune=True), 1)
    buffer = PrioritisedReplayBuffer(dim=target.dim, max_length=rb.max_length * B,
                                     min_sample_length=rb.min_length * B)
    trainer = PrioritisedBufferTrainer(
        model, make_optimizer(1e-4, 100.0), buffer, n_batches_buffer_sampling=n_replay,
        w_adjust_max_clip=rb.get("max_adjust_w_clip"), logger=ListLogger(), dtype=dtype,
        device=device,
    )
    print(f"filling buffer ({rb.min_length} batches) ...", flush=True)
    state = [trainer.init_state(generator, batch_size=B)]

    def step():
        state[0], _ = trainer.train_step(state[0], generator, B)

    report("FULL train step (AIS+add+sample+replay)", step, 1, n=max(n_rep // 2, 1))
    t_step = rows[-1][1]
    print(f"\n=> {1.0 / t_step:.2f} it/s, {B / t_step:.0f} samples/s")

    if args.trace_dir:
        with trace(args.trace_dir):
            for _ in range(3):
                step()
        print(f"trace written to {args.trace_dir}")
    return rows


if __name__ == "__main__":
    main()
