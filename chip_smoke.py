#!/usr/bin/env python3
"""Drive the PyTorch port (fab_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases:
  1. Environment: the card's name and power limit, torch and CUDA versions; build
     every kernel from the sources in this checkout (one nvcc per source), and the
     host C++ ALDP energy server (g++), all started together.
  2. K1 (fused RealNVP chain: 3xTF32 mma.sync products, weights streamed by TMA
     and multicast across clusters of 2 blocks) against its plain PyTorch version
     on the card at ManyWell-32 shapes, with every parameter perturbed (a fresh
     coupling's last layer is zero): forward, inverse, ragged batches (1, 100,
     2047, 2049 rows), a bitwise repeat, a width the wrapper zero-pads for TMA
     (many_well_fast.yaml's dim 6, width 240), round trip, a [4, 512, 32] input,
     and gradients through its autograd Function.
  3. ManyWell-32 FAB with a prioritised buffer at bench.py's settings (batch 2048;
     RealNVP 10 x [coupling, width 320; LU]; HMC with 4 intermediate
     distributions, 5 leapfrog steps; buffer 32768 / 8192; 8 replay batches), with
     the fused flow, so every flow pass runs through K1: init_state, then 5 train
     steps. Launch counters are zeroed just before and read just after.
  4. One more ManyWell step under torch.profiler (K1's kernels are named `k1_*`);
     K1 timing with CUDA events, and its launch plan (clusters; L2 reads reckoned
     from the shapes, not measured).
  5. K2 (one large-dim affine coupling, 3xTF32 wgmma GEMMs fed by TMA) against its
     plain version at LGCP-1600 shapes (B=512, D=1600, H=3200, scale cap 5):
     forward, inverse, a bitwise repeat of the log-det, an in-place weight update
     (the prepared weight copies must follow it), round trip, a [4, 128, 1600]
     input, and gradients through its autograd Function.
  6. LGCP-1600 FAB with a prioritised buffer at experiments/configs/lgcp.yaml's
     settings with flow.fused_coupling=true (RealNVP 8 x [coupling, width 3200,
     scale cap 5; LU]; HMC with 8 intermediate distributions, 5 leapfrog steps,
     step size 0.2; batch 512; buffer 65536 / 4096; 4 replay batches), f32, at lr
     1e-5 instead of the config's 1e-4: from a fresh flow, 1e-4 masks every AIS row
     from the second step on and 3e-5 all but a few (python3 -m
     fab_tpu_torch.lgcp_lr_sweep).
     init_state, then 5 train steps, every coupling through K2. Counters (launches,
     recomputes, prepared-weight rebuilds) are zeroed just before and read just
     after.
  7. One more LGCP step under torch.profiler; the trainer's run entry point (2
     iterations and one dual-target eval, logged to a CSV); K2 timing, with the
     prepared-weight rebuild.
  8. K1 at the wide chains its stages are split for (10 layers, B=2048 and a ragged
     B=1000): D=32 / H=640, D=64 / d_cond=32 / H=640 and D=32 / d_cond=8 / H=320
     against the plain version, a bitwise repeat, and its time against the 3xTF32
     bound.
  9. The GMM-40 paper experiment through the port's runner
     (python3 -m fab_tpu_torch.experiments.run_gmm on experiments/configs/gmm.yaml:
     D=2, RealNVP 15 x [coupling 80-80, LU], Metropolis AIS with one intermediate
     distribution, batch 128, the plain Trainer, f64) for 20 iterations with one
     eval (512 samples) and one checkpoint; 5 more timed steps and a profiled one;
     a resume from the checkpoint for 2 iterations; the runner once more with
     training.use_buffer=true (BufferTrainer) for 3 iterations.
 10. The ManyWell runner on experiments/configs/many_well.yaml (f64, the plain flow
     setup_run builds, prioritised buffer) for 2 iterations with one eval, so the
     exact-sample metrics run on the card.
 11. The alanine-dipeptide experiment (experiments/configs/aldp.yaml: 60-D internal
     coordinates, implicit solvent, 12 circular spline blocks of width 256 with 8
     bins, HMC 8 x 4 leapfrog steps of 0.1, batch 1024, buffer 512 / 8 batches, 8
     replay updates, the chirality filter, cosine schedule with 1000 warm-up
     updates), f32, cut in length only (ALDP_CUTS, printed): the model built
     directly (minimisation, cut to MINIMISE_STEPS (1000 of 4000), test set,
     init_state and ALDP_STEPS (2) steps timed, the LR of
     every update printed, a profiled step), then the runner for 3 iterations with
     one eval and the final evaluation, and its resume for one iteration.
 12. The resampled (LARS) base and stochastic normalizing flows, f32/f64 as each
     config sets, cut in length only (LARS_SNF_CUTS, printed beside each config's
     value): aldp_rbd.yaml (vacuum; the LARS base, acceptance net 2 x 256, T = 100,
     1024 points; 12 spline blocks of width 256, 8 bins; HMC 8 x 4; batch 1024;
     prioritised buffer; the chirality filter) and aldp_snf.yaml (the same flow over
     the gauss-uni base with 3 MH layers of the vacuum force field, their steps cut
     10 -> SNF_MH_STEPS (1), so 3 target evaluations inside every log q) through
     run_aldp: init_state (their buffers start empty) and 2 compiled steps, each
     call of the compiled step timed (the first with its build), one eval (the SNF
     1 step and none: SNF_CUTS), the final evaluation, a profiled eager step (not the
     SNF's, cut: phase 19 profiles a replay of its captured step), and the LARS
     acceptance (Z and the mean a(z)); aldp_ml.yaml
     (vacuum, ML) for 2 iterations between them. The three share phase 11's
     minimised reference frame (no second minimisation) and rbd's vacuum
     test set. Then GMM-40 through run_gmm on gmm.yaml with
     flow.resampled_base=true and with flow.use_snf=true (5 MH layers of one step
     of 5.0): 5 iterations, one eval, 5 timed steps, one more with CUDA's sync
     debug mode on "error" (the log-q keys wait for no device); each writes one
     checkpoint for phase 13.
 13. (a) The host C++ energy server (system.backend: host_cpp) against the torch
     force field on the card (1024 test-set positions of phase 11, implicit
     solvent, f64), then aldp.yaml (phase 11's cuts and reference frame) on the jax
     (on-device) backend and on host_cpp: init_state, eager steps taken in turns
     (HOST_ORDER: 1 each), and a profiled eager host_cpp step (the jax one cut: phase
     11 profiles it): median step, device busy, device ops and server calls per step.
     Then the compiled host_cpp step (a CUDA graph with one host node and three copies
     per server call) against its eager twin, bitwise (graph_turns, HOST_GRAPH_TURNS:
     1 each, cut from 2, printed), and the compiled jax and host_cpp steps in turns
     (HOST_COMPILED_ORDER):
     median step, busy share, server calls and host nodes per step.
     (b) profile_aldp at batch 1024 on both backends, its repeats cut to
     PROFILE_REPEATS (1) and its warm-up calls to PROFILE_WARMUP (0; printed).
     (c) evaluate.py on phase 9's GMM-40 checkpoint and phase
     12's as rsb_* and snf_*, and on the LGCP-1600 flow of phases 6-7 with
     flow.fused_coupling=true (K2 launches counted, > 0 asserted);
     evaluate_expectation.py on the GMM-40 checkpoint (20 repeats of 100);
     sample_aldp.py and reeval_aldp.py on phase 11's run; every CSV and .npz value
     finite. (d) Without matplotlib (the card machine has none), the "plots off"
     line, and no PNG written anywhere.
 14. Data parallelism (fab_tpu_torch/parallel/) on the card: an NCCL process group
     of world size 1 (tcp://127.0.0.1:<free port>, rank 0) and its data mesh.
     ManyWell-32 at phase 3's widths through K1: init_state, one warm-up step each,
     then 3 timed steps through the data-parallel trainer and 3 through the plain
     one from the same state and seed, in turns (DP_ORDER). After 4 steps each their
     parameters, step sizes and buffer priorities agree (f32, relative 1e-5;
     bitwise equality is printed), K1's launches per step are the plain path's
     (38 + 29), and the collectives per step equal the count reckoned from the code
     (expected_collectives, printed beside it). One more step under CUDA's sync
     check on "error" (no host sync added) and a profiled one (NCCL kernels' device
     time); one all-reduce's and one all-gather's time. A
     torch.distributed.checkpoint round trip of the trainer state (exact; save and
     load ms, bytes), whose resumed step equals the uninterrupted one. Then
     python3 -m torch.distributed.run --standalone --nproc_per_node=1 -m
     fab_tpu_torch.experiments.run_many_well on many_well.yaml with mesh.n_data=1
     (DP_LAUNCHER_CUTS; started before phase 11, see below): exit 0, every CSV value
     finite, and rank 0's checkpoint loaded in this process. More than one card is
     not measured: NCCL refuses two ranks on one device.
 15. (a) The mesh's model axis on the card: two processes of this script
     (--model-axis-rank, a gloo group on tcp://127.0.0.1:<free port>: gloo carries
     the CUDA tensors through the host) form a (1, 2) grid. Each runs ManyWell-32 at
     phase 3's widths, f64 (MA_DTYPE), init_state (one batch) and MA_STEPS (1; 2
     before the cut, printed) steps,
     with the plain flow
     Megatron-split (H = 320 -> 160 per rank) and with the fused flow, whose K1
     takes the gathered weights (the two started before phase 11, see below), and
     this process runs both from the same seeds alone. Parameters, step sizes and
     buffer priorities agree (relative 1e-5), the two ranks bitwise; K1's launches per step per rank are the plain path's
     (38 + 29); the collectives per step by axis equal the counts reckoned from the
     code (expected_model_collectives, expected_collectives). Then one LGCP-1600
     step on the grid through K2 on gathered weights (the buffer starts at one
     batch, MA_LG_BUFFER_MIN): 400 launches + 360 recomputes, no more
     prepared-weight rebuilds than phase 6's 96. (b) The wrappers: FABModel over a
     WrappedModuleFlow around an nn.Module written here (_smoke_module) with a
     WrappedTorchDist target (a MixtureSameFamily of GMM-40's shape on the card,
     f64): 5 Trainer steps with gmm.yaml's Metropolis AIS, finite losses, every
     tensor on the card, and one more step under the sync check.
 16. The port's bench and scripts, cut in length only where printed (PHASE16_BUDGET_S
     240 s; the phase prints its wall time): (a) python3 -m fab_tpu_torch.bench at
     bench.py's settings (ManyWell-32 as phase 3; 2 warm-up and 3 timed compiled steps
     (make_train_step, CUDA graphs) of the fused and the plain trainer in turns, then
     3 eager steps each in turns, BENCH_CUTS from its default 10): its one JSON line
     with bench.py's keys, value and vs_baseline (the compiled steps') finite and > 0,
     mfu in (0, 1], K1 38 + 29 per eager fused step and in its graph, from its
     stderr. (b) python3 -m fab_tpu_torch.bench_scaling --mesh-sizes 1 under
     NCCL (batch 2048 per device, 1 warm-up and 2 steps; started before phase 11, see
     below): efficiency_vs_1 1.0. (c)
     bench_lgcp_kernel at its defaults: K2 within 1e-3 of the plain layer, both
     layer times, the whole LGCP-1600 flow's sample_and_log_prob and log_prob fused
     and plain in turns. (d) evaluate.py on the phase 6-7 flow through K2 with the
     f64 factor and with target.in_graph_kernel=true, same seed and samples: K2
     launched in both, 0 < max |dL| < IN_GRAPH_L_GAP, the in-graph target built
     without the f64 factor and factored in f32, every column finite, the
     flow-side columns within IN_GRAPH_RTOL relative, and a control (the f64 factor
     rounded to half precision) beyond it. (e) ground_truth_marginals,
     rejection_sampling_vis, alpha_study, aldp_torsion_scan (72 x 72),
     aldp_phi_overlay and aldp_external_anchor on phase 11's run and frame,
     many_well_demo, gmm_demo and aldp_demo --train: every CSV, JSON and .npz value finite, no kernel launched,
     and without matplotlib no PNG written.
 17. The experiments/*.sh studies as the port's modules (fab_tpu_torch/experiments/
     <stem>.py; PHASE17_BUDGET_S 150 s, the phase prints its wall time): (a) each
     one's --dry-run lists its script's cell count; (b) one cell of each training
     study runs through its runner's subprocess on the card, the six at once, cut
     in length only (STUDY_CUTS, printed: 2 iterations, one eval, one checkpoint):
     exit 0, its
     checkpoint written, its CSV finite (MAY_BE_INFINITE aside); (c)
     eval_gmm_study on the two gmm_study runs (samples cut to GMM_STUDY_EVAL_N) and
     the table of the port's latex_table; (d) eval_lgcp_trajectory on
     the LGCP-1600 flow after phase 6's steps and after phase 7's run, with
     flow.fused_coupling=true, in this process: K2's counts zeroed just before and
     read just after (> 0 asserted), every column finite; (e) the options the port
     gained to match fab_tpu (ESS of normalised weights, the chirality filter's
     options, circular_bound, PeriodicShift's bound, a Flow's default base,
     guarded_update's flow_params, init_info) on card tensors against the CPU, f64,
     within 1e-12.
 18. The compiled step (Trainer.make_train_step: one whole step captured as a CUDA
     graph and replayed; PHASE18_BUDGET_S 120 s) on the trainers phases 3, 7 and 9
     leave: ManyWell-32 (K1; captured here), LGCP-1600 (K2; captured by phase 7's run)
     and GMM-40 (f64; captured by phase 9's runner). Each against an eager twin (a
     copy of its model) from one state and seed: one warm-up step each, then steps in
     turns (GRAPH_TURNS: 3 each, GMM-40 5), their medians; the capture and
     instantiation seconds and the graph's private pool; the wrappers' counts (the
     eager twin's) against the captured step's; parameters, step sizes and buffer
     priorities within relative 1e-5 (f32) / 1e-12 (f64), bitwise equality printed;
     on LGCP-1600 perform_eval after the graphed steps against after the eager ones
     (relative 1e-5); one replay under the profiler: device busy, and K1's kernels
     (38) and K2's five kernels per launch (400 each, plus 96 k2_prepare_weight) in
     the graph, as captured; the state's copy back, captured alone and replayed;
     make_scanned_train_step(b, 4) against 4 single replays, bitwise.
 19. The compiled programs of the spline, LARS, SNF and data-mesh paths (graph.Program;
     PHASE19_BUDGET_S 300 s, the phase prints its wall time), on the trainers phases
     3, 11, 12 and 14 leave, at full width: ManyWell-32's data-parallel step under a
     new NCCL group of world size 1 (captured here: its collectives per captured step
     equal expected_collectives, K1's 38 kernel nodes in its graph), GMM-40 with
     flow.resampled_base and flow.use_snf (f64), aldp.yaml (phase 11's resumed run),
     aldp_rbd and aldp_snf (phase 12's runs; their steps captured by the runs). Each
     against an eager twin from one state and seed, in turns (PHASE19_TURNS: 3 for
     the data mesh, 5 for GMM-40, 2 for aldp.yaml and aldp_rbd, 1 for aldp_snf; the
     ALDP paths take no warm-up step, their kernels ran in phases 11-12): the
     medians, capture and instantiation seconds, the private pool, the host's
     resident memory around the build, the graph's kernel nodes through libcuda,
     one profiled replay's busy share; the state within
     relative 1e-5 (f32) / 1e-12 (f64), bitwise equality printed. Then the compiled
     fill against the eager fill from one seed, buffers and transition states
     compared, each fill's seconds: aldp.yaml (its buffer's minimum cut 64 -> 1
     batch, FILL_BATCHES, printed) and ManyWell-32 (4 passes, 22 K1 launches
     captured per pass). Then the paths that draw on the host (random.host_draw, in
     the noise pass before each replay), each against its eager twin in turns (3
     each), bitwise: ManyWell-32 target_forward_kl (many_well.yaml's fused flow, no
     AIS, its 16 wells' rejection sampling one host draw; K1's one launch and one
     recompute per captured step, its kernel node in the graph), a RealNVP over a
     WrappedTorchDist target and a WrappedModuleFlow over GMM-40 (f64, batch 128).
     PHASE19_TURNS cut aldp.yaml's and aldp_rbd's turns 2 -> 1 (printed).
  Every buffer trainer's init_state fills through a captured fill pass (phases 3 and
  6 assert its counts: 22 K1 / 336 K2 launches per replayed pass, the wrappers
  counting the warm-up pass and the capture). The runs of phases 7, 9-12, 14's
  launcher, 16(a) and 17(b) go through the compiled step (run prints "train step:
  compiled (...)", run_ml_training "ml step: compiled (...)"); phases 11-12 time the
  compiled step's calls, and their profiled steps are eager. Phase 15(a) keeps the
  eager step, for the reason graph_supported prints (the model axis); phase 15(b)
  and 13(a)'s first turns call train_step eagerly. The runner, ALDP, LARS and SNF paths
  launch no kernel (fab_tpu's runners build no fused flow; K2 is reached through
  flow.fused_coupling=true on lgcp.yaml, phases 6-7; the ALDP flow is a spline
  chain; the LARS and SNF flows are unfused): their counts are zeroed before and
  asserted 0 after.
  Three commands that need nothing of this process start as processes of their own
  just before phase 11 and run beside phases 11-13 (_Started): phase 14's launcher
  run, 16(b)'s bench_scaling and 15(a)'s two model-axis ranks. Each is read, and
  checked, in its own phase; every process the script starts is stopped before it
  exits.

Prints the kernel JSON line, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero on any failure, and without a card.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import csv
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# Peak rates for the bounds: f32 on the CUDA cores, dense TF32 on the tensor cores
# and device-memory bandwidth (NVIDIA's H100 data sheet; SXM at 700 W, PCIe at
# 350 W).
PEAKS = {
    "sxm": {"f32_flops": 67e12, "tf32_flops": 495e12, "bytes_per_s": 3.35e12},
    "pcie": {"f32_flops": 51e12, "tf32_flops": 378e12, "bytes_per_s": 2.0e12},
}

N_STEPS = 5
# ManyWell-32 (bench.py).
MW_DIM, MW_LAYERS, MW_NODES, MW_BATCH = 32, 10, 10, 2048
# LGCP-1600 (experiments/configs/lgcp.yaml; lr: see the docstring).
LG_GRID, LG_LAYERS, LG_NODES, LG_CAP, LG_BATCH = 40, 8, 2, 5.0, 512
LG_DISTS, LG_LEAPFROG, LG_EPS = 8, 5, 0.2
LG_BUFFER, LG_BUFFER_MIN, LG_REPLAY, LG_LR = 65536, 4096, 4, 1e-5
# K1's wide chains (D, d_cond, H), 10 layers.
K1_WIDE = [(32, 16, 640), (64, 32, 640), (32, 8, 320)]
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments", "configs")
RUNNER_COMMON = ["--device", "cuda", "training.n_flow_forward_pass=null", "evaluation.n_eval=1",
                 "evaluation.n_plots=0"]


def _peaks(name: str) -> dict:
    return PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def _bounds_ms(flops: float, bytes_moved: float, name: str) -> dict:
    """The least time for `flops` f32-accurate operations and `bytes_moved`, two
    ways: f32 FMAs on the CUDA cores, and 3xTF32 on the tensor cores (three TF32
    products per product). Each is (ms, what bounds it)."""
    peaks = _peaks(name)
    t_bytes = bytes_moved / peaks["bytes_per_s"] * 1e3
    bounds = {}
    for way, t_ops in (("f32_fma", flops / peaks["f32_flops"] * 1e3),
                       ("3xtf32", 3 * flops / peaks["tf32_flops"] * 1e3)):
        bounds[way] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return bounds


def _time_ms(fn, n: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _perturb(module, generator, scale: float) -> None:
    import torch

    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=generator, device=p.device))


def _max_rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


def _spills(report: str, kernel: str) -> tuple:
    """(spill store bytes, spill load bytes) of `kernel` in an `-Xptxas -v` report."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", lines[i + 1])
            return int(found.group(1)), int(found.group(2))
    raise AssertionError(f"no -Xptxas -v report for {kernel}")


def _zero_counts() -> None:
    from fab_tpu_torch.flows.fused import FusedPass
    from fab_tpu_torch.ops import coupling_kernel as ck
    from fab_tpu_torch.ops import realnvp_kernel as rk

    rk.fused_realnvp_pass.launches = 0
    FusedPass.recomputes = 0
    ck.fused_coupling_apply.launches = 0
    ck.FusedCoupling.recomputes = 0
    ck.prepared_weight.rebuilds = 0


def _counts() -> dict:
    from fab_tpu_torch import graph

    return graph.counts()


def _train(trainer, gen, batch, card, label):
    """init_state + N_STEPS train steps with the launch counters read around each;
    asserts a finite loss and valid rows on every step."""
    import torch

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    state = trainer.init_state(gen, batch_size=batch)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    init_counts = _counts()
    fill = trainer.fill_program
    assert fill is not None and fill.graph is not None, "init_state did not capture its fill"
    fill_info = {"captured": fill.captured_counts, "replays": fill.replays,
                 "capture_s": fill.capture_s, "instantiate_s": fill.instantiate_s,
                 "pool_bytes": fill.pool_bytes}
    print(f"[{card}] {label} init_state: {fill.replays} replays of the captured fill pass "
          f"(capture {fill.capture_s:.2f} s, instantiation {fill.instantiate_s:.3f} s, private "
          f"pool {fill.pool_bytes / 2**30:.2f} GiB; kernel counts per pass "
          f"{fill.captured_counts})")
    step_ms, per_step = [], []
    for _ in range(N_STEPS):
        before = _counts()
        t0 = time.time()
        state, info = trainer.train_step(state, gen, batch)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in _counts().items()})
        loss, n_valid = float(info["loss"]), int(info["n_valid"])
        print(f"{label} step {state.step}: {step_ms[-1]:.1f} ms, replay loss {loss:.4f}, "
              f"n_valid {n_valid}, ess_ais {float(info['ess_ais']):.4f}, "
              f"update_applied {bool(info['update_applied'])}")
        assert math.isfinite(loss), f"{label}: non-finite loss"
        assert n_valid > 0, f"{label}: no valid AIS row"
    total = _counts()
    steady = statistics.median(step_ms[1:])
    print(f"[{card}] {label} FAB+buffer train step: median {steady:.1f} ms over steps "
          f"2-{N_STEPS} (all: {', '.join(f'{t:.1f}' for t in step_ms)}), "
          f"{batch / steady * 1e3:.1f} AIS samples/s; init_state {init_s:.2f} s")
    return state, info, {"init": init_counts, "per_step": per_step, "total": total,
                         "steady_ms": steady, "init_s": init_s, "fill": fill_info}


def _profile_step(trainer, state, gen, batch, steady, card, label, groups):
    """One more step under torch.profiler, recording the device: its busy time
    (one stream, so kernels do not overlap) against the step (``steady``, or with
    None the profiled step's own wall), the top device ops, and the share of named
    groups of ops (an op counts in the first group whose words its name holds).
    Returns the state, the busy share, each group's ms and the device op count."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        state, _ = trainer.train_step(state, gen, batch)
        torch.cuda.synchronize()
        prof_ms = (time.time() - t0) * 1e3
    # The raw device events summed by name: building the profiler's FunctionEvents
    # (key_averages) takes minutes for a step of a million kernels.
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    n_ops = sum(count for _, count in by_name.values())
    assert n_ops > 0, "the profiler saw no device work"
    steady = steady or prof_ms
    print(f"[{card}] {label} profiled step: wall {prof_ms:.1f} ms (profiler on), device "
          f"busy {busy_ms:.1f} ms ({busy_ms / prof_ms:.1%} of the profiled wall, "
          f"{busy_ms / steady:.1%} of the median step), {n_ops} device ops")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    {ms:8.2f} ms  x{count:<6d} {name[:90]}")
    group_ms = dict.fromkeys(groups, 0.0)
    for name, (ms, _) in by_name.items():
        group = next((g for g, words in groups.items()
                      if any(w in name.lower() for w in words)), None)
        if group is not None:
            group_ms[group] += ms
    for group, ms in group_ms.items():
        print(f"    group {group}: {ms:.2f} ms ({ms / busy_ms:.1%} of device busy)")
    return state, busy_ms / steady, group_ms, n_ops


# ------------------------------------------------------------------- K1 / ManyWell


def check_k1(device, gen):
    import torch

    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.flows.fused import _stack_params
    from fab_tpu_torch.ops import realnvp_kernel as rk

    # Larger perturbations overflow exp() in a 10-layer chain.
    fused = make_realnvp(MW_DIM, MW_LAYERS, MW_NODES, fused=True, generator=gen,
                         device=device)
    _perturb(fused, gen, 0.005)
    plain = make_realnvp(MW_DIM, MW_LAYERS, MW_NODES, fused=False, generator=gen,
                         device=device)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(MW_BATCH, MW_DIM, generator=gen, device=device)
    keys = ("w1", "b1", "w2", "b2", "w3", "b3", "wlin", "lu_ld")
    operands, errors = {}, {}
    with torch.no_grad():
        for inverse in (False, True):
            s = _stack_params(fused, inverse)
            args = [s[k] for k in keys]
            operands[inverse] = args
            y, ld = rk.fused_realnvp_pass(x, *args, inverse)
            y_ref, ld_ref = rk.fused_realnvp_pass_reference(x, *args, inverse)
            torch.cuda.synchronize()
            assert torch.isfinite(y_ref).all() and torch.isfinite(ld_ref).all()
            # y: f32 through 10 layers, the plain version's matmuls sum in another
            # order; log_det: 10 layers of f32 sums in another order.
            torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)
            mode = "inverse" if inverse else "forward"
            errors[mode] = (float((y - y_ref).abs().max()), float((ld - ld_ref).abs().max()))
            print(f"K1 {mode}: max|y - plain| {errors[mode][0]:.3e}, "
                  f"max|log_det - plain| {errors[mode][1]:.3e}")
        # Ragged batches: a lone row, part-filled clusters, one row short of and one
        # past the main batch (padded rows are zero and never stored).
        for batch in (1, 100, MW_BATCH - 1, MW_BATCH + 1):
            xr = torch.randn(batch, MW_DIM, generator=gen, device=device)
            for inverse in (False, True):
                y, ld = rk.fused_realnvp_pass(xr, *operands[inverse], inverse)
                y_ref, ld_ref = rk.fused_realnvp_pass_reference(xr, *operands[inverse], inverse)
                torch.cuda.synchronize()
                torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
                torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)
                errors[f"{'inverse' if inverse else 'forward'} B={batch}"] = (
                    float((y - y_ref).abs().max()), float((ld - ld_ref).abs().max()))
        ragged = max(e[0] for k, e in errors.items() if "B=" in k)
        print(f"K1 at B = 1, 100, {MW_BATCH - 1}, {MW_BATCH + 1}, both modes: max|y - plain| "
              f"{ragged:.3e}, max|log_det - plain| "
              f"{max(e[1] for k, e in errors.items() if 'B=' in k):.3e}")
        # Every sum in a fixed order, no float atomics: two launches, the same bits.
        for inverse in (False, True):
            first = rk.fused_realnvp_pass(x, *operands[inverse], inverse)
            second = rk.fused_realnvp_pass(x, *operands[inverse], inverse)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, second)), "K1 is not repeatable"
        print("K1 repeated, both modes: y and log_det bitwise equal")
        # An odd d_cond and d_trans (3 and 3): run zero-padded to D=8, d_cond=4.
        narrow = make_realnvp(6, MW_LAYERS, 40, fused=True, generator=gen, device=device)
        _perturb(narrow, gen, 0.005)
        xn = torch.randn(MW_BATCH, 6, generator=gen, device=device)
        for inverse in (False, True):
            s = _stack_params(narrow, inverse)
            args = [s[k] for k in keys]
            y, ld = rk.fused_realnvp_pass(xn, *args, inverse)
            y_ref, ld_ref = rk.fused_realnvp_pass_reference(xn, *args, inverse)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)
            errors[f"{'inverse' if inverse else 'forward'} D=6"] = (
                float((y - y_ref).abs().max()), float((ld - ld_ref).abs().max()))
        print(f"K1 at D=6, H=240 (padded to D=8, d_cond=4), both modes: max|y - plain| "
              f"{max(e[0] for k, e in errors.items() if 'D=6' in k):.3e}")
        y, ld_f = fused.forward_and_log_det(x)
        x_back, ld_i = fused.inverse_and_log_det(y)
        torch.cuda.synchronize()
        torch.testing.assert_close(x_back, x, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(ld_i, -ld_f, atol=1e-3, rtol=1e-4)
        print(f"K1 round trip: max|inverse(forward(x)) - x| {float((x_back - x).abs().max()):.3e}")
        # A [n, B, D] input is flattened into one launch, not run through the plain chain.
        before = rk.fused_realnvp_pass.launches
        x3 = x.reshape(4, MW_BATCH // 4, MW_DIM)
        z3, ld3 = fused.inverse_and_log_det(x3)
        z3_ref, ld3_ref = plain.inverse_and_log_det(x3)
        torch.cuda.synchronize()
        assert rk.fused_realnvp_pass.launches == before + 1
        torch.testing.assert_close(z3, z3_ref, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld3, ld3_ref, atol=1e-3, rtol=0)
        print(f"K1 on a {tuple(x3.shape)} input: one launch, max|z - plain| "
              f"{float((z3 - z3_ref).abs().max()):.3e}")

    cot_y = torch.randn(MW_BATCH, MW_DIM, generator=gen, device=device)
    cot_ld = torch.randn(MW_BATCH, generator=gen, device=device)
    grads = []
    for flow in (fused, plain):
        xg = x.clone().requires_grad_(True)
        z, _ = flow.inverse_and_log_det(xg)
        loss = (z * cot_y).sum() + (flow.log_prob(xg) * cot_ld).sum()
        grads.append(torch.autograd.grad(loss, [xg, *flow.parameters()]))
    torch.cuda.synchronize()
    grad_err = max(_max_rel_err(a, b) for a, b in zip(*grads))
    # Both backwards recompute the chain with PyTorch ops; they differ by the
    # f32 rounding of the stacked-parameter route.
    assert grad_err < 1e-4, f"K1 gradients disagree with plain autograd: {grad_err}"
    print(f"K1 gradients (input + {len(grads[0]) - 1} parameters) vs plain autograd: "
          f"max relative error {grad_err:.3e}")
    return {"x": x, "operands": operands, "errors": errors}


def manywell_path(device, gen, card):
    from fab_tpu_torch.buffer import PrioritisedReplayBuffer
    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo
    from fab_tpu_torch.targets import ManyWellEnergy
    from fab_tpu_torch.train import PrioritisedBufferTrainer, make_optimizer

    import torch

    target = ManyWellEnergy(MW_DIM, device=device)
    flow = make_realnvp(MW_DIM, MW_LAYERS, MW_NODES, fused=True, generator=gen,
                        device=device)
    op = HamiltonianMonteCarlo(
        n_ais_intermediate_distributions=4, n_outer=1, n_leapfrog=5, epsilon=1.0
    )
    model = FABModel.create(
        flow, target, transition_operator=op, n_intermediate_distributions=4,
        loss_type="fab_alpha_div",
    )
    buffer = PrioritisedReplayBuffer(
        dim=MW_DIM, max_length=MW_BATCH * 16, min_sample_length=MW_BATCH * 4
    )
    trainer = PrioritisedBufferTrainer(
        model, make_optimizer(3e-4, 100.0), buffer, n_batches_buffer_sampling=8,
        w_adjust_max_clip=10.0, device=device,
    )
    state, _, run = _train(trainer, gen, MW_BATCH, card, "ManyWell-32")
    init, per_step, total = run["init"], run["per_step"], run["total"]
    # The fill: 4 AIS passes of 22 K1 launches, each a replay of the captured pass;
    # the wrappers counted the warm-up pass and the capture.
    fill = run["fill"]
    assert (fill["replays"], fill["captured"]["k1"], init["k1"]) == (4, 22, 2 * 22), (fill, init)
    assert all((p["k1"], p["k1_recomputes"]) == (38, 29) for p in per_step), (
        f"K1 launches/recomputes per step: {per_step}"
    )
    assert total["k2"] == total["k2_rebuilds"] == 0, "K2 is not on the ManyWell path"
    print(f"ManyWell-32 path: K1 launches {total['k1']} (init_state {init['k1']}: its fill's "
          f"warm-up and capture; 22 in each of its 4 replays; 38 per step), backward "
          f"recomputations {total['k1_recomputes']} (29 per step)")

    # Output check: finite parameters and buffer, and the trained fused flow agrees
    # with the plain Flow holding the same parameters on buffer rows.
    assert all(torch.isfinite(p).all() for p in flow.parameters())
    lw = state.buffer_state.log_w
    assert int(torch.isfinite(lw).sum()) > 0 and not torch.isnan(lw).any()
    check = make_realnvp(MW_DIM, MW_LAYERS, MW_NODES, fused=False, generator=gen,
                         device=device)
    check.load_state_dict(flow.state_dict())
    rows = state.buffer_state.x[torch.isfinite(lw)][:256]
    with torch.no_grad():
        lq_fused, lq_plain = flow.log_prob(rows), check.log_prob(rows)
    torch.testing.assert_close(lq_fused, lq_plain, atol=1e-3, rtol=1e-4)

    # The AIS pass alone (the rest of a step is the buffer and the replay steps).
    torch.cuda.synchronize()
    t0 = time.time()
    model.ais.sample_and_log_weights(state.transition_state, gen, MW_BATCH,
                                     p_target=False, tune=False)
    torch.cuda.synchronize()
    ais_ms = (time.time() - t0) * 1e3
    print(f"[{card}] ManyWell-32 AIS pass alone: {ais_ms:.1f} ms "
          f"({ais_ms / run['steady_ms']:.1%} of the median step)")
    _, busy, groups, _ = _profile_step(trainer, state, gen, MW_BATCH, run["steady_ms"], card,
                                    "ManyWell-32",
                                    {"K1": ["k1_tf32x3"], "triangular solves": ["trsm"]})
    assert groups["K1"] > 0, "the profiler saw no K1 kernel"
    run["busy"], run["k1_group_ms"] = busy, groups["K1"]
    return run, trainer, state


def time_k1(k1, name, card):
    import torch

    from fab_tpu_torch.ops import realnvp_kernel as rk

    x, operands = k1["x"], k1["operands"]
    L, d_cond, H = operands[True][0].shape
    flops, bytes_moved = _k1_flops_bytes(MW_BATCH, MW_DIM, d_cond, H, L,
                                         sum(t.numel() for t in operands[True]))
    bounds = _bounds_ms(flops, bytes_moved, name)
    timing = {}
    for inverse in (False, True):
        args = operands[inverse]
        with torch.no_grad():
            timing[inverse] = (
                _time_ms(lambda: rk.fused_realnvp_pass(x, *args, inverse)),
                _time_ms(lambda: rk.fused_realnvp_pass_reference(x, *args, inverse)),
            )
        print(f"[{card}] K1 {'inverse' if inverse else 'forward'}: kernel "
              f"{timing[inverse][0]:.4f} ms, plain {timing[inverse][1]:.4f} ms, "
              f"{_bounds_text(bounds)} ({flops / 1e9:.3f} GFLOP, {bytes_moved / 1e6:.2f} MB)")
    print("K1 library_ms: none - no single PyTorch call computes the fused RealNVP chain")
    plan = rk.plan_launch(MW_BATCH, MW_DIM, d_cond, H, L)
    print(f"K1 launch: {plan.blocks} blocks in {plan.clusters} clusters of {rk.CLUSTER}, "
          f"{plan.slots} ring slots of {plan.slot_bytes} B, {plan.smem_bytes} B of shared "
          f"memory per block; L2 reads per pass reckoned from the shapes (not measured): "
          f"{plan.l2_read_bytes / 1e6:.1f} MB (one stream per block would be "
          f"{plan.l2_read_bytes_unshared / 1e6:.1f} MB)")
    return timing, bounds


def _bounds_text(bounds) -> str:
    return (f"bound {bounds['f32_fma'][0]:.4f} ms by {bounds['f32_fma'][1]} at the f32 FMA "
            f"rate, {bounds['3xtf32'][0]:.4f} ms by {bounds['3xtf32'][1]} in 3xTF32 on "
            "the tensor cores")


def _k1_flops_bytes(B, D, d_cond, H, L, weights):
    """Operations of one pass (two per multiply-add) and the bytes it must move: x,
    y and log_det once, every weight once."""
    flops = 2.0 * B * L * (d_cond * H + H * H + H * 2 * (D - d_cond) + D * D)
    return flops, 4.0 * (2 * B * D + B + weights)


def _wide_operands(D, d_cond, H, L, gen, device):
    """A 10-layer chain of any split: He-initialised hidden layers, a small last
    layer (log-scales ~0.1), orthogonal LU mixes."""
    import torch

    n3 = 2 * (D - d_cond)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=device)
    return [normal(L, d_cond, H) * (2 / d_cond) ** 0.5, 0.1 * normal(L, H),
            normal(L, H, H) * (2 / H) ** 0.5, 0.1 * normal(L, H),
            normal(L, H, n3) * 0.1 / H ** 0.5, 0.05 * normal(L, n3),
            torch.linalg.qr(normal(L, D, D))[0], 0.1 * normal(L, 1)]


def check_k1_wide(device, gen, name, card) -> list:
    """K1 against its plain version at the wide chains, a bitwise repeat, and its
    time (inverse and forward) against the 3xTF32 bound."""
    import torch

    from fab_tpu_torch.ops import realnvp_kernel as rk

    records = []
    for D, d_cond, H in K1_WIDE:
        ops = _wide_operands(D, d_cond, H, MW_LAYERS, gen, device)
        plan = rk.plan_launch(MW_BATCH, D, d_cond, H, MW_LAYERS)
        errors = []
        with torch.no_grad():
            for batch in (MW_BATCH, 1000):
                x = torch.randn(batch, D, generator=gen, device=device)
                for inverse in (False, True):
                    y, ld = rk.fused_realnvp_pass(x, *ops, inverse)
                    y_ref, ld_ref = rk.fused_realnvp_pass_reference(x, *ops, inverse)
                    torch.cuda.synchronize()
                    assert torch.isfinite(y_ref).all() and float(y_ref.abs().max()) > 1.0
                    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
                    torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)
                    errors.append((float((y - y_ref).abs().max()),
                                   float((ld - ld_ref).abs().max())))
            x = torch.randn(MW_BATCH, D, generator=gen, device=device)
            first = rk.fused_realnvp_pass(x, *ops, True)
            second = rk.fused_realnvp_pass(x, *ops, True)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, second)), "K1 is not repeatable"
            timing = {inverse: (_time_ms(lambda: rk.fused_realnvp_pass(x, *ops, inverse)),
                                _time_ms(lambda: rk.fused_realnvp_pass_reference(x, *ops, inverse)))
                      for inverse in (True, False)}
        weights = sum(t.numel() for t in ops)
        flops, bytes_moved = _k1_flops_bytes(MW_BATCH, D, d_cond, H, MW_LAYERS, weights)
        bounds = _bounds_ms(flops, bytes_moved, name)
        shape = f"D={D} d_cond={d_cond} H={H}"
        print(f"[{card}] K1 at {shape}, L={MW_LAYERS}: max|y - plain| "
              f"{max(e[0] for e in errors):.3e}, max|log_det - plain| "
              f"{max(e[1] for e in errors):.3e} (B = {MW_BATCH} and 1000, both modes), "
              f"bitwise repeatable; kernel {timing[True][0]:.4f} ms inverse / "
              f"{timing[False][0]:.4f} forward, plain {timing[True][1]:.4f} / "
              f"{timing[False][1]:.4f}, {_bounds_text(bounds)} ({flops / 1e9:.3f} GFLOP); "
              f"{plan.groups} column group(s), {plan.stages_per_layer} stages per layer, "
              f"{plan.slots} ring slots, {plan.smem_bytes} B of shared memory")
        records.append({
            "shape": shape, "ms": timing[True][0], "ms_forward": timing[False][0],
            "plain_ms": timing[True][1], "plain_ms_forward": timing[False][1],
            "bound_ms": bounds["3xtf32"][0], "bound_by": bounds["3xtf32"][1],
            "max_abs_err": max(e[0] for e in errors),
            "max_abs_err_log_det": max(e[1] for e in errors),
            "slots": plan.slots, "smem_bytes": plan.smem_bytes,
        })
    return records


# ------------------------------------------------------------- the YAML runners


def _csv_rows(run_dir):
    (path,) = [os.path.join(d, "logging_hist.csv") for d in
               (os.path.join(run_dir, e) for e in os.listdir(run_dir))]
    with open(path) as f:
        return list(csv.DictReader(f))


def _finite_columns(row, names):
    shown = {k: float(row[k]) for k in names}
    bad = [k for k, v in shown.items() if not math.isfinite(v)]
    assert not bad, f"not finite: {bad}"
    return shown


def _no_kernel_launched(label):
    counts = _counts()
    assert not any(counts.values()), f"{label} launched a kernel: {counts}"


def gmm_runner(device, gen, card, tmp):
    """The GMM-40 runner (Trainer, f64): 20 iterations with an eval and a checkpoint,
    5 timed steps and a profiled one, a resume, and the BufferTrainer run."""
    import torch

    from fab_tpu_torch.experiments import run_gmm
    from fab_tpu_torch.train import BufferTrainer, Trainer

    config = ["--config", os.path.join(CONFIGS, "gmm.yaml"), *RUNNER_COMMON]
    first = os.path.join(tmp, "gmm")
    _zero_counts()
    t0 = time.time()
    trainer, state = run_gmm.main(config + ["training.n_iterations=20",
                                            "evaluation.n_checkpoints=1",
                                            f"evaluation.save_path={first}"])
    torch.cuda.synchronize()
    run_s = time.time() - t0
    _no_kernel_launched("the GMM-40 runner")
    assert type(trainer) is Trainer and state.step == 20 and trainer.dtype == torch.float64
    # Two chunks of log_every (10) steps, each one make_scanned_train_step call.
    program = trainer._programs[128]
    assert program.graph is not None and program.replays == 20, program.replays
    rows = _csv_rows(first)
    eval_rows = [r for r in rows if r.get("eval_ess_ais")]
    assert [r["step"] for r in rows] == ["10.0", "20.0", "20.0"] and len(eval_rows) == 1, rows
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    assert all(math.isfinite(v) for v in losses), losses
    shown = _finite_columns(eval_rows[0], (
        "eval_ess_flow", "eval_ess_ais", "flow_test_set_mean_log_prob", "flow_kl_forward",
        "flow_bias_normed", "ais_bias_normed"))
    print(f"[{card}] GMM-40 runner (gmm.yaml, f64, Trainer): 20 iterations, one eval at 512 "
          f"and one checkpoint in {run_s:.1f} s (the target's 1e7-sample true expectation "
          f"included); loss {losses[-1]:.4f}; eval " +
          ", ".join(f"{k} {v:.4g}" for k, v in shown.items()))

    # Step time: 5 more steps of the runner's trainer, then one under the profiler.
    batch = 128
    step_ms = []
    for _ in range(N_STEPS):
        t0 = time.time()
        state, info = trainer.train_step(state, gen, batch)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        assert math.isfinite(float(info["loss"])) and int(info["n_valid"]) > 0
    steady = statistics.median(step_ms[1:])
    print(f"[{card}] GMM-40 train step: median {steady:.1f} ms over steps 2-{N_STEPS} (all: "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}), {batch / steady * 1e3:.1f} AIS samples/s")
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.model.ais.sample_and_log_weights(state.transition_state, gen, batch,
                                             p_target=False, tune=False)
    torch.cuda.synchronize()
    ais_ms = (time.time() - t0) * 1e3
    print(f"[{card}] GMM-40 AIS pass alone: {ais_ms:.1f} ms ({ais_ms / steady:.1%} of the "
          "median step)")
    state, busy, groups, _ = _profile_step(trainer, state, gen, batch, steady, card, "GMM-40", {
        "triangular solves": ["trsm"], "GEMMs": ["gemm", "cutlass", "sm90_xmma"]})
    gmm_trainer = (trainer, state)
    _no_kernel_launched("the GMM-40 steps")

    # Resume from the checkpoint at iteration 20.
    t0 = time.time()
    _, resumed = run_gmm.main(config + [
        "training.n_iterations=22", "evaluation.n_checkpoints=0",
        f"evaluation.save_path={os.path.join(tmp, 'gmm_resumed')}",
        f"training.checkpoint_load_dir={first}"])
    torch.cuda.synchronize()
    assert resumed.step == 22
    rows = _csv_rows(os.path.join(tmp, "gmm_resumed"))
    assert [r["step"] for r in rows] == ["22.0", "22.0"], rows
    print(f"[{card}] GMM-40 runner resumed from iteration 20 for 2 iterations "
          f"({time.time() - t0:.1f} s); eval ess_ais {float(rows[-1]['eval_ess_ais']):.4g}")

    # The uniform-buffer trainer.
    t0 = time.time()
    buffered, bstate = run_gmm.main(config + [
        "training.n_iterations=3", "training.use_buffer=true", "evaluation.n_checkpoints=0",
        f"evaluation.save_path={os.path.join(tmp, 'gmm_buffer')}"])
    torch.cuda.synchronize()
    _no_kernel_launched("the GMM-40 buffer runner")
    assert type(buffered) is BufferTrainer and bstate.step == 3
    rows = _csv_rows(os.path.join(tmp, "gmm_buffer"))
    train_rows = [r for r in rows if r.get("replay_loss")]
    for r in train_rows:
        _finite_columns(r, ("loss", "replay_loss"))
    shown = _finite_columns(rows[-1], ("eval_ess_ais", "flow_kl_forward"))
    print(f"[{card}] GMM-40 runner with training.use_buffer=true (BufferTrainer): 3 "
          f"iterations in {time.time() - t0:.1f} s (buffer filled to "
          f"{int(bstate.buffer_state.n_added)} rows), replay loss "
          f"{float(train_rows[-1]['replay_loss']):.4f}; eval "
          + ", ".join(f"{k} {v:.4g}" for k, v in shown.items()))
    return {"steady_ms": steady, "busy": busy, "ais_ms": ais_ms, "run_s": run_s,
            "groups": groups, "trainer": gmm_trainer}


def many_well_runner(card, tmp):
    """The ManyWell runner on many_well.yaml (f64, plain flow, prioritised buffer):
    2 iterations and one eval, whose flow metrics use exact samples."""
    import torch

    from fab_tpu_torch.experiments import run_many_well

    out = os.path.join(tmp, "many_well")
    _zero_counts()
    t0 = time.time()
    trainer, state = run_many_well.main([
        "--config", os.path.join(CONFIGS, "many_well.yaml"), *RUNNER_COMMON,
        "training.n_iterations=2", "evaluation.n_checkpoints=0", f"evaluation.save_path={out}"])
    torch.cuda.synchronize()
    _no_kernel_launched("the ManyWell runner")
    assert state.step == 2 and trainer.dtype == torch.float64
    rows = _csv_rows(out)
    eval_rows = [r for r in rows if r.get("eval_ess_ais_p_target")]
    assert len(eval_rows) == 1, rows
    for r in rows:
        if r.get("loss"):
            _finite_columns(r, ("loss",))
    shown = _finite_columns(eval_rows[0], (
        "flow_forward_kl_p_target", "flow_test_set_exact_mean_log_prob_p_target",
        "flow_test_set_modes_mean_log_prob_p_target", "ais_abs_MSE_log_Z_estimate_p_target",
        "eval_ess_ais_min_var_target"))
    print(f"[{card}] ManyWell-32 runner (many_well.yaml, f64, plain flow): buffer fill to "
          f"{int(state.buffer_state.n_added)} rows, 2 iterations and one eval in "
          f"{time.time() - t0:.1f} s; eval " + ", ".join(f"{k} {v:.4g}" for k, v in shown.items()))


# ------------------------------------------------------------------------ ALDP

# aldp.yaml cut in length only; every width, the buffer's size, the schedule and the
# filter stay the config's. The buffer starts empty (no fill pass: a compiled fill
# costs a warm-up pass and a capture; phase 19 checks aldp.yaml's compiled fill): the
# first steps' replay draws of 8 x 1024 rows then take rows not yet written
# (priority -inf, masked out of the loss), which cost the same flow passes as
# written ones.
ALDP_STEPS = 2  # phase 11's timed steps of the model built directly
# The reference frame's gradient descent (AldpBoltzmann's 4000 steps), cut in length:
# each step is a few hundred launches on the card; the later phases only need a
# relaxed frame, not the deepest one.
MINIMISE_STEPS_BEFORE = 4000
MINIMISE_STEPS = 1000
ALDP_GROUPS = {"GEMMs": ["gemm", "cutlass", "sm90_xmma"], "reductions": ["reduce"],
               "gather / scatter": ["index", "gather", "scatter"]}
ALDP_CUTS = ["training.max_iter=3", "training.replay_buffer.min_length=0",
             "training.n_test_samples=2000", "training.test_mcmc_steps=20",
             "training.final_eval_samples=2000", "training.n_eval=1",
             "training.n_checkpoints=1"]


def _print_cuts(full, cuts, config_name, card) -> None:
    """Each cut beside the config's own value."""
    for cut in cuts:
        key, value = cut.split("=")
        old = full
        for part in key.split("."):
            old = old.get(part, "unset") if old != "unset" else old
        if key == "training.test_mcmc_steps" and old == "unset":
            old = "unset, the runner's default 400"
        print(f"[{card}] {config_name} cut (length only): {key} = {value} "
              f"({config_name}: {old})")


def _finite_metrics(metrics, label):
    bad = {k: v for k, v in metrics.items() if not math.isfinite(float(v))}
    assert not bad, f"{label}: non-finite metrics {bad}"
    return ", ".join(f"{k} {float(v):.4g}" for k, v in metrics.items())


def aldp_path(device, gen, card, tmp):
    """The ALDP experiment (aldp.yaml: implicit solvent, 12 spline blocks, HMC 8 x 4,
    batch 1024, buffer 512 / 8 batches, 8 replay updates, the chirality filter, the
    cosine schedule with warm-up), f32: the model built directly for timing, counting
    and profiling; then the runner, its resume and the ML variant. No kernel runs on
    this path (asserted)."""
    import functools
    from unittest import mock

    import numpy as np
    import torch

    from fab_tpu_torch.buffer import PrioritisedReplayBuffer
    from fab_tpu_torch.experiments import make_aldp_model as aldp_model_module
    from fab_tpu_torch.experiments import run_aldp
    from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
    from fab_tpu_torch.targets.aldp import AldpBoltzmann
    from fab_tpu_torch.experiments.setup_run import setup_precision
    from fab_tpu_torch.train import PrioritisedBufferTrainer
    from fab_tpu_torch.utils.training import apply_overrides, load_config

    config = os.path.join(CONFIGS, "aldp.yaml")
    root = os.path.join(tmp, "aldp")
    os.makedirs(root)
    full = load_config(config)
    _print_cuts(full, ALDP_CUTS, "aldp.yaml", card)
    cfg = apply_overrides(full, ALDP_CUTS)
    t, rb = cfg.training, cfg.training.replay_buffer
    batch = t.batch_size
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()

    # The model, its reference configuration by MINIMISE_STEPS steps of gradient
    # descent, the test set by HMC, then init_state and ALDP_STEPS steps, each timed.
    setup_precision(cfg)
    print(f"[{card}] aldp.yaml cut (length only): the reference frame's minimisation "
          f"{MINIMISE_STEPS_BEFORE} -> {MINIMISE_STEPS} steps of gradient descent")
    torch.cuda.synchronize()
    t0 = time.time()
    with mock.patch.object(aldp_model_module, "AldpBoltzmann",
                           functools.partial(AldpBoltzmann, minimise_steps=MINIMISE_STEPS)):
        model, target = make_aldp_model(cfg, torch.float32, device)
    torch.cuda.synchronize()
    minimise_s = time.time() - t0
    ref_path = os.path.join(tmp, "aldp_reference.npy")
    np.save(ref_path, target.ref_cartesian)
    t0 = time.time()
    z_test = run_aldp.generate_test_set(target, gen, int(t.n_test_samples), int(t.test_mcmc_steps))
    torch.cuda.synchronize()
    test_set_s = time.time() - t0
    assert z_test.shape == (int(t.n_test_samples), 60) and np.isfinite(z_test).all()
    np.save(os.path.join(root, "test_set.npy"), z_test)
    print(f"[{card}] ALDP set-up: target with its {MINIMISE_STEPS}-step minimisation "
          f"{minimise_s:.2f} s; "
          f"test set ({len(z_test)} rows, {t.test_mcmc_steps} HMC sweeps of 10 leapfrog "
          f"steps) {test_set_s:.2f} s")

    buffer = PrioritisedReplayBuffer(dim=target.dim, max_length=rb.max_length * batch,
                                     min_sample_length=rb.min_length * batch)
    trainer = PrioritisedBufferTrainer(
        model, run_aldp._optimizer(t), buffer, n_batches_buffer_sampling=rb.n_updates,
        w_adjust_max_clip=rb.max_adjust_w_clip, device=device)
    torch.cuda.synchronize()
    t0 = time.time()
    state = trainer.init_state(gen, batch_size=batch)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    print(f"[{card}] ALDP init_state: buffer filled to {int(state.buffer_state.n_added)} rows "
          f"({int(state.buffer_state.n_added) // batch} AIS passes of {batch}) in "
          f"{init_s:.2f} s")
    step_ms = []
    for _ in range(ALDP_STEPS):
        count = int(state.opt_state.count)
        t0 = time.time()
        state, info = trainer.train_step(state, gen, batch)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        lrs = [float(trainer.optimizer.learning_rate(torch.tensor(c)))
               for c in range(count, int(state.opt_state.count))]
        loss, n_valid = float(info["loss"]), int(info["n_valid"])
        frac = float(info["frac_filter_pass"])
        print(f"ALDP step {state.step}: {step_ms[-1]:.1f} ms, replay loss {loss:.4f}, n_valid "
              f"{n_valid}, frac_filter_pass {frac:.4f}, ess_ais {float(info['ess_ais']):.4f}; "
              f"LR of its {len(lrs)} updates: " + ", ".join(f"{lr:.4g}" for lr in lrs))
        assert math.isfinite(loss), "ALDP: non-finite loss"
        assert n_valid > 0, "ALDP: no valid AIS row"
        assert math.isfinite(frac), "ALDP: no frac_filter_pass"
    steady = statistics.median(step_ms[1:])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] ALDP FAB+buffer train step: median {steady:.1f} ms over steps 2-{ALDP_STEPS} "
          f"(all: {', '.join(f'{v:.1f}' for v in step_ms)}), {batch / steady * 1e3:.1f} AIS "
          f"samples/s; peak device memory {peak_gib:.2f} GiB")
    torch.cuda.synchronize()
    t0 = time.time()
    model.ais.sample_and_log_weights(state.transition_state, gen, batch, p_target=False,
                                     tune=False)
    torch.cuda.synchronize()
    ais_ms = (time.time() - t0) * 1e3
    print(f"[{card}] ALDP AIS pass alone: {ais_ms:.1f} ms ({ais_ms / steady:.1%} of the "
          "median step)")
    _, busy, groups, _ = _profile_step(trainer, state, gen, batch, steady, card, "ALDP",
                                       ALDP_GROUPS)
    del trainer, state, model
    _no_kernel_launched("the ALDP steps")

    # The runner on aldp.yaml with the cuts, on the reference and test set above; its
    # resume for one more iteration; the ML variant (aldp_ml.yaml, its own vacuum
    # minimisation and sets).
    common = ["--device", "cuda", *ALDP_CUTS, f"training.save_root={root}",
              f"data.transform={ref_path}"]
    starts = []
    run = PrioritisedBufferTrainer.run

    def recording_run(self, *args, **kw):
        starts.append(kw["start_iter"])
        return run(self, *args, **kw)

    PrioritisedBufferTrainer.run = recording_run
    try:
        t0 = time.time()
        runner, r_state, metrics = run_aldp.main(["--config", config, *common])
        torch.cuda.synchronize()
        run_s = time.time() - t0
        assert isinstance(runner, PrioritisedBufferTrainer) and r_state.step == 3
        rows = [r for r in _csv_rows_in(root) if r.get("loss")]
        shown = _finite_columns(rows[-1], ("loss", "n_valid", "frac_filter_pass"))
        print(f"[{card}] ALDP runner (aldp.yaml, the cuts above): init_state, 3 iterations, one "
              f"eval and one checkpoint, the final evaluation in {run_s:.1f} s; last logged step "
              + ", ".join(f"{k} {v:.4g}" for k, v in shown.items()))
        print(f"[{card}] ALDP final evaluation (2000 flow samples against the test set): "
              + _finite_metrics(metrics, "ALDP final evaluation"))
        t0 = time.time()
        runner, r_state, metrics = run_aldp.main(["--config", config, *common,
                                                  "training.max_iter=4"])
        torch.cuda.synchronize()
        assert starts == [0, 3] and r_state.step == 4, (starts, r_state.step)
        assert runner._program(batch).graph is not None, "the resumed run did not compile"
        _finite_metrics(metrics, "ALDP resumed evaluation")
        print(f"[{card}] ALDP runner resumed at iteration {starts[-1]} for 1 iteration "
              f"({time.time() - t0:.1f} s)")
    finally:
        PrioritisedBufferTrainer.run = run
    _no_kernel_launched("the ALDP phase")
    return {"steady_ms": steady, "busy": busy, "ais_ms": ais_ms, "init_s": init_s,
            "minimise_s": minimise_s, "test_set_s": test_set_s, "groups": groups,
            "run_s": run_s, "trainer": (runner, r_state)}


def _csv_rows_in(run_dir):
    with open(os.path.join(run_dir, "logging_hist.csv")) as f:
        return list(csv.DictReader(f))


# ------------------------------------------------------------ LARS base and SNF

# aldp_rbd.yaml and aldp_snf.yaml cut in length only: every width, the buffer's
# size, the 8 replay updates, the schedule and the filter stay each config's. The
# buffers start empty, as aldp.yaml's in phase 11 (a fill is one more capture; phase
# 19 checks the compiled fill).
LARS_SNF_CUTS = ["training.max_iter=2", "training.replay_buffer.min_length=0",
                 "training.n_test_samples=2000", "training.test_mcmc_steps=20",
                 "training.final_eval_samples=2000", "training.n_eval=1",
                 "training.n_checkpoints=1"]
# The SNF's step takes ~30 s eager and its build ~130 s (capture and instantiation of
# ~1.5M kernel nodes at aldp_snf.yaml's 10 MH steps a layer), so it runs 1 iteration,
# its MH layers take SNF_MH_STEPS steps each (depth: the 3 layers, their places and
# proposal scale stay; 5 until the host-drawn paths of phases 13 and 19 came, then 3
# until the smoke took 1430 s on a slow host), and it
# leaves out the trainer's eval: two more AIS passes whose only output on ALDP is two
# ESS values (the target has no eval metrics of its own; the final evaluation runs).
# GMM-40 with flow.use_snf=true runs an eval.
SNF_MH_STEPS = 1
SNF_CUTS = (["training.max_iter=1", f"flow.snf.steps={SNF_MH_STEPS}"] + LARS_SNF_CUTS[1:5]
            + ["training.n_eval=0"] + LARS_SNF_CUTS[6:])


def _lars_share(base, gen, card, label) -> dict:
    """The LARS base after a run: Z (the mean a(z) over its 1024 fixed proposal
    points), the mean a(z) over fresh proposals and over the base's own draws."""
    import torch

    with torch.no_grad():
        big_z = float(base.z_estimate())
        z_prop = torch.randn((8192, base.dim), generator=gen, device=base.z_points.device,
                             dtype=base.z_points.dtype)
        a_prop = float(base.accept_prob(z_prop).mean())
        z, _ = base.sample_and_log_prob(8192, gen)
        a_drawn = float(base.accept_prob(z).mean())
    assert all(math.isfinite(v) and 0 < v < 1 for v in (big_z, a_prop, a_drawn))
    print(f"[{card}] {label} LARS acceptance: Z estimate {big_z:.6f} (mean a(z) over the "
          f"1024 fixed points), mean a(z) over 8192 fresh proposals {a_prop:.6f}, over 8192 "
          f"of the base's draws {a_drawn:.6f}")
    return {"z_estimate": big_z, "mean_a_proposals": a_prop, "mean_a_drawn": a_drawn}


def _timed_aldp_runner(argv, card, label):
    """run_aldp.main with the prioritised trainer's init_state and every call of its
    compiled step timed (each ends in a synchronize; the first builds the program: a
    warm-up step and the capture). Returns (trainer, state, metrics, times)."""
    import torch

    from fab_tpu_torch import graph
    from fab_tpu_torch.experiments import run_aldp
    from fab_tpu_torch.train import PrioritisedBufferTrainer

    times = {"calls": []}
    init, call = PrioritisedBufferTrainer.init_state, graph.StepProgram.__call__

    def timed_init(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = init(self, *args, **kw)
        torch.cuda.synchronize()
        times["init_s"] = time.time() - t0
        return out

    def timed_call(self, state, generator, n_steps=1):
        built = self.static is not None
        t0 = time.time()
        out = call(self, state, generator, n_steps)
        torch.cuda.synchronize()
        times["calls"].append((n_steps, (time.time() - t0) * 1e3, built))
        print(f"{label} compiled step call of {n_steps} step(s) to step {out[0].step}"
              f"{'' if built else ' (its build: a warm-up step and the capture)'}: "
              f"{times['calls'][-1][1]:.1f} ms, replay loss {float(out[1]['loss']):.4f}, "
              f"n_valid {int(out[1]['n_valid'])}, frac_filter_pass "
              f"{float(out[1]['frac_filter_pass']):.4f}", flush=True)
        return out

    PrioritisedBufferTrainer.init_state = timed_init
    graph.StepProgram.__call__ = timed_call
    try:
        t0 = time.time()
        trainer, state, metrics = run_aldp.main(argv)
        torch.cuda.synchronize()
        times["run_s"] = time.time() - t0
    finally:
        PrioritisedBufferTrainer.init_state = init
        graph.StepProgram.__call__ = call
    return trainer, state, metrics, times


def _aldp_variant(config_name, cuts, extra, gen, card, label, tmp, profile=True):
    """One ALDP variant through run_aldp with ``cuts`` (and ``extra`` overrides):
    init_state (its fill compiled) and the cuts' max_iter steps through the compiled
    step, the evals the cuts leave, the final evaluation; then, with ``profile``, one
    profiled eager step. Returns (trainer, state, run directory, figures)."""
    import torch

    from fab_tpu_torch.train import PrioritisedBufferTrainer
    from fab_tpu_torch.utils.training import load_config

    config = os.path.join(CONFIGS, config_name)
    root = os.path.join(tmp, label)
    os.makedirs(root, exist_ok=True)
    full = load_config(config)
    _print_cuts(full, cuts, config_name, card)
    batch = full.training.batch_size
    torch.cuda.reset_peak_memory_stats()
    trainer, state, metrics, times = _timed_aldp_runner(
        ["--config", config, "--device", "cuda", *cuts, f"training.save_root={root}", *extra],
        card, label)
    n_steps = int(next(c for c in cuts if c.startswith("training.max_iter=")).split("=")[1])
    assert isinstance(trainer, PrioritisedBufferTrainer) and state.step == n_steps
    assert sum(n for n, _, _ in times["calls"]) == n_steps, times
    program = trainer._program(batch)
    fill = trainer.fill_program  # built only if the buffer's minimum asks for a pass
    assert program.graph is not None and fill is not None, "the run did not compile"
    fill_text = "an empty buffer, no fill pass"
    if fill.replays:
        fill_text = (f"buffer filled to {int(state.buffer_state.n_added) - n_steps * batch} "
                     f"rows in {fill.replays} replays of the captured fill pass: capture "
                     f"{fill.capture_s:.2f} s, instantiation {fill.instantiate_s:.2f} s")
    rows = _csv_rows_in(root)
    shown = _finite_columns([r for r in rows if r.get("loss")][-1],
                            ("loss", "n_valid", "frac_filter_pass"))
    evals = [r for r in rows if r.get("eval_ess_ais_p_target")]
    assert len(evals) == ("training.n_eval=1" in cuts), rows
    eval_shown = {}
    if evals:
        eval_shown = _finite_columns(evals[0], (
            "eval_ess_flow_p_target", "eval_ess_ais_p_target", "eval_ess_ais_min_var_target"))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] {label} ({config_name}, the cuts above): init_state {times['init_s']:.2f} s "
          f"({fill_text}); {n_steps} compiled steps in calls of "
          + ", ".join(f"{n} ({ms:.1f} ms{'' if built else ', with the build'})"
                      for n, ms, built in times["calls"])
          + f" (capture {program.capture_s:.2f} s, instantiation {program.instantiate_s:.2f} s, "
          f"private pool {program.pool_bytes / 2**30:.2f} GiB); the whole run "
          f"{times['run_s']:.1f} s; peak device memory {peak_gib:.2f} GiB; last step "
          + ", ".join(f"{k} {v:.4g}" for k, v in shown.items()) + "; eval "
          + (", ".join(f"{k} {v:.4g}" for k, v in eval_shown.items()) or "cut"))
    print(f"[{card}] {label} final evaluation (2000 flow samples against the test set): "
          + _finite_metrics(metrics, f"{label} final evaluation"))
    out = {"init_s": times["init_s"], "run_s": times["run_s"], "calls": times["calls"],
           "peak_gib": peak_gib}
    if profile:
        state, out["busy_profiled"], out["groups"], out["device_ops"] = _profile_step(
            trainer, state, gen, batch, None, card, f"{label} eager", ALDP_GROUPS)
    return trainer, state, root, out


def lars_snf_path(device, gen, card, tmp):
    """Phase 12: aldp_rbd.yaml (the LARS base) and aldp_snf.yaml (3 MH layers of 10
    steps of the vacuum force field inside every log q) through run_aldp at full
    width, then GMM-40 with flow.resampled_base=true and with flow.use_snf=true. The
    two ALDP runs share phase 11's minimised frame and one test set. No kernel runs on
    this path (asserted)."""
    import numpy as np
    import torch

    from fab_tpu_torch.experiments import run_aldp, run_gmm
    from fab_tpu_torch.flows import ResampledGaussianBase, StochasticFlow
    from fab_tpu_torch.train import Trainer

    _zero_counts()
    out = {"trainers": {}}
    trainer, state, rbd_root, out["rbd"] = _aldp_variant(
        "aldp_rbd.yaml", LARS_SNF_CUTS,
        [f"data.transform={os.path.join(tmp, 'aldp_reference.npy')}"], gen, card, "ALDP-rbd",
        tmp)
    base = trainer.model.flow.base
    assert isinstance(base, ResampledGaussianBase) and base.T == 100
    assert base.sizes == [60, 256, 256, 1] and tuple(base.z_points.shape) == (1024, 60)
    out["rbd"]["lars"] = _lars_share(base, gen, card, "ALDP-rbd")
    ref_path = os.path.join(tmp, "aldp_vacuum_reference.npy")
    np.save(ref_path, trainer.model.target.ref_cartesian)
    out["trainers"]["aldp_rbd"] = (trainer, state)
    _no_kernel_launched("the ALDP rbd run")
    for label in ("ALDP-snf", "ALDP-ml"):
        os.makedirs(os.path.join(tmp, label))
        shutil.copy(os.path.join(rbd_root, "test_set.npy"), os.path.join(tmp, label))

    # aldp_ml.yaml (vacuum too) on the same frame and test set, its own training set.
    t0 = time.time()
    _, _, ml_metrics = run_aldp.main([
        "--config", os.path.join(CONFIGS, "aldp_ml.yaml"), "--device", "cuda",
        "training.max_iter=2", "training.n_train_samples=2000", "training.test_mcmc_steps=20",
        "training.final_eval_samples=2000", f"data.transform={ref_path}",
        f"training.save_root={os.path.join(tmp, 'ALDP-ml')}"])
    torch.cuda.synchronize()
    print(f"[{card}] ALDP ML runner (aldp_ml.yaml, vacuum, on the frame and test set above: a "
          f"training set of 2000, 2 iterations) in {time.time() - t0:.1f} s; evaluation "
          + _finite_metrics(ml_metrics, "ALDP ML evaluation"))
    _no_kernel_launched("the ALDP ML run")

    # Cut: no profiled eager step (~45 s); phase 19 times an eager step and profiles a
    # replay of this run's captured step.
    print(f"[{card}] ALDP-snf cut: no profiled eager step here (phase 19 profiles a replay)")
    trainer, state, _, out["snf"] = _aldp_variant(
        "aldp_snf.yaml", SNF_CUTS, [f"data.transform={ref_path}"], gen, card, "ALDP-snf", tmp,
        profile=False)
    flow = trainer.model.flow
    mh = [(b.lam, b.n_steps, b.proposal_scale) for b in flow.bijectors if hasattr(b, "lam")]
    assert isinstance(flow, StochasticFlow) and mh == [
        (4 / 12, SNF_MH_STEPS, 0.1), (8 / 12, SNF_MH_STEPS, 0.1), (1.0, SNF_MH_STEPS, 0.1)], mh
    print(f"[{card}] ALDP-snf flow: MH layers (lam, steps, proposal scale) {mh}, each log q "
          f"runs {3 * SNF_MH_STEPS} MH steps of the vacuum force field")
    out["trainers"]["aldp_snf"] = (trainer, state)
    del trainer, flow
    _no_kernel_launched("the ALDP snf run")

    config = ["--config", os.path.join(CONFIGS, "gmm.yaml"), *RUNNER_COMMON,
              "training.n_iterations=5", "evaluation.n_checkpoints=1"]
    for flag, label in (("flow.resampled_base=true", "GMM-40-rbd"),
                        ("flow.use_snf=true", "GMM-40-snf")):
        t0 = time.time()
        g_trainer, g_state = run_gmm.main(config + [
            flag, f"evaluation.save_path={os.path.join(tmp, label)}"])
        torch.cuda.synchronize()
        run_s = time.time() - t0
        assert type(g_trainer) is Trainer and g_state.step == 5
        assert g_trainer._program(128).graph is not None, f"{label}: the run did not compile"
        rows = _csv_rows(os.path.join(tmp, label))
        eval_rows = [r for r in rows if r.get("eval_ess_ais")]
        assert len(eval_rows) == 1, rows
        losses = [float(r["loss"]) for r in rows if r.get("loss")]
        assert losses and all(math.isfinite(v) for v in losses), losses
        shown = _finite_columns(eval_rows[0], (
            "eval_ess_flow", "eval_ess_ais", "flow_test_set_mean_log_prob", "flow_kl_forward",
            "flow_bias_normed", "ais_bias_normed"))
        g_flow = g_trainer.model.flow
        if label == "GMM-40-rbd":
            assert isinstance(g_flow.base, ResampledGaussianBase)
            out["gmm_rbd_lars"] = _lars_share(g_flow.base, gen, card, label)
        else:
            n_mh = sum(hasattr(b, "lam") for b in g_flow.bijectors)
            assert isinstance(g_flow, StochasticFlow) and n_mh == 5, n_mh
        step_ms = []
        for _ in range(N_STEPS):
            t0 = time.time()
            g_state, info = g_trainer.train_step(g_state, gen, 128)
            torch.cuda.synchronize()
            step_ms.append((time.time() - t0) * 1e3)
            assert math.isfinite(float(info["loss"])) and int(info["n_valid"]) > 0
        steady = statistics.median(step_ms[1:])
        # The log-q keys are host-side generator state: a step waits for no device.
        torch.cuda.set_sync_debug_mode("error")
        try:
            g_state, _ = g_trainer.train_step(g_state, gen, 128)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[label] = {"steady_ms": steady, "run_s": run_s}
        out["trainers"][label] = (g_trainer, g_state)
        print(f"[{card}] {label} runner (gmm.yaml, {flag}, f64, Trainer): 5 iterations and "
              f"one eval in {run_s:.1f} s, loss {losses[-1]:.4f}; train step median "
              f"{steady:.1f} ms over steps 2-{N_STEPS} (all: "
              f"{', '.join(f'{t:.1f}' for t in step_ms)}), one more step with no host sync "
              "(sync debug mode 'error'); eval " + ", ".join(f"{k} {v:.4g}" for k, v in shown.items()))
    _no_kernel_launched("the LARS and SNF phase")
    return out


# ------------------------------------- host C++ server, profiler, evaluation, sampling

# aldp.yaml's phase-13 steps and profile: cut in length only, as phase 11 (ALDP_CUTS);
# the profiler's repeats cut from 20 (10 for the train step) to PROFILE_REPEATS, its
# warm-up calls from 3 to PROFILE_WARMUP.
PROFILE_REPEATS = 1
PROFILE_WARMUP = 0
# aldp.yaml's steps on the two backends, one each.
HOST_ORDER = ("jax", "host_cpp")
ALDP_BATCH = 1024  # aldp.yaml's


def _host_server_check(target, z_test, device, card) -> dict:
    """The C++ server against the torch force field on the card, implicit solvent,
    f64, on 1024 test-set positions: energies rtol 1e-9, forces rtol 1e-6 / atol
    1e-8 (tests/test_aldp.py's f64 tolerances)."""
    import torch

    from fab_tpu_torch.targets.aldp_ff import energy_kcal, gb_energy_kcal

    z = torch.as_tensor(z_test[:1024], dtype=torch.float64, device=device)
    with torch.no_grad():
        x, _ = target.transform.flow_to_cartesian(z.to(target.dtype))
    pos = x.double().reshape(-1, 22, 3).requires_grad_(True)
    e_ref = energy_kcal(target.tables, pos) + gb_energy_kcal(target.tables, pos)
    (g_ref,) = torch.autograd.grad(e_ref.sum(), pos)
    server = target._server
    t0 = time.time()
    e, f = server.energy_and_force(pos.detach().cpu().numpy())
    call_ms = (time.time() - t0) * 1e3
    e = torch.as_tensor(e, device=device)
    f = torch.as_tensor(f, device=device)
    rel_e = float(((e - e_ref.detach()).abs() / e_ref.detach().abs()).max())
    torch.testing.assert_close(e, e_ref.detach(), rtol=1e-9, atol=0)
    torch.testing.assert_close(-f, g_ref, rtol=1e-6, atol=1e-8)
    err_f = float((-f - g_ref).abs().max())
    print(f"[{card}] host C++ server vs the torch force field on the card (1024 aldp.yaml "
          f"test-set positions, implicit solvent, f64): max relative energy error "
          f"{rel_e:.3e} (rtol 1e-9), max force error {err_f:.3e} kcal/mol/A (rtol 1e-6, "
          f"atol 1e-8); one server call of 1024 rows {call_ms:.1f} ms on "
          f"{server.n_threads} threads")
    return {"max_rel_energy_err": rel_e, "max_abs_force_err": err_f, "call_ms": call_ms}


def _host_backend_trainer(cfg, backend, device, gen) -> dict:
    """aldp.yaml's model and prioritised trainer with ``system.backend`` set, and its
    init_state (timed)."""
    import torch

    from fab_tpu_torch.buffer import PrioritisedReplayBuffer
    from fab_tpu_torch.experiments import run_aldp
    from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
    from fab_tpu_torch.train import PrioritisedBufferTrainer
    from fab_tpu_torch.utils.training import apply_overrides

    cfg = apply_overrides(cfg, [f"system.backend={backend}"])
    t, rb = cfg.training, cfg.training.replay_buffer
    batch = t.batch_size
    model, target = make_aldp_model(cfg, torch.float32, device)
    assert target.backend == backend
    trainer = PrioritisedBufferTrainer(
        model, run_aldp._optimizer(t), PrioritisedReplayBuffer(
            dim=target.dim, max_length=rb.max_length * batch,
            min_sample_length=rb.min_length * batch),
        n_batches_buffer_sampling=rb.n_updates, w_adjust_max_clip=rb.max_adjust_w_clip,
        device=device)
    torch.cuda.synchronize()
    t0 = time.time()
    state = trainer.init_state(gen, batch_size=batch)
    torch.cuda.synchronize()
    return {"trainer": trainer, "state": state, "batch": batch, "init_s": time.time() - t0,
            "steps_ms": [], "calls": []}


def host_cpp_path(device, gen, card, tmp) -> dict:
    """13(a): build the C++ server, hold it against the torch force field on the
    card, and take aldp.yaml steps on both backends in this call, in turns, on
    phase 11's minimised structure: median step, server calls per step, device
    busy and device ops of a profiled step."""
    import numpy as np
    import torch

    from fab_tpu_torch import native
    from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
    from fab_tpu_torch.native import AldpEnergyServer
    from fab_tpu_torch.utils.training import apply_overrides, load_config

    t0 = time.time()
    lib = native.build()
    build_s = time.time() - t0
    full = load_config(os.path.join(CONFIGS, "aldp.yaml"))
    cfg = apply_overrides(full, ALDP_CUTS + [
        f"data.transform={os.path.join(tmp, 'aldp_reference.npy')}"])
    print(f"[{card}] host C++ server: {lib.name} built or found in {build_s:.2f} s; "
          f"os.cpu_count() {os.cpu_count()}, n_threads {cfg.system.n_threads} "
          f"(aldp.yaml system.n_threads)")
    out = {"build_s": build_s, "n_threads": cfg.system.n_threads, "cpu_count": os.cpu_count()}
    _, target = make_aldp_model(apply_overrides(cfg, ["system.backend=host_cpp"]),
                                torch.float32, device)
    z_test = np.load(os.path.join(tmp, "aldp", "test_set.npy"))
    out["check"] = _host_server_check(target, z_test, device, card)
    del target

    # Both trainers live at once; only one target is host_cpp, so the server's
    # process-global tables stay its own. Steps in turns, so that a drift of the
    # host's speed in the call reaches both backends alike.
    runs = {b: _host_backend_trainer(cfg, b, device, gen) for b in ("jax", "host_cpp")}
    for backend in HOST_ORDER:
        run = runs[backend]
        before = AldpEnergyServer.calls
        t0 = time.time()
        run["state"], info = run["trainer"].train_step(run["state"], gen, run["batch"])
        torch.cuda.synchronize()
        run["steps_ms"].append((time.time() - t0) * 1e3)
        run["calls"].append(AldpEnergyServer.calls - before)
        assert math.isfinite(float(info["loss"])) and int(info["n_valid"]) > 0, backend
    print(f"[{card}] 13(a) cut: no profiled eager step on the jax backend (phase 11 "
          "profiles the same aldp.yaml eager step)")
    for backend, run in runs.items():
        label = f"ALDP-{backend}"
        steady = statistics.median(run["steps_ms"])
        busy = n_ops = None
        if backend == "host_cpp":
            before = AldpEnergyServer.calls
            _, busy, _, n_ops = _profile_step(run["trainer"], run["state"], gen, run["batch"],
                                              steady, card, label, ALDP_GROUPS)
            run["calls"].append(AldpEnergyServer.calls - before)
        print(f"[{card}] {label} (aldp.yaml, system.backend={backend}): init_state "
              f"{run['init_s']:.2f} s; eager train step median {steady:.1f} ms over "
              f"{len(run['steps_ms'])} steps taken in turns with the other backend (all: "
              f"{', '.join(f'{v:.1f}' for v in run['steps_ms'])}), "
              f"{run['batch'] / steady * 1e3:.1f} AIS samples/s"
              + (f"; device busy {busy:.1%} of the median step, {n_ops} device ops per step"
                 if busy is not None else "")
              + f"; server calls per step {run['calls']}")
        out[backend] = {"steady_ms": steady, "steps_ms": run["steps_ms"], "busy": busy,
                        "device_ops": n_ops, "server_calls_per_step": run["calls"][-1],
                        "init_s": run["init_s"]}
    out["compiled"] = compiled_host_turns(runs, card)
    return out


# 13(a)'s compiled host_cpp step against its eager twin, each (2 before the cut).
HOST_GRAPH_TURNS = 1
HOST_GRAPH_TURNS_BEFORE = 2
HOST_COMPILED_ORDER = ("jax", "host_cpp", "host_cpp", "jax")


def compiled_host_turns(runs, card) -> dict:
    """13(a), compiled: aldp.yaml's host_cpp step as a CUDA graph with one host node
    per server call against its eager twin, bitwise (graph_turns); then the compiled
    jax and host_cpp steps in turns (HOST_COMPILED_ORDER): median step, server calls
    and host nodes per step, each one profiled replay's busy share."""
    import torch

    from fab_tpu_torch.native import AldpEnergyServer

    host, jax_run = runs["host_cpp"], runs["jax"]
    batch = host["batch"]
    print(f"[{card}] 13(a) cut: the compiled host_cpp step's turns against its eager twin "
          f"{HOST_GRAPH_TURNS_BEFORE} -> {HOST_GRAPH_TURNS}")
    out = {"host_cpp_vs_eager": graph_turns(
        "ALDP-host_cpp", host["trainer"], host["state"], batch, 0.0, card, phase=13,
        turns=HOST_GRAPH_TURNS, scanned=False, bitwise=True)}
    steps = {b: runs[b]["trainer"].make_train_step(batch) for b in runs}
    states = {b: _clone_state(runs[b]["state"]) for b in runs}
    gens = {b: torch.Generator(device=runs[b]["trainer"].device).manual_seed(13) for b in runs}
    t0 = time.time()
    states["jax"], _ = steps["jax"](states["jax"], gens["jax"])  # its build
    torch.cuda.synchronize()
    build_s = time.time() - t0
    ms = {b: [] for b in runs}
    for backend in HOST_COMPILED_ORDER:
        calls = AldpEnergyServer.calls
        torch.cuda.synchronize()
        t0 = time.time()
        states[backend], info = steps[backend](states[backend], gens[backend])
        torch.cuda.synchronize()
        ms[backend].append((time.time() - t0) * 1e3)
        assert math.isfinite(float(info["loss"])) and int(info["n_valid"]) > 0, backend
        assert AldpEnergyServer.calls == calls  # a replay reaches no host counter
    medians = {b: statistics.median(v) for b, v in ms.items()}
    busy = {"host_cpp": out["host_cpp_vs_eager"]["busy"]}
    wall, by_name, _, _ = _device_events(lambda: steps["jax"](states["jax"], gens["jax"]))
    busy["jax"] = sum(v[0] for v in by_name.values()) / medians["jax"]
    programs = {b: runs[b]["trainer"]._program(batch) for b in runs}
    per_step = {b: programs[b].captured_counts.get("server calls", 0) for b in runs}
    nodes = {b: _graph_kernels(programs[b].graph)["host nodes"] for b in runs}
    assert per_step["jax"] == nodes["jax"] == 0 and nodes["host_cpp"] == per_step["host_cpp"] > 0
    print(f"[{card}] 13(a) compiled steps in turns {'/'.join(HOST_COMPILED_ORDER)} (aldp.yaml, "
          f"batch {batch}; the jax program built in {build_s:.2f} s): host_cpp "
          f"{', '.join(f'{v:.1f}' for v in ms['host_cpp'])} ms, jax "
          f"{', '.join(f'{v:.1f}' for v in ms['jax'])} ms; median {medians['host_cpp']:.1f} / "
          f"{medians['jax']:.1f} ms; device busy {busy['host_cpp']:.1%} / {busy['jax']:.1%} of "
          f"the median; server calls per step {per_step['host_cpp']} / {per_step['jax']}, "
          f"host nodes in the graph {nodes['host_cpp']} / {nodes['jax']}")
    out.update(ms=ms, medians=medians, busy=busy, server_calls_per_step=per_step,
               host_nodes=nodes, jax_build_s=build_s)
    return out


def profile_aldp_path(device, card, tmp) -> dict:
    """13(b): profile_aldp on aldp.yaml at batch 1024 for both backends, its repeats
    cut (printed) and its buffer at one batch."""
    from unittest import mock

    from fab_tpu_torch.experiments import profile_aldp

    print(f"[{card}] profile_aldp cut: --repeats {PROFILE_REPEATS} (the script's default "
          f"20, 10 for the train step), {PROFILE_WARMUP} warm-up calls "
          f"({profile_aldp.WARMUP}) and training.replay_buffer.min_length=0 (aldp.yaml: 64); "
          "a full-length run is "
          "python3 -m fab_tpu_torch.experiments.profile_aldp [system.backend=host_cpp]")
    out = {}
    for backend in ("jax", "host_cpp"):
        t0 = time.time()
        with mock.patch.object(profile_aldp, "WARMUP", PROFILE_WARMUP):
            rows = profile_aldp.main([
            "--config", os.path.join(CONFIGS, "aldp.yaml"), "--device", str(device),
            "--batch", str(ALDP_BATCH),
                "--repeats", str(PROFILE_REPEATS), "training.replay_buffer.min_length=0",
                f"data.transform={os.path.join(tmp, 'aldp_reference.npy')}",
                f"system.backend={backend}"])
        assert len(rows) == 9 and all(math.isfinite(s) and s > 0 for _, s, _ in rows), rows
        out[backend] = {name: s * 1e3 for name, s, _ in rows}
        print(f"[{card}] profile_aldp system.backend={backend}: {time.time() - t0:.1f} s")
    return out


def _finite_csv(path) -> list:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        bad = [k for k, v in r.items() if k != "model_name" and not math.isfinite(float(v))]
        assert not bad, f"{path}: not finite {bad}"
    return rows


def _save_flow_checkpoint(trainer, state, path) -> None:
    """The flow parameters and transition state (no optimizer, no buffer) in the
    checkpoint layout, for the evaluation script."""
    from fab_tpu_torch import checkpoint
    from fab_tpu_torch.convert import to_jax_params

    flow = trainer.model.flow
    checkpoint.save_checkpoint(path, {
        "params": {"flow": to_jax_params(flow.state_dict(), len(flow.bijectors)),
                   "transition": dict(state.transition_state)},
        "step": state.step})


def evaluation_path(device, card, tmp) -> dict:
    """13(c): evaluate.py on phase 9's GMM-40 checkpoint and phase 12's rbd and SNF
    ones, and on the LGCP-1600 checkpoint of phases 6-7 through K2;
    evaluate_expectation.py on the GMM-40 checkpoint; sample_aldp.py and
    reeval_aldp.py on phase 11's run directory. Every CSV and .npz value finite."""
    import numpy as np
    import torch

    from fab_tpu_torch.experiments import (
        evaluate,
        evaluate_expectation,
        reeval_aldp,
        sample_aldp,
    )

    def run_dir(name):
        (stamp,) = os.listdir(os.path.join(tmp, name))
        return os.path.join(tmp, name, stamp)

    out = {}
    _zero_counts()
    t0 = time.time()
    csv_path = os.path.join(tmp, "gmm_eval.csv")
    evaluate.main(["--config", os.path.join(CONFIGS, "gmm.yaml"), "--out", csv_path,
                   "--device", str(device), "--run", f"fab_seed0={run_dir('gmm')}",
                   "--run", f"rsb_seed0={run_dir('GMM-40-rbd')}",
                   "--run", f"snf_seed0={run_dir('GMM-40-snf')}"])
    torch.cuda.synchronize()
    out["gmm_eval_s"] = time.time() - t0
    rows = _finite_csv(csv_path)
    assert [r["model_name"] for r in rows] == ["fab_seed0", "rsb_seed0", "snf_seed0"]
    print(f"[{card}] evaluate.py on gmm.yaml (10000 samples, inner batch 500; phase 9's "
          f"checkpoint, phase 12's resampled-base and SNF ones): {out['gmm_eval_s']:.1f} s; "
          + "; ".join(f"{r['model_name']} eval_ess_ais {float(r['eval_ess_ais']):.4g}, "
                      f"flow_kl_forward {float(r['flow_kl_forward']):.4g}" for r in rows))
    _no_kernel_launched("the GMM evaluation")

    t0 = time.time()
    csv_path = os.path.join(tmp, "gmm_expectation.csv")
    evaluate_expectation.main(["--config", os.path.join(CONFIGS, "gmm.yaml"), "--out",
                               csv_path, "--n-repeats", "20", "--device", str(device),
                               "--run", f"fab_seed0={run_dir('gmm')}"])
    torch.cuda.synchronize()
    out["expectation_s"] = time.time() - t0
    rows = _finite_csv(csv_path)
    assert [r["model_name"] for r in rows] == ["target", "fab_seed0"]
    print(f"[{card}] evaluate_expectation.py on gmm.yaml (1000 samples, --n-repeats 20 of "
          f"the script's 100): {out['expectation_s']:.1f} s; " + "; ".join(
              f"{r['model_name']} bias {float(r['bias']):.4g}" for r in rows))
    _no_kernel_launched("the expectation estimates")

    # LGCP-1600 through K2.
    csv_path = os.path.join(tmp, "lgcp_eval.csv")
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    evaluate.main(["--config", os.path.join(CONFIGS, "lgcp.yaml"), "--out", csv_path,
                   "--device", str(device), "--num-samples", str(2 * LG_BATCH),
                   "--inner-batch", str(LG_BATCH),
                   "--run", f"fab_seed0={os.path.join(tmp, 'lgcp_checkpoint', 'state.pkl')}",
                   "flow.fused_coupling=true"])
    torch.cuda.synchronize()
    out["lgcp_eval_s"] = time.time() - t0
    counts = _counts()
    out["k2_launches"] = counts["k2"]
    assert counts["k2"] > 0 and counts["k1"] == 0, counts
    (row,) = _finite_csv(csv_path)
    print(f"[{card}] evaluate.py on lgcp.yaml with flow.fused_coupling=true (the phase 6-7 "
          f"flow; {2 * LG_BATCH} samples in AIS passes of {LG_BATCH}): "
          f"{out['lgcp_eval_s']:.1f} s, K2 "
          f"launches {counts['k2']}, prepared-weight rebuilds {counts['k2_rebuilds']}; "
          f"eval_ess_flow {float(row['eval_ess_flow']):.4g}, eval_ess_ais "
          f"{float(row['eval_ess_ais']):.4g}")

    aldp = ["--config", os.path.join(CONFIGS, "aldp.yaml"), "--device", str(device),
            "--run", os.path.join(tmp, "aldp")]
    reference = f"data.transform={os.path.join(tmp, 'aldp_reference.npy')}"
    _zero_counts()
    t0 = time.time()
    npz = sample_aldp.main(aldp + ["--n-samples", str(2 * ALDP_BATCH), "--batch",
                                   str(ALDP_BATCH), "--out",
                                   os.path.join(tmp, "aldp_samples.npz"), reference])
    torch.cuda.synchronize()
    out["sample_s"] = time.time() - t0
    with np.load(npz) as data:
        shapes = {k: data[k].shape for k in data}
        bad = [k for k in data if not np.isfinite(data[k]).all()]
    assert sorted(shapes) == ["ais_log_w", "ais_samples", "flow_log_p", "flow_log_q",
                              "flow_samples"] and shapes["flow_samples"] == (2 * ALDP_BATCH, 60), shapes
    assert not bad, f"sample_aldp: not finite {bad}"
    print(f"[{card}] sample_aldp.py on phase 11's run (2 batches of {ALDP_BATCH} flow and "
          f"AIS samples): {out['sample_s']:.1f} s; {shapes}")
    t0 = time.time()
    metrics = reeval_aldp.main(aldp + ["--n-samples", "2000", "--out-dir",
                                       os.path.join(tmp, "aldp_reeval"), reference])
    torch.cuda.synchronize()
    out["reeval_s"] = time.time() - t0
    _finite_csv(os.path.join(tmp, "aldp_reeval", "metrics", "metrics.csv"))
    print(f"[{card}] reeval_aldp.py on phase 11's run (2000 flow samples, L-form test rows): "
          f"{out['reeval_s']:.1f} s; " + _finite_metrics(metrics, "reeval_aldp"))
    _no_kernel_launched("the ALDP sampling and re-evaluation")
    return out


def tools_path(device, gen, card, tmp) -> dict:
    """Phase 13: the host C++ energy server, profile_aldp, the evaluation and
    sampling entry points, and the plots switch."""
    from fab_tpu_torch.utils.plotting import PLOTS_OFF, plots_available

    out = {"host_cpp": host_cpp_path(device, gen, card, tmp)}
    out["profile"] = profile_aldp_path(device, card, tmp)
    out["eval"] = evaluation_path(device, card, tmp)
    pngs = [os.path.join(d, f) for d, _, files in os.walk(tmp) for f in files
            if f.endswith(".png")]
    if plots_available():
        assert pngs, "matplotlib is installed but no plot was written"
    else:
        print(f"[{card}] {PLOTS_OFF}: the runners, reeval_aldp and run_aldp wrote no PNG "
              f"({len(pngs)} found)")
        assert not pngs, pngs
    return out


# ---------------------------------------------------------------- K2 / LGCP-1600


def _lgcp_coupling(device, gen):
    """One perturbed LGCP-1600 coupling (the padded last layer's pad stays zero)."""
    import torch

    from fab_tpu_torch.flows import LargeFusedCoupling

    dim = LG_GRID * LG_GRID
    layer = LargeFusedCoupling(dim, dim * LG_NODES, scale_cap=LG_CAP, device=device)
    layer.reset_parameters(gen)
    _perturb(layer, gen, 0.01)  # W3p/b3p start at zero: ~0.01 N(0, 1)
    with torch.no_grad():
        layer.mlp[-1].w[:, 2 * layer.d_trans:] = 0.0
        layer.mlp[-1].b[2 * layer.d_trans:] = 0.0
    return layer


def check_k2(device, gen):
    import torch

    from fab_tpu_torch.flows import LargeFusedCoupling
    from fab_tpu_torch.ops import coupling_kernel as ck

    dim = LG_GRID * LG_GRID
    layer = _lgcp_coupling(device, gen)
    x = torch.randn(LG_BATCH, dim, generator=gen, device=device)
    zc, zt = (t.contiguous() for t in layer._split(x))
    weights = [t for d in layer.mlp for t in (d.w, d.b)]
    errors = {}
    with torch.no_grad():
        for inverse in (False, True):
            y, ld = ck.fused_coupling_apply(zc, zt, *weights, LG_CAP, inverse)
            y_ref, ld_ref = ck.fused_coupling_apply_reference(zc, zt, *weights, LG_CAP, inverse)
            torch.cuda.synchronize()
            assert torch.isfinite(y_ref).all() and torch.isfinite(ld_ref).all()
            # y: a 3200-deep f32 product in another order; log_det: 800 f32 terms,
            # each from such a product, summed in another order.
            torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(ld, ld_ref, atol=2e-3, rtol=0)
            mode = "inverse" if inverse else "forward"
            errors[mode] = (float((y - y_ref).abs().max()), float((ld - ld_ref).abs().max()))
            print(f"K2 {mode}: max|y - plain| {errors[mode][0]:.3e} (atol=rtol=1e-4), "
                  f"max|log_det - plain| {errors[mode][1]:.3e} (atol 2e-3)")
        # The log-det is summed in a fixed order, with no float atomics.
        y_again, ld_again = ck.fused_coupling_apply(zc, zt, *weights, LG_CAP, True)
        torch.cuda.synchronize()
        assert torch.equal(ld_again, ld) and torch.equal(y_again, y), "K2 is not repeatable"
        print("K2 repeated: y and log_det bitwise equal")
        # An in-place update of the weights: the prepared copies must follow it.
        rebuilds = ck.prepared_weight.rebuilds
        _perturb(layer, gen, 0.001)
        layer.mlp[-1].w[:, 2 * layer.d_trans:] = 0.0
        layer.mlp[-1].b[2 * layer.d_trans:] = 0.0
        y, ld = ck.fused_coupling_apply(zc, zt, *weights, LG_CAP, True)
        y_ref, ld_ref = ck.fused_coupling_apply_reference(zc, zt, *weights, LG_CAP, True)
        torch.cuda.synchronize()
        assert ck.prepared_weight.rebuilds == rebuilds + 3, "the prepared weights were not rebuilt"
        torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld, ld_ref, atol=2e-3, rtol=0)
        errors["after update"] = (float((y - y_ref).abs().max()),
                                  float((ld - ld_ref).abs().max()))
        print(f"K2 after an in-place update of every weight: 3 prepared copies rebuilt, "
              f"max|y - plain| {errors['after update'][0]:.3e}, max|log_det - plain| "
              f"{errors['after update'][1]:.3e}")
        y, ld_f = layer.forward_and_log_det(x)
        x_back, ld_i = layer.inverse_and_log_det(y)
        torch.cuda.synchronize()
        torch.testing.assert_close(x_back, x, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld_i, -ld_f, atol=1e-4, rtol=0)
        print(f"K2 round trip: max|inverse(forward(x)) - x| {float((x_back - x).abs().max()):.3e}")
        before = ck.fused_coupling_apply.launches
        x3 = x.reshape(4, LG_BATCH // 4, dim)
        z3, ld3 = layer.inverse_and_log_det(x3)
        z3_ref, ld3_ref = super(LargeFusedCoupling, layer).inverse_and_log_det(x3)
        torch.cuda.synchronize()
        assert ck.fused_coupling_apply.launches == before + 1
        torch.testing.assert_close(z3, z3_ref, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld3, ld3_ref, atol=2e-3, rtol=0)
        print(f"K2 on a {tuple(x3.shape)} input: one launch, max|z - plain| "
              f"{float((z3 - z3_ref).abs().max()):.3e}")

    cot = torch.randn(LG_BATCH, dim, generator=gen, device=device)
    grads = []
    for inverse_fn in (layer.inverse_and_log_det,
                       super(LargeFusedCoupling, layer).inverse_and_log_det):
        xg = x.clone().requires_grad_(True)
        z, ld = inverse_fn(xg)
        loss = (z * cot).sum() + ld.sum()
        grads.append(torch.autograd.grad(loss, [xg, *layer.parameters()]))
    torch.cuda.synchronize()
    grad_err = max(_max_rel_err(a, b) for a, b in zip(*grads))
    # Both backwards are the plain coupling under autograd, on the same inputs.
    assert grad_err < 1e-4, f"K2 gradients disagree with plain autograd: {grad_err}"
    pad_grad = float(grads[0][-2][:, 2 * layer.d_trans:].abs().max())
    assert pad_grad == 0.0, "the padded columns got a gradient"
    print(f"K2 gradients (input + {len(grads[0]) - 1} parameters) vs plain autograd: "
          f"max relative error {grad_err:.3e}; padded columns' gradient exactly 0")
    return {"x": x, "zc": zc, "zt": zt, "weights": weights, "errors": errors}


def lgcp_path(device, gen, card, save_path):
    import torch

    from fab_tpu_torch.buffer import PrioritisedReplayBuffer
    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo
    from fab_tpu_torch.targets import LogGaussianCoxProcess
    from fab_tpu_torch.train import PrioritisedBufferTrainer, make_optimizer

    dim = LG_GRID * LG_GRID
    t0 = time.time()
    target = LogGaussianCoxProcess(grid_size=LG_GRID, device=device)
    flow = make_realnvp(dim, LG_LAYERS, LG_NODES, scale_cap=LG_CAP, fused_coupling=True,
                        generator=gen, device=device)
    model = FABModel.create(
        flow, target,
        transition_operator=HamiltonianMonteCarlo(
            n_ais_intermediate_distributions=LG_DISTS, n_outer=1,
            n_leapfrog=LG_LEAPFROG, epsilon=LG_EPS, target_p_accept=0.65,
        ),
        n_intermediate_distributions=LG_DISTS, alpha=2.0, loss_type="fab_alpha_div",
    )
    trainer = PrioritisedBufferTrainer(
        model, make_optimizer(LG_LR, 100.0),
        PrioritisedReplayBuffer(dim=dim, max_length=LG_BUFFER, min_sample_length=LG_BUFFER_MIN),
        n_batches_buffer_sampling=LG_REPLAY, w_adjust_max_clip=10.0,
        save_path=save_path, device=device,
    )
    n_params = sum(p.numel() for p in flow.parameters())
    print(f"LGCP-1600 set-up (target, {n_params / 1e6:.1f} M flow parameters): "
          f"{time.time() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    state, _, run = _train(trainer, gen, LG_BATCH, card, "LGCP-1600")
    init, per_step, total = run["init"], run["per_step"], run["total"]
    # Per AIS pass: 1 flow sample + 1 initial gradient pass + 8 distributions x 5
    # leapfrog gradient passes = 42 flow passes, 41 of them differentiated; per
    # replay batch a probe and a differentiated pass. 8 couplings per pass.
    ais_passes = LG_BUFFER_MIN // LG_BATCH
    per_ais = (2 + LG_DISTS * LG_LEAPFROG) * LG_LAYERS
    per_ais_recompute = (1 + LG_DISTS * LG_LEAPFROG) * LG_LAYERS
    want_step = (per_ais + 2 * LG_REPLAY * LG_LAYERS,
                 per_ais_recompute + LG_REPLAY * LG_LAYERS)
    assert want_step == (400, 360)
    # The fill: 8 AIS passes, each a replay of the captured pass (336 launches, 328
    # recomputes, 24 prepared-weight rebuilds); the wrappers counted the warm-up pass
    # and the capture.
    fill, per_layer = run["fill"], 3 * LG_LAYERS
    captured = fill["captured"]
    assert fill["replays"] == ais_passes == 8, fill
    assert (captured["k2"], captured["k2_recomputes"], captured["k2_rebuilds"]) == (
        per_ais, per_ais_recompute, per_layer), fill
    assert (init["k2"], init["k2_recomputes"], init["k2_rebuilds"]) == (
        2 * per_ais, 2 * per_ais_recompute, 2 * per_layer), init
    assert all((p["k2"], p["k2_recomputes"]) == want_step for p in per_step), (
        f"K2 launches/recomputes per step: {per_step}"
    )
    assert total["k1"] == 0, "K1 is not on the LGCP path"
    # Prepared weight copies (w1, w2, w3p of 8 couplings) are rebuilt after each of a
    # step's 4 updates, at the next pass: replay batches 2-4 of the same step and the
    # next step's AIS pass; step 1's AIS pass rebuilds them too (the fill's replays
    # left the cache empty).
    want_rebuilds = [LG_REPLAY * per_layer] * N_STEPS
    assert [p["k2_rebuilds"] for p in per_step] == want_rebuilds, (
        f"prepared-weight rebuilds per step: {[p['k2_rebuilds'] for p in per_step]}"
    )
    run["rebuilds_per_step"] = want_rebuilds[-1]
    print(f"LGCP-1600 path: K2 launches {total['k2']} (init_state {init['k2']}: its fill's "
          f"warm-up and capture; {per_ais} in each of its {fill['replays']} replays; "
          f"{want_step[0]} per step), backward recomputations {total['k2_recomputes']} "
          f"(init_state {init['k2_recomputes']}, {want_step[1]} per step), prepared-weight "
          f"rebuilds {total['k2_rebuilds']} (init_state {init['k2_rebuilds']}, "
          f"{want_rebuilds[-1]} per step); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Output check: finite parameters and buffer, and the trained flow agrees with
    # a plain Flow holding the same parameters (last layer unpadded) on buffer rows.
    assert all(torch.isfinite(p).all() for p in flow.parameters())
    lw = state.buffer_state.log_w
    assert int(torch.isfinite(lw).sum()) > 0 and not torch.isnan(lw).any()
    check = make_realnvp(dim, LG_LAYERS, LG_NODES, scale_cap=LG_CAP, generator=gen,
                         device=device)
    check.load_state_dict({
        k: v[..., : 2 * (dim // 2)] if ".mlp.2." in k else v
        for k, v in flow.state_dict().items()
    })
    rows = state.buffer_state.x[torch.isfinite(lw)][:256]
    with torch.no_grad():
        lq, lq_plain = flow.log_prob(rows), check.log_prob(rows)
    torch.cuda.synchronize()
    rel = _max_rel_err(lq, lq_plain)
    print(f"LGCP-1600 trained flow vs plain Flow on {rows.shape[0]} buffer rows: max "
          f"|log q| {float(lq_plain.abs().max()):.1f}, max relative error {rel:.3e}")
    # 8 layers of 3200-deep f32 products and 1600-term sums, in another order.
    assert rel < 1e-4, f"trained flow disagrees with the plain flow: {rel}"

    torch.cuda.synchronize()
    t0 = time.time()
    model.ais.sample_and_log_weights(state.transition_state, gen, LG_BATCH,
                                     p_target=False, tune=False)
    torch.cuda.synchronize()
    ais_ms = (time.time() - t0) * 1e3
    print(f"[{card}] LGCP-1600 AIS pass alone: {ais_ms:.1f} ms "
          f"({ais_ms / run['steady_ms']:.1%} of the median step)")
    state, busy, groups, _ = _profile_step(
        trainer, state, gen, LG_BATCH, run["steady_ms"], card, "LGCP-1600",
        {"K2": ["k2_"], "triangular solves": ["trsm"],
         "cuBLAS GEMMs": ["gemm", "cutlass", "sm90_xmma"]},
    )
    assert groups["K2"] > 0, "the profiler saw no K2 kernel"
    run["busy"] = busy
    return trainer, state, run


def lgcp_run_entry(trainer, state, gen, card, log_dir):
    """The run entry point: 2 iterations and one dual-target eval, logged to a CSV."""
    from fab_tpu_torch.utils.logging import CSVLogger

    path = os.path.join(log_dir, "lgcp_run.csv")
    trainer.logger = CSVLogger(path)
    t0 = time.time()
    trainer.run(gen, n_iterations=2, batch_size=LG_BATCH, eval_batch_size=LG_BATCH,
                n_eval=1, n_checkpoints=0, state=state)
    run_s = time.time() - t0
    # run's steps were replays of one captured step: its counts are phase 6's per step.
    program = trainer._programs[LG_BATCH]
    assert program.replays == 2 and program.captured_counts == {
        "k1": 0, "k1_recomputes": 0, "k2": 400, "k2_recomputes": 360, "k2_rebuilds": 96,
        "server calls": 0,
    }, (program.replays, program.captured_counts)
    with open(path) as f:
        rows = list(csv.DictReader(f))
    eval_rows = [r for r in rows if r.get("eval_ess_ais_min_var_target")]
    assert len(rows) == 3 and len(eval_rows) == 1, f"unexpected CSV rows: {rows}"
    shown = {}
    for key in ("ais_post_mean_field_rmse_p_target", "eval_ess_ais_min_var_target",
                "eval_ess_ais_p_target", "eval_ess_flow_p_target",
                "flow_post_mean_field_rmse_p_target"):
        shown[key] = float(eval_rows[0][key])
        assert math.isfinite(shown[key]), f"{key} is not finite"
    print(f"[{card}] LGCP-1600 run(n_iterations=2, n_eval=1, eval_batch_size=512): "
          f"{run_s:.1f} s (its step captured as a CUDA graph and replayed twice: K2 400 "
          f"launches, 360 recomputes, 96 rebuilds per step), {len(rows)} CSV rows; eval " +
          ", ".join(f"{k} {v:.4g}" for k, v in shown.items()))


def time_k2(k2, name, card):
    import torch

    from fab_tpu_torch.ops import coupling_kernel as ck

    zc, zt, weights = k2["zc"], k2["zt"], k2["weights"]
    B, dc = zc.shape
    dt = zt.shape[1]
    H = weights[0].shape[1]
    flops = 2.0 * B * (dc * H + H * H + H * 2 * dt)
    bytes_moved = 4.0 * (B * dc + B * dt + dc * H + H + H * H + H + H * 2 * dt
                         + 2 * dt + B * dt + B)
    bounds = _bounds_ms(flops, bytes_moved, name)
    timing = {}
    with torch.no_grad():
        for inverse in (False, True):
            timing[inverse] = (
                _time_ms(lambda: ck.fused_coupling_apply(zc, zt, *weights, LG_CAP, inverse)),
                _time_ms(lambda: ck.fused_coupling_apply_reference(
                    zc, zt, *weights, LG_CAP, inverse)),
            )
            print(f"[{card}] K2 {'inverse' if inverse else 'forward'}: kernel "
                  f"{timing[inverse][0]:.4f} ms, plain {timing[inverse][1]:.4f} ms, "
                  f"{_bounds_text(bounds)} ({flops / 1e9:.3f} GFLOP, "
                  f"{bytes_moved / 1e6:.2f} MB)")
        # One coupling's prepared weight copies, built again (after an update).
        rebuild = _time_ms(lambda: [ck.prepare_weight_on_card(w, n) for w, n in
                                    ((weights[0], H), (weights[2], H), (weights[4], 2 * dt))])
        w1, w2, w3p = weights[0], weights[2], weights[4][:, : 2 * dt]
        h1 = torch.relu(zc @ w1)
        h2 = torch.relu(h1 @ w2)
        library = _time_ms(lambda: (zc @ w1, h1 @ w2, h2 @ w3p))
    print(f"[{card}] K2 library_ms {library:.4f}: 3 x cuBLAS f32 GEMM, no epilogue; no "
          "single call computes K2 (a yardstick only, never called by the port)")
    print(f"[{card}] K2 prepared-weight rebuild of one coupling (w1, w2, w3p): "
          f"{rebuild:.4f} ms")
    return timing, bounds, library, rebuild


# ----------------------------------------------------------- data parallel (14)

# The launcher run of phase 14, cut in length only: many_well.yaml's buffer fill of
# 65,536 rows takes 32 f64 AIS passes (phase 10 runs it whole); 12 passes still leave
# finite rows in every replay batch of 8 x 2048, so every logged value is finite
# (with fewer, the last batch may hold none and its w_adjust_min is inf, as in
# fab_tpu).
DP_LAUNCHER_CUTS = ["training.min_buffer_length=24576", "training.n_flow_forward_pass=null",
                    "training.n_iterations=2", "evaluation.n_eval=1",
                    "evaluation.n_checkpoints=1", "evaluation.n_plots=0"]
# After one warm-up step each (a new path's first kernels load then), the
# data-parallel trainer (A) and the plain one (B) take timed turns, ABBAAB.
DP_ORDER = ("dp", "plain", "plain", "dp", "dp", "plain")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# Commands that hold nothing of this process start as their own processes before
# phase 11 and run beside phases 11-13, whose ALDP steps leave the card mostly idle
# (8-14 % busy, eager): the launcher run (phase 14), bench_scaling (16(b)) and the two
# model-axis ranks (15(a)). Each phase reads its command's result where it used to run
# it. Their times, and those of phases 11-13, were taken beside one another.
_STARTED = []


class _Started:
    """A command started ahead of the phase that reads it, in a session of its own
    (its children are stopped with it); its output in temporary files, the time it
    ended taken by a thread that waits for it."""

    def __init__(self, cmd, env=None):
        self.cmd = cmd
        self.out, self.err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        self.t0, self.t_end = time.time(), None
        self.proc = subprocess.Popen(cmd, stdout=self.out, stderr=self.err, text=True,
                                     cwd=os.path.dirname(os.path.abspath(__file__)),
                                     env=env, start_new_session=True)
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()
        _STARTED.append(self)

    def _wait(self):
        self.proc.wait()
        self.t_end = time.time()

    def stop(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.waiter.join()

    def result(self, timeout):
        """(exit code, stdout, stderr, seconds from its start to its end); a command
        still running ``timeout`` seconds after its start is stopped."""
        self.waiter.join(max(0.0, self.t0 + timeout - time.time()))
        self.stop()
        self.out.seek(0)
        self.err.seek(0)
        return self.proc.returncode, self.out.read(), self.err.read(), self.t_end - self.t0


def _stop_started() -> None:
    for started in _STARTED:
        started.stop()


def expected_collectives(n_dists: int, n_outer: int, n_replay: int) -> dict:
    """Collectives of one PrioritisedBufferTrainer step under a data mesh, reckoned
    from the code: the AIS pass (ESS of the flow draw: a max and a sum; per
    distribution the acceptance rate per outer step and the move distance; the
    valid and bound-masked counts; ESS and log Z, a max and a sum each), the buffer
    draw (one all-gather), per replay batch the loss's valid-row count, the
    gradient bucket and the priority update (an all-gather), and the logged means
    (w_adjust mean, min, max, log q mean, sampled log w mean, and its std: two)."""
    terms = {
        "AIS": 2 + n_dists * (n_outer + 1) + 1 + 2 + 2,
        "buffer draw": 1,
        "replay batches": 3 * n_replay,
        "logged means": 7,
    }
    terms["total"] = sum(terms.values())
    return terms


def _manywell_trainer(device, seed: int, fused: bool = True, dtype=None, min_batches: int = 4):
    from fab_tpu_torch.buffer import PrioritisedReplayBuffer
    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo
    from fab_tpu_torch.targets import ManyWellEnergy
    from fab_tpu_torch.train import PrioritisedBufferTrainer, make_optimizer

    import torch

    flow = make_realnvp(MW_DIM, MW_LAYERS, MW_NODES, fused=fused,
                        generator=torch.Generator(device=device).manual_seed(seed),
                        device=device)
    model = FABModel.create(
        flow, ManyWellEnergy(MW_DIM, device=device),
        transition_operator=HamiltonianMonteCarlo(n_ais_intermediate_distributions=4,
                                                  n_outer=1, n_leapfrog=5, epsilon=1.0),
        n_intermediate_distributions=4, loss_type="fab_alpha_div",
    )
    buffer = PrioritisedReplayBuffer(dim=MW_DIM, max_length=MW_BATCH * 16,
                                     min_sample_length=MW_BATCH * min_batches,
                                     batch_size=MW_BATCH)
    return PrioritisedBufferTrainer(model, make_optimizer(3e-4, 100.0), buffer,
                                    n_batches_buffer_sampling=8, w_adjust_max_clip=10.0,
                                    device=device, dtype=dtype or torch.float32)


def _clone_state(state):
    import torch

    def clone(tree):
        if torch.is_tensor(tree):
            return tree.clone()
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(clone(v) for v in tree))
        if isinstance(tree, list):
            return [clone(v) for v in tree]
        return tree

    return clone(state)


def _state_diff(trainer_a, state_a, trainer_b, state_b) -> dict:
    """``_summary_diff`` of two trainers' states."""
    return _summary_diff(_flow_summary(trainer_a, state_a), _flow_summary(trainer_b, state_b))


def _flow_summary(trainer, state) -> dict:
    """The flow (split parameters gathered), the transition state (step sizes) and,
    with a buffer, its priorities and cursor, on the host."""
    from fab_tpu_torch.parallel.tensor import gather_state

    flow = trainer.model.flow
    out = {"flow": {k: v.cpu() for k, v in gather_state(flow, flow.state_dict()).items()},
           "transition": {k: v.cpu() for k, v in state.transition_state.items()}}
    if hasattr(state, "buffer_state"):
        out["log_w"] = state.buffer_state.log_w.cpu()
        out["cursor"] = (int(state.buffer_state.cursor), int(state.buffer_state.n_added))
    return out


def _summary_diff(a: dict, b: dict) -> dict:
    """Largest relative differences of two ``_flow_summary``s' flows, step sizes and
    buffer priorities (finite patterns and cursors must match), and whether all are
    bitwise equal."""
    import torch

    rel = lambda x, y: float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
    same = (all(torch.equal(a["flow"][k], v) for k, v in b["flow"].items())
            and all(torch.equal(a["transition"][k], v) for k, v in b["transition"].items()))
    out = {"params": max(rel(a["flow"][k], v) for k, v in b["flow"].items())}
    if b["transition"]:  # a loss without AIS has no step sizes
        out["step_sizes"] = max(rel(a["transition"][k], v) for k, v in b["transition"].items())
    if "log_w" in b:
        finite = torch.isfinite(b["log_w"])
        assert torch.equal(finite, torch.isfinite(a["log_w"])), "buffer finite patterns differ"
        assert a["cursor"] == b["cursor"], (a["cursor"], b["cursor"])
        same = same and torch.equal(torch.where(finite, a["log_w"], 0),
                                    torch.where(finite, b["log_w"], 0))
        out["priorities"] = rel(a["log_w"][finite], b["log_w"][finite])
    return dict(out, bitwise=same)


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def data_parallel_path(device, card, tmp, launcher) -> dict:
    """Phase 14: ManyWell-32 through the data-parallel trainer under NCCL at world
    size 1 against the plain trainer, a DCP round trip, and the launcher path (the
    run ``launcher``, started before phase 11)."""
    import torch

    from fab_tpu_torch.parallel import distributed, mesh

    t_phase = time.time()
    assert distributed.initialize(device, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                  world_size=1, rank=0)
    import torch.distributed as dist

    assert dist.get_backend() == ("nccl" if device.type == "cuda" else "gloo")
    dp_mesh = mesh.make_mesh()
    out = {}
    try:
        dp, plain = _manywell_trainer(device, 1), _manywell_trainer(device, 1)
        init_gen = torch.Generator(device=device).manual_seed(3)
        _zero_counts()
        t0 = time.time()
        state = plain.init_state(init_gen, batch_size=MW_BATCH)
        torch.cuda.synchronize()
        print(f"[{card}] phase 14: ManyWell-32 init_state {time.time() - t0:.2f} s")
        dp.model.flow.load_state_dict(plain.model.flow.state_dict())
        states = {"dp": _clone_state(state), "plain": state}
        trainers = {"dp": dp, "plain": plain}
        gens = {k: torch.Generator(device=device).manual_seed(4) for k in trainers}
        meshes = {"dp": dp_mesh, "plain": None}
        warm = {}
        for kind in trainers:
            torch.cuda.synchronize()
            t0 = time.time()
            with mesh.use_mesh(meshes[kind]):
                states[kind], _ = trainers[kind].train_step(states[kind], gens[kind], MW_BATCH)
            torch.cuda.synchronize()
            warm[kind] = (time.time() - t0) * 1e3
        print(f"[{card}] phase 14 warm-up step: data-parallel {warm['dp']:.1f} ms, plain "
              f"{warm['plain']:.1f} ms")
        ms = {"dp": [], "plain": []}
        per_step = {"dp": [], "plain": []}
        collectives = []
        _zero_counts()
        for kind in DP_ORDER:
            mesh.COUNTS.clear()
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.time()
            with mesh.use_mesh(meshes[kind]):
                states[kind], info = trainers[kind].train_step(states[kind], gens[kind],
                                                               MW_BATCH)
            torch.cuda.synchronize()
            ms[kind].append((time.time() - t0) * 1e3)
            per_step[kind].append({k: v - before[k] for k, v in _counts().items()})
            if kind == "dp":
                collectives.append(sum(mesh.COUNTS.values()))
            assert math.isfinite(float(info["loss"])) and int(info["n_valid"]) > 0
        counts = _counts()
        expect = expected_collectives(4, 1, 8)
        print(f"[{card}] phase 14 steps in turns {'/'.join(DP_ORDER)}: data-parallel "
              f"(NCCL, world size 1) {', '.join(f'{t:.1f}' for t in ms['dp'])} ms, plain "
              f"{', '.join(f'{t:.1f}' for t in ms['plain'])} ms; median "
              f"{statistics.median(ms['dp']):.1f} / {statistics.median(ms['plain']):.1f} ms")
        for kind in trainers:
            assert all((p["k1"], p["k1_recomputes"]) == (38, 29) for p in per_step[kind]), (
                kind, per_step[kind])
        assert counts["k1"] == len(DP_ORDER) * 38 and counts["k2"] == 0, counts
        print(f"[{card}] K1 per step: data-parallel {[p['k1'] for p in per_step['dp']]} "
              f"launches + {[p['k1_recomputes'] for p in per_step['dp']]} recomputes, plain "
              f"{[p['k1'] for p in per_step['plain']]} + "
              f"{[p['k1_recomputes'] for p in per_step['plain']]} (equal)")
        assert collectives == [expect["total"]] * 3, (collectives, expect)
        print(f"[{card}] collectives per data-parallel step: {collectives} counted, "
              f"{expect['total']} reckoned from the code (" + ", ".join(
                  f"{k} {v}" for k, v in expect.items() if k != "total") + ")")
        diff = _state_diff(dp, states["dp"], plain, states["plain"])
        # Every state-changing reduction keeps the plain arithmetic at world size 1;
        # f32 relative 1e-5 is the stated tolerance.
        assert max(diff["params"], diff["step_sizes"], diff["priorities"]) <= 1e-5, diff
        print(f"[{card}] after 4 steps each: max relative difference, parameters "
              f"{diff['params']:.3e}, step sizes {diff['step_sizes']:.3e}, buffer priorities "
              f"{diff['priorities']:.3e} (tolerance 1e-5); bitwise equal: {diff['bitwise']}")

        # No host sync added: one data-parallel step with CUDA's sync check on error.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with mesh.use_mesh(dp_mesh):
                states["dp"], _ = dp.train_step(states["dp"], gens["dp"], MW_BATCH)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"[{card}] one data-parallel step under torch.cuda.set_sync_debug_mode('error'):"
              " no host sync")
        steady = statistics.median(ms["dp"])
        with mesh.use_mesh(dp_mesh):
            states["dp"], busy, groups, n_ops = _profile_step(
                dp, states["dp"], gens["dp"], MW_BATCH, steady, card,
                "ManyWell-32 data-parallel", {"NCCL": ["nccl"], "K1": ["k1_tf32x3"]})
        print(f"[{card}] NCCL kernels' device time per data-parallel step: "
              f"{groups['NCCL']:.3f} ms; K1 {groups['K1']:.2f} ms; {n_ops} device ops")
        out.update(dp_ms=ms["dp"], plain_ms=ms["plain"], busy=busy, nccl_ms=groups["NCCL"],
                   k1_launches=sum(p["k1"] for p in per_step["dp"]),
                   collectives=expect["total"], diff=diff)

        # DCP round trip of the trainer state on the card, and the resumed step.
        ckpt = os.path.join(tmp, "dcp_manywell")
        with mesh.use_mesh(dp_mesh):
            saved = _clone_state(states["dp"])
            saved_flow = {k: v.clone() for k, v in dp.model.flow.state_dict().items()}
            torch.cuda.synchronize()
            t0 = time.time()
            dp.save_checkpoint_dcp(states["dp"], ckpt)
            torch.cuda.synchronize()
            save_ms = (time.time() - t0) * 1e3
            uninterrupted, _ = dp.train_step(states["dp"], torch.Generator(
                device=device).manual_seed(8), MW_BATCH)
            after_flow = {k: v.clone() for k, v in dp.model.flow.state_dict().items()}
            t0 = time.time()
            loaded, step = dp.load_state_dcp(ckpt)
            torch.cuda.synchronize()
            load_ms = (time.time() - t0) * 1e3
            assert step == saved.step
            assert all(torch.equal(v, saved_flow[k])
                       for k, v in dp.model.flow.state_dict().items())
            for a, b in ((loaded.buffer_state, saved.buffer_state),
                         (loaded.opt_state.mu, saved.opt_state.mu),
                         (loaded.opt_state.nu, saved.opt_state.nu)):
                assert all(torch.equal(x, y) for x, y in zip(a, b))
            assert all(torch.equal(loaded.transition_state[k], saved.transition_state[k])
                       for k in saved.transition_state)
            resumed, _ = dp.train_step(loaded, torch.Generator(device=device).manual_seed(8),
                                       MW_BATCH)
            assert all(torch.equal(v, after_flow[k])
                       for k, v in dp.model.flow.state_dict().items())
            assert torch.equal(resumed.buffer_state.log_w, uninterrupted.buffer_state.log_w)
        n_bytes = _dir_bytes(ckpt)
        print(f"[{card}] DCP round trip (world size 1): save {save_ms:.1f} ms, load "
              f"{load_ms:.1f} ms, {n_bytes} bytes; loaded state exact, the resumed step "
              "equals the uninterrupted one bitwise")
        out.update(dcp_save_ms=save_ms, dcp_load_ms=load_ms, dcp_bytes=n_bytes)

        # The collectives' own cost: a scalar-pair all-reduce (the size most
        # reductions send) and an all-gather of the buffer draw's payload (16,384 x
        # 36 f64), host clock over many calls ended by one synchronize.
        pair = torch.ones(2, device=device)
        payload = torch.ones(8 * MW_BATCH, MW_DIM + 4, dtype=torch.float64, device=device)
        cost = {}
        for label, fn, n in (("all_reduce", lambda: mesh.all_reduce(pair), 500),
                             ("all_gather", lambda: mesh.all_gather_rows(payload), 100)):
            fn()
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            cost[label] = (time.time() - t0) / n * 1e3
        per_step = cost["all_reduce"] * 38 + cost["all_gather"] * 9
        print(f"[{card}] one collective (NCCL, world size 1): all_reduce of 2 values "
              f"{cost['all_reduce'] * 1e3:.1f} us, all_gather of {tuple(payload.shape)} f64 "
              f"{cost['all_gather'] * 1e3:.1f} us; 38 + 9 per step = {per_step:.2f} ms")
        out.update(collective_ms=cost, collectives_ms_per_step=per_step,
                   trainer=(dp, states["dp"]))
    finally:
        distributed.shutdown()
    out["launcher_s"] = _launcher_run(device, card, tmp, launcher)
    out["phase_s"] = time.time() - t_phase
    return out


def _launcher_overrides(tmp) -> list:
    return ["mesh.n_data=1", *DP_LAUNCHER_CUTS,
            f"evaluation.save_path={os.path.join(tmp, 'many_well_launcher')}"]


def launcher_start(device, tmp) -> _Started:
    """Phase 14's launcher run, started ahead of the phase."""
    root = os.path.dirname(os.path.abspath(__file__))
    return _Started([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node=1", "-m", "fab_tpu_torch.experiments.run_many_well",
                     "--config", os.path.join(CONFIGS, "many_well.yaml"), "--device",
                     device.type, *_launcher_overrides(tmp)],
                    env=dict(os.environ, PYTHONPATH=root))


def _launcher_run(device, card, tmp, started) -> float:
    """run_many_well under python3 -m torch.distributed.run with one process:
    mesh.n_data=1, 2 iterations, one eval and one checkpoint; exit 0, every CSV
    value finite, and rank 0's checkpoint loaded in this process."""
    import torch

    from fab_tpu_torch.experiments.setup_run import setup_trainer
    from fab_tpu_torch.targets import ManyWellEnergy
    from fab_tpu_torch.utils.training import apply_overrides, load_config

    config = os.path.join(CONFIGS, "many_well.yaml")
    save = os.path.join(tmp, "many_well_launcher")
    overrides = _launcher_overrides(tmp)
    print(f"[{card}] launcher path: {' '.join(started.cmd[1:])} (cuts of many_well.yaml: "
          f"min_buffer_length 65536 -> 24576; started before phase 11)")
    rc, stdout, stderr, took = started.result(300)
    print(stdout[-3000:])
    assert rc == 0, stderr[-6000:]
    assert "data mesh over 1 processes" in stdout, stdout[-2000:]
    (run_dir,) = [os.path.join(save, d) for d in os.listdir(save)]
    with open(os.path.join(run_dir, "logging_hist.csv")) as f:
        rows = list(csv.DictReader(f))
    values = [float(v) for r in rows for v in r.values() if v != ""]
    assert rows and all(math.isfinite(v) for v in values), "a CSV value is not finite"
    cfg = apply_overrides(load_config(config), overrides)
    trainer = setup_trainer(cfg, ManyWellEnergy(cfg.target.dim, device=device), device=device)
    state, step = trainer.load_state(os.path.join(run_dir, "model_checkpoints", "iter_2",
                                                  "state.pkl"))
    batch = cfg.training.batch_size
    filled = -(-cfg.training.min_buffer_length // batch) * batch
    assert step == 2 and int(state.buffer_state.n_added) == filled + 2 * batch
    assert all(torch.isfinite(p).all() for p in trainer.model.flow.parameters())
    print(f"[{card}] launcher run: exit 0 in {took:.1f} s (beside phase 11), {len(rows)} CSV "
          f"rows, {len(values)} values all finite; rank 0's checkpoint (step {step}) loaded here")
    return took


# ------------------------------------------------------------------ phase 15
# The model axis on one card: a (1, 2) grid of two processes over gloo (NCCL refuses
# two ranks on one device; gloo carries the CUDA tensors through the host). Each
# rank runs ManyWell-32 (phase 3's widths) on the plain flow, Megatron-split, and on
# the fused flow, whose K1 takes the gathered weights, then one LGCP-1600 step
# through K2 on gathered weights. The LGCP buffer starts at one batch (lgcp.yaml's
# 4096 rows cut to 512: the fill is not what this phase measures).
MA_STEPS = 1
MA_STEPS_BEFORE = 2
MA_LG_BUFFER_MIN = LG_BATCH
# Both flows run in many_well.yaml's float64 (K1 still computes in f32 inside and
# casts back). In f32 the grid ends off one process after 3 steps on the card: the
# Megatron-split plain flow by 1.56e-3 (relative) on the parameters, the fused flow
# by 3.3e-4 (bitwise equal with the clip off: the clip's norm sums the shards'
# squares in another order). The first updates after the zero-initialised last
# layers leave gradients that cancel to within rounding, and Adam's early steps move
# a parameter by about +-lr whatever its gradient's size, so one rounding flips a
# sign and moves a parameter by 2 lr. In f64 the rounding is too small for that.
MA_DTYPE = "float64"


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def expected_model_collectives(fused: bool, n_layers: int, n_dists: int, n_leapfrog: int,
                               n_replay: int) -> dict:
    """Model-axis collectives of one ManyWell PrioritisedBufferTrainer step on a
    (1, 2) grid, reckoned from the code. Flow passes per step: the AIS pass's flow
    sample, its initial gradient and one per leapfrog step (2 + n_dists n_leapfrog),
    and per replay batch a probe and a differentiated pass; n_replay updates, each
    with a global norm for the guard and one for the clip (an all-reduce each,
    summing the split tensors' squares). The fused flow gathers w1, b1 and w2 once per
    pass (3 all-gathers) and its backward gathers nothing; the plain flow reduces
    each coupling's row-split product forward (n_layers per pass) and, backward,
    each coupling's input gradient in every differentiated pass: the AIS gradient
    passes (1 + n_dists n_leapfrog) and the replay passes (n_replay; in the density
    direction an LU layer's parameters come before every coupling, so even the first
    coupling's input needs a gradient)."""
    passes = 2 + n_dists * n_leapfrog + 2 * n_replay
    norms = 2 * n_replay
    if fused:
        return {"all_gather": 3 * passes, "all_reduce": norms}
    backward = (1 + n_dists * n_leapfrog + n_replay) * n_layers
    return {"all_gather": 0, "all_reduce": passes * n_layers + backward + norms}


def _model_axis_run(device, fused: bool) -> dict:
    """ManyWell-32 on the active mesh (or one process without one): init_state and
    MA_STEPS steps from fixed seeds, in MA_DTYPE; K1 counts, collectives by axis
    and the logged grad norm per step."""
    import torch

    from fab_tpu_torch.parallel import mesh

    # The buffer starts at one batch (4 in phase 14): the grid's fill is eager, through
    # gloo.
    trainer = _manywell_trainer(device, 1, fused=fused, dtype=getattr(torch, MA_DTYPE),
                                min_batches=1)
    _zero_counts()
    mesh.COUNTS.clear()
    t0 = time.time()
    state = trainer.init_state(torch.Generator(device=device).manual_seed(3),
                               batch_size=MW_BATCH)
    _sync(device)
    out = {"init_s": time.time() - t0, "init_counts": _counts(),
           "init_collectives": sorted(mesh.COUNTS.items()), "ms": [], "per_step": [],
           "collectives": [], "grad_norm": []}
    gen = torch.Generator(device=device).manual_seed(4)
    for _ in range(MA_STEPS):
        before, collectives = _counts(), mesh.COUNTS.copy()
        t0 = time.time()
        state, info = trainer.train_step(state, gen, MW_BATCH)
        _sync(device)
        out["ms"].append((time.time() - t0) * 1e3)
        out["per_step"].append({k: v - before[k] for k, v in _counts().items()})
        out["collectives"].append({"/".join(k): v - collectives[k]
                                   for k, v in mesh.COUNTS.items() if v - collectives[k]})
        assert math.isfinite(float(info["loss"])) and int(info["n_valid"]) > 0
        out["grad_norm"].append(float(info["grad_norm"]))
    out["summary"] = _flow_summary(trainer, state)
    return out


def _model_axis_lgcp(device) -> dict:
    """One LGCP-1600 step (K2 on gathered weights) after init_state from a buffer of
    one batch: K2 launches, recomputes and prepared-weight rebuilds per step."""
    import torch

    from fab_tpu_torch.buffer import PrioritisedReplayBuffer
    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo
    from fab_tpu_torch.targets import LogGaussianCoxProcess
    from fab_tpu_torch.train import PrioritisedBufferTrainer, make_optimizer

    dim = LG_GRID * LG_GRID
    gen = torch.Generator(device=device).manual_seed(5)
    flow = make_realnvp(dim, LG_LAYERS, LG_NODES, scale_cap=LG_CAP, fused_coupling=True,
                        generator=gen, device=device)
    model = FABModel.create(
        flow, LogGaussianCoxProcess(grid_size=LG_GRID, device=device),
        transition_operator=HamiltonianMonteCarlo(
            n_ais_intermediate_distributions=LG_DISTS, n_outer=1, n_leapfrog=LG_LEAPFROG,
            epsilon=LG_EPS, target_p_accept=0.65),
        n_intermediate_distributions=LG_DISTS, alpha=2.0, loss_type="fab_alpha_div")
    trainer = PrioritisedBufferTrainer(
        model, make_optimizer(LG_LR, 100.0),
        PrioritisedReplayBuffer(dim=dim, max_length=LG_BUFFER, min_sample_length=MA_LG_BUFFER_MIN,
                                batch_size=LG_BATCH),
        n_batches_buffer_sampling=LG_REPLAY, w_adjust_max_clip=10.0, device=device)
    state = trainer.init_state(gen, batch_size=LG_BATCH)
    _zero_counts()
    t0 = time.time()
    state, info = trainer.train_step(state, gen, LG_BATCH)
    _sync(device)
    assert math.isfinite(float(info["loss"])) and int(info["n_valid"]) > 0
    return {"step_ms": (time.time() - t0) * 1e3, "counts": _counts(),
            "n_valid": int(info["n_valid"])}


def model_axis_worker(argv) -> int:
    """One rank of phase 15(a): ``--model-axis-rank <rank> <port> <out> <json>`` (the
    json: device and the parent's shapes)."""
    import torch

    from fab_tpu_torch.parallel import distributed, mesh

    rank, port, out, cfg = int(argv[0]), int(argv[1]), argv[2], json.loads(argv[3])
    globals().update(cfg["shapes"])
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets it
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(cfg["device"])
    assert distributed.initialize(device, init_method=f"tcp://127.0.0.1:{port}",
                                  world_size=2, rank=rank, backend="gloo")
    try:
        grid = mesh.make_mesh(1, 2)
        mesh.activate_mesh(grid)
        result = {"plain": _model_axis_run(device, False),
                  "fused": _model_axis_run(device, True),
                  "lgcp": _model_axis_lgcp(device)}
    finally:
        distributed.shutdown()
    torch.save(result, out)
    return 0


def model_axis_start(device, tmp) -> list:
    """Phase 15(a)'s two ranks, started ahead of the phase."""
    port = _free_port()
    shapes = {k: globals()[k] for k in ("MW_DIM", "MW_LAYERS", "MW_NODES", "MW_BATCH",
                                         "LG_GRID", "LG_LAYERS", "LG_NODES", "LG_BATCH",
                                         "MA_LG_BUFFER_MIN")}
    cfg = json.dumps({"device": str(device), "shapes": shapes})
    root = os.path.dirname(os.path.abspath(__file__))
    return [_Started([sys.executable, os.path.abspath(__file__), "--model-axis-rank", str(rank),
                      str(port), os.path.join(tmp, f"model_axis_rank{rank}.pt"), cfg],
                     env=dict(os.environ, PYTHONPATH=root)) for rank in range(2)]


def model_axis_path(device, card, tmp, started) -> dict:
    """Phase 15(a): two ranks of a (1, 2) grid over gloo on the card (``started``
    before phase 11) against one process from the same seeds; K1 and K2 on
    gathered weights."""
    import torch

    t_phase = time.time()
    print(f"[{card}] phase 15(a) cut: ManyWell-32 steps on the grid and alone "
          f"{MA_STEPS_BEFORE} -> {MA_STEPS}")
    reference = {kind: _model_axis_run(device, kind == "fused") for kind in ("plain", "fused")}
    for rank, run in enumerate(started):
        rc, stdout, stderr, seconds = run.result(600)
        assert rc == 0, f"model-axis rank {rank} failed:\n{(stdout + stderr)[-6000:]}"
        print(f"[{card}] phase 15(a) rank {rank}: exit 0 {seconds:.1f} s after its start "
              "before phase 11")
    ranks = [torch.load(os.path.join(tmp, f"model_axis_rank{r}.pt"), weights_only=False)
             for r in range(2)]
    out = {"phase_s": None}
    for kind in ("plain", "fused"):
        mine, ref = ranks[0][kind], reference[kind]
        assert _summary_diff(ranks[1][kind]["summary"], mine["summary"])["bitwise"]
        diff = _summary_diff(mine["summary"], ref["summary"])
        expect = expected_model_collectives(kind == "fused", MW_LAYERS, 4, 5, 8)
        data = expected_collectives(4, 1, 8)["total"]
        k1 = [(p["k1"], p["k1_recomputes"]) for p in mine["per_step"]]
        dtype = MA_DTYPE.replace("float", "f")
        print(f"[{card}] phase 15(a) ManyWell-32 {kind} flow ({dtype}) on a (1, 2) grid (gloo, "
              f"2 ranks on one card) vs one process: init_state {mine['init_s']:.1f} / "
              f"{ref['init_s']:.1f} s, steps {', '.join(f'{t:.1f}' for t in mine['ms'])} / "
              f"{', '.join(f'{t:.1f}' for t in ref['ms'])} ms; after {MA_STEPS} steps max "
              f"relative difference, parameters {diff['params']:.3e}, step sizes "
              f"{diff['step_sizes']:.3e}, buffer priorities {diff['priorities']:.3e} "
              f"(tolerance 1e-5; bitwise {diff['bitwise']}); K1 per step per rank {k1}; logged "
              f"grad_norm {mine['grad_norm']} / {ref['grad_norm']}")
        print(f"[{card}] phase 15(a) {kind}: collectives per step "
              f"{mine['collectives'][0]} counted; reckoned from the code: model {expect}, "
              f"data {data} (expected_model_collectives, expected_collectives)")
        assert max(diff["params"], diff["step_sizes"], diff["priorities"]) <= 1e-5, (kind, diff)
        assert all(abs(a - b) <= 1e-5 * max(abs(b), 1e-30)
                   for a, b in zip(mine["grad_norm"], ref["grad_norm"])), "grad_norm differs"
        for step in mine["collectives"]:
            by_axis = {k.split("/")[1]: v for k, v in step.items() if k.startswith("model/")}
            assert by_axis == {k: v for k, v in expect.items() if v}, (kind, step, expect)
            assert sum(v for k, v in step.items() if k.startswith("data/")) == data, step
        # The plain path's 38 + 29 (on the CPU the plain version of K1 runs, uncounted).
        want = {"plain": (0, 0), "fused": (38 if device.type == "cuda" else 0, 29)}[kind]
        assert all(c == want for c in k1), (kind, k1)
        assert [(p["k1"], p["k1_recomputes"]) for p in ref["per_step"]] == k1
        out[kind] = {"init_s": mine["init_s"], "ms": mine["ms"], "ref_ms": ref["ms"],
                     "diff": diff, "k1_per_step": k1, "collectives": mine["collectives"][0]}
    lgcp = ranks[0]["lgcp"]
    assert ranks[1]["lgcp"]["counts"] == lgcp["counts"]
    counts = lgcp["counts"]
    if device.type == "cuda":
        assert (counts["k2"], counts["k2_recomputes"]) == (400, 360), counts
        assert counts["k2_rebuilds"] <= 96, counts
    print(f"[{card}] phase 15(a) LGCP-1600 step on the (1, 2) grid, K2 on gathered weights: "
          f"{lgcp['step_ms']:.1f} ms, n_valid {lgcp['n_valid']}, K2 {counts['k2']} launches + "
          f"{counts['k2_recomputes']} recomputes, {counts['k2_rebuilds']} prepared-weight "
          "rebuilds per rank (phase 6: 400 + 360, 96 per step)")
    out["lgcp"] = {"step_ms": lgcp["step_ms"], "counts": counts}
    out["phase_s"] = time.time() - t_phase
    return out


def _smoke_module(dim, device):
    """An external flow module, written here and not from the port's flows: a
    trainable diagonal Gaussian under two affine couplings whose conditioners are
    ``nn.Sequential`` MLPs (1-64-2, last layer zero), with
    ``sample_and_log_prob(generator, n)`` and ``log_prob(x)``."""
    import torch
    from torch import nn

    from fab_tpu_torch import random

    class CouplingPair(nn.Module):
        def __init__(self):
            super().__init__()
            self.loc = nn.Parameter(torch.zeros(dim, device=device))
            self.log_scale = nn.Parameter(torch.zeros(dim, device=device))
            self.nets = nn.ModuleList(
                nn.Sequential(nn.Linear(dim // 2, 64), nn.ReLU(), nn.Linear(64, 2 * (dim // 2)))
                for _ in range(2)).to(device)
            for net in self.nets:
                nn.init.zeros_(net[-1].weight)
                nn.init.zeros_(net[-1].bias)

        def _couple(self, x, i, inverse):
            h = dim // 2
            cond, trans = (x[:, :h], x[:, h:]) if i == 0 else (x[:, h:], x[:, :h])
            shift, log_s = self.nets[i](cond).chunk(2, -1)
            log_s = torch.tanh(log_s)
            trans = (trans - shift) * torch.exp(-log_s) if inverse else trans * torch.exp(log_s) + shift
            y = torch.cat([cond, trans] if i == 0 else [trans, cond], -1)
            return y, (-1 if inverse else 1) * log_s.sum(-1)

        def _base_log_prob(self, eps):
            return (-0.5 * eps ** 2 - 0.5 * math.log(2 * math.pi)).sum(-1) - self.log_scale.sum()

        def sample_and_log_prob(self, generator, n):
            eps = random.normal(generator, (n, dim), self.loc.dtype, self.loc.device)
            x, log_q = self.loc + torch.exp(self.log_scale) * eps, self._base_log_prob(eps)
            for i in range(2):
                x, log_det = self._couple(x, i, False)
                log_q = log_q - log_det
            return x, log_q

        def log_prob(self, x):
            log_det = 0.0
            for i in (1, 0):
                x, ld = self._couple(x, i, True)
                log_det = log_det + ld
            return self._base_log_prob((x - self.loc) * torch.exp(-self.log_scale)) + log_det

    return CouplingPair()


def wrappers_path(device, card) -> dict:
    """Phase 15(b): FABModel over a WrappedModuleFlow (``_smoke_module``) and a
    WrappedTorchDist target (a MixtureSameFamily of GMM-40's 40 components in 2-D,
    gmm.yaml's loc and variance scaling, on the card, f64): 5 Trainer steps with
    Metropolis AIS as gmm.yaml, finite losses and every tensor on the card; one more
    under CUDA's sync check on "error"."""
    import torch

    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import Metropolis
    from fab_tpu_torch.targets import GMM
    from fab_tpu_torch.train import Trainer, make_optimizer
    from fab_tpu_torch.wrappers import WrappedModuleFlow, WrappedTorchDist

    t0 = time.time()
    gmm = GMM(dim=2, n_mixes=40, loc_scaling=40.0, log_var_scaling=1.0,
              true_expectation_estimation_n_samples=1000, dtype=torch.float64, device=device)
    dists = torch.distributions
    mixture = dists.MixtureSameFamily(
        dists.Categorical(logits=torch.zeros(40, dtype=torch.float64, device=device),
                          validate_args=False),
        dists.Independent(dists.Normal(gmm.locs, gmm.scales, validate_args=False), 1,
                          validate_args=False), validate_args=False)
    target = WrappedTorchDist.wrap(mixture)
    flow = WrappedModuleFlow(_smoke_module(2, device), 2)
    model = FABModel.create(
        flow, target, transition_operator=Metropolis(
            n_ais_intermediate_distributions=1, n_updates=1, max_step_size=5.0,
            min_step_size=5.0, adjust_step_size=False, target_p_accept=0.65),
        n_intermediate_distributions=1, alpha=2.0, loss_type="fab_alpha_div")
    trainer = Trainer(model, make_optimizer(1e-4, 100.0), dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(6)
    _zero_counts()
    state = trainer.init_state(gen)
    losses = []
    for _ in range(N_STEPS):
        state, info = trainer.train_step(state, gen, 128)
        losses.append(float(info["loss"]))
    assert all(math.isfinite(v) for v in losses), losses
    tensors = list(flow.parameters()) + list(state.transition_state.values()) + [
        v for v in info.values() if torch.is_tensor(v)]
    assert all(t.device.type == device.type for t in tensors), "a tensor left the card"
    sample = target.sample(256, gen)
    assert sample.device.type == device.type and sample.shape == (256, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, info = trainer.train_step(state, gen, 128)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert math.isfinite(float(info["loss"]))
    assert all(v == 0 for v in _counts().values()), _counts()
    took = time.time() - t0
    print(f"[{card}] phase 15(b) wrappers: WrappedModuleFlow (an external nn.Module) over a "
          f"WrappedTorchDist target (MixtureSameFamily, GMM-40 shape, f64, on the card): "
          f"{N_STEPS} Trainer steps, losses {', '.join(f'{v:.4f}' for v in losses)}; every "
          f"tensor on the card; one more step under the sync check, no host sync; {took:.1f} s")
    return {"losses": losses, "s": took}


# ------------------------------------------------------------------ phase 16

# Phase 16's own cuts (length only; printed). The bench runs at its defaults.
PHASE16_BUDGET_S = 240
SCALING_CUTS = ["--batch-per-device", "2048", "--steps", "2", "--warmup", "1"]
BENCH_CUTS = ["--steps", "3"]
# 16(d)'s limits, set from readings on an H100 (PERF.md §6): the in-graph f32 L
# against the f64 factor cast to f32, max |dL| 1.103e-6; the evaluation's flow-side
# columns 0 to 7.9e-8 relative apart; the control's (the f64 factor rounded to half
# precision) 1.023e-4 to 2.245e-4. The control must land above IN_GRAPH_RTOL, so the column
# check can fail.
IN_GRAPH_L_GAP = 1e-5
IN_GRAPH_RTOL = 1e-5
ANCHOR_CUTS = ["--quick", "--n-samples", "256", "--n-steps", "10", "--n-chains", "32",
               "--n-sweeps", "16"]


def _module_run(module, args, label, timeout):
    """``python3 -m <module> <args>`` from this checkout; (stdout, stderr, seconds).
    Fails on a non-zero exit, printing the end of both streams."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.time() - t0
    if proc.returncode != 0:
        print(proc.stdout[-6000:])
        print(proc.stderr[-6000:], file=sys.stderr)
        raise AssertionError(f"{label} exited {proc.returncode}")
    return proc.stdout, proc.stderr, seconds


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _finite_json(tree, label, path=""):
    """Every number in a JSON tree is finite (null marks a column documented as
    unavailable)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _finite_json(v, label, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _finite_json(v, label, f"{path}[{i}]")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        assert math.isfinite(tree), f"{label}: not finite at {path}"


def scaling_start() -> _Started:
    """16(b)'s bench_scaling, started ahead of the phase."""
    return _Started([sys.executable, "-m", "fab_tpu_torch.bench_scaling", "--mesh-sizes", "1",
                     *SCALING_CUTS])


def bench_path(card, scaling_run) -> dict:
    """16(a) the port's bench at bench.py's settings, its timed steps cut (BENCH_CUTS);
    16(b) bench_scaling at one rank under NCCL, cut in length only (the run
    ``scaling_run``, started before phase 11)."""
    print(f"[{card}] phase 16(a) bench cut (length only): {' '.join(BENCH_CUTS)} (default 10)")
    out, err, seconds = _module_run("fab_tpu_torch.bench", BENCH_CUTS, "fab_tpu_torch.bench",
                                    900)
    (line,) = [d for d in _json_lines(out) if "metric" in d]
    assert sorted(line) == sorted(["metric", "value", "unit", "vs_baseline", "mfu",
                                   "achieved_flops_per_s"]), line
    assert math.isfinite(line["value"]) and line["value"] > 0, line
    assert math.isfinite(line["vs_baseline"]) and line["vs_baseline"] > 0, line
    assert line["mfu"] is not None and 0 < line["mfu"] <= 1, line
    k1 = re.search(r"K1 per fused step: launches \[(\d+)\], recomputes \[(\d+)\]", err)
    assert k1 and (int(k1.group(1)), int(k1.group(2))) == (38, 29), err[-2000:]
    k1 = re.search(r"K1 in the fused step's graph: launches (\d+), recomputes (\d+)", err)
    assert k1 and (int(k1.group(1)), int(k1.group(2))) == (38, 29), err[-2000:]
    eager = re.search(r"median eager step: fused ([\d.]+) ms, plain ([\d.]+) ms", err)
    medians = re.search(r"median step: fused ([\d.]+) ms, plain ([\d.]+) ms", err)
    print(f"[{card}] phase 16(a) python3 -m fab_tpu_torch.bench ({seconds:.1f} s): "
          + json.dumps(line))
    print(f"[{card}] phase 16(a) bench median compiled step: fused {medians.group(1)} ms, "
          f"plain {medians.group(2)} ms; eager fused {eager.group(1)} ms, plain "
          f"{eager.group(2)} ms (5 each, in turns); K1 38 launches + 29 recomputes per "
          "fused step; " + [ln for ln in err.splitlines() if ln.startswith("FLOPs")][0])
    for ln in err.splitlines():
        if ln.startswith(("median", "card:", "compiled", "eager", "fused compiled",
                          "plain compiled")):
            print(f"    bench stderr: {ln}")
    result = {"bench": line, "bench_s": seconds, "fused_ms": float(medians.group(1)),
              "plain_ms": float(medians.group(2)), "eager_fused_ms": float(eager.group(1)),
              "eager_plain_ms": float(eager.group(2))}

    print(f"[{card}] phase 16(b) bench_scaling cut (length only): "
          f"{' '.join(SCALING_CUTS)} (defaults: 2048, 10, 2); started before phase 11")
    rc, out, err, seconds = scaling_run.result(600)
    if rc != 0:
        print(out[-6000:])
        print(err[-6000:], file=sys.stderr)
        raise AssertionError(f"fab_tpu_torch.bench_scaling exited {rc}")
    (scaling,) = [d for d in _json_lines(out) if "n_devices" in d]
    assert scaling["n_devices"] == 1 and scaling["efficiency_vs_1"] == 1.0, scaling
    assert math.isfinite(scaling["samples_per_s"]) and scaling["samples_per_s"] > 0
    print(f"[{card}] phase 16(b) bench_scaling --mesh-sizes 1 under NCCL ({seconds:.1f} s, "
          "beside phase 11): "
          + json.dumps(scaling))
    result.update(scaling=scaling, scaling_s=seconds)
    return result


def lgcp_kernel_bench_path(card) -> dict:
    """16(c) bench_lgcp_kernel at its defaults: K2 against the plain layer, the
    whole LGCP-1600 flow fused and plain in turns."""
    from fab_tpu_torch.experiments import bench_lgcp_kernel

    t0 = time.time()
    result = bench_lgcp_kernel.main([])
    layer, flow = result["layer"], result["flow"]
    assert max(layer[m]["max_abs_err"] for m in ("fwd", "inv")) < 1e-3, layer
    assert flow["fused"]["k2_launches_per_pass"] == LG_LAYERS, flow
    print(f"[{card}] phase 16(c) bench_lgcp_kernel (B {LG_BATCH}, D {LG_GRID ** 2}, "
          f"{LG_LAYERS} layers; {time.time() - t0:.1f} s): layer forward K2 "
          f"{layer['fwd']['kernel_ms']:.4f} ms / plain {layer['fwd']['plain_ms']:.4f} ms, "
          f"inverse {layer['inv']['kernel_ms']:.4f} / {layer['inv']['plain_ms']:.4f} ms; "
          f"flow sample_and_log_prob fused {flow['fused']['sample_and_log_prob']:.2f} / "
          f"plain {flow['plain']['sample_and_log_prob']:.2f} ms, log_prob "
          f"{flow['fused']['log_prob']:.2f} / {flow['plain']['log_prob']:.2f} ms")
    return result


def in_graph_eval_path(device, card, tmp) -> dict:
    """16(d) evaluate.py on the LGCP-1600 flow of phases 6-7 through K2, with the
    target's f64 factor (as 13(c)) and with target.in_graph_kernel=true, same seed
    and samples. The in-graph L is an f32 factorisation of the f32-coordinate
    kernel; the f64 factor is cast to f32: they differ by f32 rounding (0 < max |dL|
    < IN_GRAPH_L_GAP), which moves log p by the printed amount. The flow-side
    columns are functions of log p and L on the same flow samples, so they agree to
    IN_GRAPH_RTOL (relative); the AIS columns' HMC accept decisions may flip on such
    a change of log p, so their differences are printed. The target each evaluation
    builds is checked: the in-graph one holds no f64 constant and factored L itself.
    A third evaluation, the control, runs the f64 factor rounded to half precision;
    its flow-side columns must differ by more than IN_GRAPH_RTOL."""
    import torch

    from fab_tpu_torch.experiments import evaluate
    from fab_tpu_torch.targets import LogGaussianCoxProcess

    plain = LogGaussianCoxProcess(grid_size=LG_GRID, device=device)
    in_graph = LogGaussianCoxProcess(grid_size=LG_GRID, in_graph_kernel=True, device=device)
    e = torch.randn(LG_BATCH, LG_GRID ** 2, generator=torch.Generator(device=device)
                    .manual_seed(5), device=device)
    with torch.no_grad():
        l_gap = float((in_graph._chol(torch.float32, device).T - plain._chol_t).abs().max())
        lp_a, lp_b = plain.log_prob(e), in_graph.log_prob(e)
        lp_gap = float(((lp_a - lp_b).abs() / lp_a.abs().clamp(min=1.0)).max())
    print(f"[{card}] phase 16(d) in-graph L (f32, on the card) against the f64 factor in "
          f"f32: max |dL| {l_gap:.3e}; log p on {LG_BATCH} prior draws, max relative "
          f"difference {lp_gap:.3e}")
    assert 0 < l_gap < IN_GRAPH_L_GAP, l_gap

    build_target = evaluate.build_target
    built = {}

    def recording_build_target(cfg, dtype=torch.float32, device="cuda"):
        target = build_target(cfg, dtype, device)
        if run == "control":
            target._chol_t = target._chol_t.half().to(target._chol_t.dtype)
        built[run] = target
        return target

    rows, launches = {}, {}
    evaluate.build_target = recording_build_target
    try:
        for run in ("false", "true", "control"):
            flag = "true" if run == "true" else "false"
            csv_path = os.path.join(tmp, f"lgcp_eval_in_graph_{run}.csv")
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            evaluate.main(["--config", os.path.join(CONFIGS, "lgcp.yaml"), "--out", csv_path,
                           "--device", str(device), "--num-samples", str(2 * LG_BATCH),
                           "--inner-batch", str(LG_BATCH), "--run",
                           f"fab_seed0={os.path.join(tmp, 'lgcp_checkpoint', 'state.pkl')}",
                           "flow.fused_coupling=true", f"target.in_graph_kernel={flag}"])
            torch.cuda.synchronize()
            launches[run] = _counts()["k2"]
            assert launches[run] > 0, f"{run}: K2 not launched"
            (rows[run],) = _finite_csv(csv_path)
            target = built[run]
            assert target.in_graph_kernel == (run == "true"), run
            if run == "true":
                assert target._chol_t is None, "the in-graph target kept an f64 factor"
                assert [k[0] for k in target._chol_cache] == [torch.float32], \
                    "the in-graph target did not factor L in f32"
            else:
                assert not target._chol_cache, f"{run}: the f64-factor target factored L"
            print(f"[{card}] phase 16(d) evaluate.py lgcp.yaml "
                  + ("control: the f64 factor rounded to half precision"
                     if run == "control" else f"target.in_graph_kernel={run}")
                  + f": {time.time() - t0:.1f} s, K2 launches {launches[run]}")
    finally:
        evaluate.build_target = build_target

    def relative(other):
        return {k: abs(float(rows["false"][k]) - float(rows[other][k]))
                / max(abs(float(rows["false"][k])), 1e-12)
                for k in rows["false"] if k != "model_name"}

    def flow_side(d):
        return {k: v for k, v in d.items() if k.startswith(("flow_", "eval_ess_flow"))}

    diffs, control = relative("true"), relative("control")
    for label, d in (("in-graph", diffs), ("the half-precision control", control)):
        print(f"[{card}] phase 16(d) relative difference per column (f64 factor against "
              f"{label}): " + ", ".join(f"{k} {v:.3e}" for k, v in d.items()))
    assert max(flow_side(diffs).values()) <= IN_GRAPH_RTOL, flow_side(diffs)
    assert max(flow_side(control).values()) > IN_GRAPH_RTOL, flow_side(control)
    return {"launches": {k: launches[k] for k in ("false", "true")}, "l_gap": l_gap,
            "log_p_gap": lp_gap, "diffs": diffs, "control": control}


def scripts_path(device, card, tmp) -> dict:
    """16(e) the scripts that need no matplotlib, cut in length only (printed), on
    phase 11's ALDP run and reference frame: every CSV, JSON and .npz value finite."""
    import numpy as np
    import torch

    from fab_tpu_torch.demo import aldp_demo, gmm_demo, many_well_demo
    from fab_tpu_torch.experiments import (
        aldp_external_anchor,
        aldp_phi_overlay,
        aldp_torsion_scan,
        alpha_study,
        ground_truth_marginals,
        rejection_sampling_vis,
    )

    dev = ["--device", str(device)]
    ref = os.path.join(tmp, "aldp_reference.npy")
    run = os.path.join(tmp, "aldp")
    aldp_config = os.path.join(CONFIGS, "aldp.yaml")
    runs = [
        ("ground_truth_marginals", ground_truth_marginals.main,
         ["--dim", "32", "--n-samples", "200000"], "none (the defaults)"),
        ("rejection_sampling_vis", rejection_sampling_vis.main,
         ["--out", os.path.join(tmp, "rejection_sampling.png")], "none (the defaults)"),
        ("alpha_study", alpha_study.main,
         ["--config", os.path.join(CONFIGS, "gmm_fast.yaml"), "--alphas", "1.0", "2.0",
          "--seeds", "0", "--num-samples", "1000", "--out", os.path.join(tmp, "alpha.csv"),
          "training.n_iterations=5"],
         "2 alphas x 1 seed (6 x 3), 5 iterations (200), 1000 eval samples (10000)"),
        ("aldp_torsion_scan", aldp_torsion_scan.main,
         ["--n-grid", "72", "--out", os.path.join(tmp, "scan.csv"), "--test-set",
          os.path.join(run, "test_set.npy"), "--run-config", aldp_config,
          f"data.transform={ref}"], "none (the full 72 x 72 grid)"),
        ("aldp_phi_overlay", aldp_phi_overlay.main,
         ["--run", run, "--config", aldp_config, "--n-samples", "4000", "--scan",
          os.path.join(tmp, "scan.csv"), "--out-prefix", os.path.join(tmp, "overlay"),
          f"data.transform={ref}"], "4000 flow samples (50000)"),
        ("aldp_external_anchor", aldp_external_anchor.main,
         [*ANCHOR_CUTS, "--test-set", os.path.join(run, "test_set.npy"), "--data-path", ref,
          "--out", os.path.join(tmp, "anchor.json")],
         "--quick, then 256 samples of 10 sweeps per fresh set (2000 of 200), 32 chains x "
         "16 sweeps for R-hat (64 x 60)"),
        ("many_well_demo", many_well_demo.main, ["--iters", "3"], "3 iterations (500)"),
        ("gmm_demo", gmm_demo.main, ["--iters", "3", "--out", os.path.join(tmp, "gmm_demo.png")],
         "3 iterations (2000)"),
        ("aldp_demo --train", aldp_demo.main,
         ["--train", "--iters", "2", "--n-samples", "1000", "--config", aldp_config, "--out",
          os.path.join(tmp, "aldp_demo.png"), f"data.transform={ref}"],
         "2 iterations (300), 1000 samples (5000), phase 11's reference frame"),
    ]
    seconds, results = {}, {}
    _zero_counts()
    for name, main, args, cuts in runs:
        print(f"[{card}] phase 16(e) {name} cut (length only): {cuts}")
        t0 = time.time()
        results[name] = main(args + dev)
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
    _no_kernel_launched("the phase-16 scripts")

    gt = results["ground_truth_marginals"]
    assert gt["pair_dev"] < 0.01 and gt["triple_dev"] < 0.01
    assert results["rejection_sampling_vis"]["min_log_gap"] > 0
    alpha_rows = _finite_csv(os.path.join(tmp, "alpha.csv"))
    assert [float(r["alpha"]) for r in alpha_rows] == [1.0, 2.0]
    scan = np.loadtxt(os.path.join(tmp, "scan.csv"), delimiter=",", skiprows=1)
    assert scan.shape == (72 * 72, 3) and np.isfinite(scan).all()
    for path in ("overlay.json", "anchor.json"):
        with open(os.path.join(tmp, path)) as f:
            _finite_json(json.load(f), path)
    assert len(results["many_well_demo"]["fab_alpha_div"]) >= 1
    assert np.isfinite(results["aldp_demo --train"]["mean_log_q"])
    scan_out = results["aldp_torsion_scan"]
    anchor = results["aldp_external_anchor"]
    overlay = results["aldp_phi_overlay"]
    print(f"[{card}] phase 16(e) ground truth: per-well P(x > 0) "
          f"{np.round(gt['marginals'][:4], 4).tolist()}..., pair / triple deviation "
          f"{gt['pair_dev']:.4f} / {gt['triple_dev']:.4f}; alpha study ess_flow "
          + ", ".join(f"{float(r['alpha'])}: {float(r['eval_ess_flow']):.4g}" for r in alpha_rows))
    print(f"[{card}] phase 16(e) torsion scan: lowest minima "
          + "; ".join(f"E {e:.2f} at ({math.degrees(a):.0f}, {math.degrees(b):.0f}) deg"
                      for e, a, b in scan_out["minima"][:3])
          + f"; F(-150) - F(-80) {scan_out['F_c5_minus_c7']:.2f} kcal/mol; test set "
          f"{scan_out['test_set']}")
    print(f"[{card}] phase 16(e) phi overlay: peaks {overlay['peaks']}; anchor: R-hat "
          f"{anchor['rhat_alphaR_indicator']:.4f}, test-set basins "
          f"{anchor['test_set_basins']}")
    print(f"[{card}] phase 16(e) seconds per script: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"seconds": seconds}


def phase16_path(device, card, tmp, scaling_run) -> dict:
    """Phase 16: the port's bench, bench_scaling and bench_lgcp_kernel, LGCP's
    in-graph factor through evaluate.py, and the analysis, ALDP-physics and demo
    scripts. Without matplotlib no PNG is written."""
    from fab_tpu_torch.utils.plotting import PLOTS_OFF, plots_available

    t0 = time.time()
    out = {"bench": bench_path(card, scaling_run)}
    out["lgcp_kernel"] = lgcp_kernel_bench_path(card)
    out["in_graph"] = in_graph_eval_path(device, card, tmp)
    out["scripts"] = scripts_path(device, card, tmp)
    pngs = [os.path.join(d, f) for d, _, files in os.walk(tmp) for f in files
            if f.endswith(".png")]
    if not plots_available():
        assert not pngs, pngs
        print(f"[{card}] phase 16: {PLOTS_OFF}; no PNG written")
    out["phase_s"] = time.time() - t0
    print(f"[{card}] phase 16: {out['phase_s']:.1f} s (budget {PHASE16_BUDGET_S} s)")
    return out


PHASE17_BUDGET_S = 150
# The study modules, each with its script's cell count, and the one cell of each
# training study that the phase runs (the script arguments that select it).
STUDIES = [
    ("run_gmm_method_study", [], 9, ["--only", "flow_reverse_kl_s0"]),
    ("run_gmm_method_study_r3", ["target_kld 0", "rsb 1", "snf 2"], 3, ["target_kld 0"]),
    ("run_gmm_ess_ablation", [], 5, ["control"]),
    ("run_init_parity_ab", [], 4, ["fabbuf_torch"]),
    ("run_mw_method_study", [], 12, ["--only", "fab_no_buffer_s0"]),
    ("run_matmul_cells", [], 4, ["--only", "high_s1", "training.min_buffer_length=8192"]),
]
STUDY_CUTS = ["training.n_iterations=2", "training.n_flow_forward_pass=null",
              "evaluation.n_eval=1", "evaluation.n_checkpoints=1"]
GMM_STUDY_EVAL_N = 5000  # eval_gmm_study's 50,000 samples, cut
TRAJECTORY_EVAL_N = 2 * LG_BATCH  # eval_lgcp_trajectory's 2048 samples, cut
# Columns that may be infinite after two steps of a fresh flow, in fab_tpu too: the
# min / max of the replay weights over a batch with no valid row (train.py:727-728),
# and the Z errors of the min-variance AIS target p^2 / q, whose log-weights
# overflow in f32 for a flow this far from p.
MAY_BE_INFINITE = ("w_adjust_min", "w_adjust_max", "_MSE_Z_estimate_min_var_target",
                   "_MSE_log_Z_estimate_min_var_target")


def _quiet(fn, argv):
    """fn(argv) with its standard output captured: (result, the output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.getvalue()


def _study_run_rows(run_root) -> list:
    """The one run directory under ``run_root``: its checkpoint is there, the CSV's
    values are finite (MAY_BE_INFINITE aside); (the rows, the last eval row)."""
    (run_dir,) = [os.path.join(run_root, d) for d in os.listdir(run_root)]
    assert os.path.exists(os.path.join(run_dir, "model_checkpoints", "iter_2", "state.pkl")), \
        f"{run_dir}: no checkpoint"
    with open(os.path.join(run_dir, "logging_hist.csv")) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        bad = [k for k, v in r.items() if v != "" and not k.endswith(MAY_BE_INFINITE)
               and not math.isfinite(float(v))]
        assert not bad, f"{run_dir}: not finite {bad}"
    evals = [r for r in rows if r.get("eval_ess_flow_p_target") or r.get("eval_ess_flow")]
    assert evals, f"{run_dir}: no eval row"
    return rows, evals[-1]


def study_path(device, card, tmp) -> dict:
    """17(a) every study's dry run (its script's cell count); 17(b) one cell of each
    training study on the card, cut in length only (STUDY_CUTS); 17(c)
    eval_gmm_study on the GMM runs and its LaTeX table."""
    import importlib

    root = os.path.join(tmp, "studies")
    dev = ["--device", str(device), "--results-root", root]
    studies = {m: importlib.import_module(f"fab_tpu_torch.experiments.{m}")
               for m, *_ in STUDIES}
    for module, args, count, _ in STUDIES:
        cells, out = _quiet(studies[module].main, [*dev, "--dry-run", *args])
        assert len(cells) == count == len(out.splitlines()), (module, len(cells), out)
    print(f"[{card}] phase 17(a) dry runs: "
          + ", ".join(f"{m} {c}" for m, _, c, _ in STUDIES) + " cells")
    print(f"[{card}] phase 17(b) one cell per training study, cut (length only): "
          f"{' '.join(STUDY_CUTS)} (scripts: their budgets, evals and checkpoints); the "
          "matmul cell's buffer fill also training.min_buffer_length=8192 (65536); the "
          f"{len(STUDIES)} cells run at once, each its own process on the card")
    seconds = {}

    def one(study):
        module, _, _, select = study
        t0 = time.time()
        results = studies[module].main([*dev, *select, *STUDY_CUTS])
        seconds[module] = time.time() - t0
        return results

    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()), \
            concurrent.futures.ThreadPoolExecutor(len(STUDIES)) as pool:
        all_results = list(pool.map(one, STUDIES))
    seconds["all"] = time.time() - t0
    for (module, *_), results in zip(STUDIES, all_results):
        ((cell, rc),) = results
        if rc != 0:
            with open(os.path.join(root, "logs", f"{cell.log}.log")) as f:
                print(f.read()[-6000:])
            raise AssertionError(f"{module} {cell.name} exited {rc}")
        rows, last = _study_run_rows(os.path.join(root, cell.save_path))
        ess = last.get("eval_ess_flow_p_target") or last["eval_ess_flow"]
        print(f"[{card}] phase 17(b) {module} {cell.name}: rc 0, {seconds[module]:.1f} s, "
              f"{len(rows)} CSV rows, eval ESS of the flow {float(ess):.4g}")
    print(f"[{card}] phase 17(b) the {len(STUDIES)} cells at once: {seconds['all']:.1f} s")

    from fab_tpu_torch.experiments import eval_gmm_study

    t0 = time.time()
    found, out = _quiet(eval_gmm_study.main, [*dev, str(GMM_STUDY_EVAL_N)])
    seconds["eval_gmm_study"] = time.time() - t0
    assert [n for n, _ in found] == ["flow_reverse_kl_seed0", "target_kld_seed0"], found
    _finite_csv(os.path.join(root, "reports", "gmm_study_results.csv"))
    with open(os.path.join(root, "reports", "gmm_study_table.tex")) as f:
        table = f.read()
    assert "flow\\_reverse\\_kl" in table and "target\\_kld" in table, table
    print(f"[{card}] phase 17(c) eval_gmm_study {GMM_STUDY_EVAL_N} samples (50000), "
          f"{seconds['eval_gmm_study']:.1f} s: {len(found)} runs, latex_table wrote "
          f"{len(table.splitlines())} lines")
    return {"seconds": seconds}


def trajectory_path(device, card, tmp) -> dict:
    """17(d) eval_lgcp_trajectory on the LGCP-1600 flow checkpoints of phases 6-7
    (iter_<n> after phase 6's steps, iter_<n + 2> after phase 7's run) through K2:
    its counts zeroed just before and read just after, every column finite."""
    import torch

    from fab_tpu_torch.experiments import eval_lgcp_trajectory

    run_dir = os.path.join(tmp, "lgcp_run")
    root = os.path.join(tmp, "studies")
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    found, out = _quiet(eval_lgcp_trajectory.main, [
        "--device", str(device), "--results-root", root, run_dir, str(TRAJECTORY_EVAL_N),
        "flow.fused_coupling=true"])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = _counts()["k2"]
    assert launches > 0, "eval_lgcp_trajectory: K2 not launched"
    rows = _finite_csv(os.path.join(root, "reports", "lgcp_trajectory.csv"))
    assert [r["model_name"] for r in rows] == [n for n, _ in found] and len(found) == 2, found
    print(f"[{card}] phase 17(d) eval_lgcp_trajectory {TRAJECTORY_EVAL_N} samples (2048) "
          f"with flow.fused_coupling=true on {', '.join(n for n, _ in found)}: "
          f"{seconds:.1f} s, K2 launches {launches}; "
          + "; ".join(f"{r['model_name']} flow_post_mean_field_rmse "
                      f"{float(r['flow_post_mean_field_rmse']):.4g}, eval_ess_ais "
                      f"{float(r['eval_ess_ais']):.4g}" for r in rows))
    return {"launches": launches, "seconds": seconds}


def options_path(device, card) -> dict:
    """17(e) fab_tpu's options that the port gained, once on card tensors (f64),
    each against the same call on the CPU: within 1e-12, masks equal."""
    import numpy as np
    import torch

    from fab_tpu_torch.flows.base import Flow, UniformGaussianBase
    from fab_tpu_torch.flows.defensive import DefensiveMixture
    from fab_tpu_torch.flows.splines import PeriodicShift
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo, Metropolis
    from fab_tpu_torch.train import guarded_update, make_optimizer
    from fab_tpu_torch.utils.aldp_eval import make_chirality_filter
    from fab_tpu_torch.utils.numerical import effective_sample_size

    rng = np.random.default_rng(17)
    w = rng.random(4096)
    x = rng.uniform(-3.0, 3.0, (4096, 60))
    mask = rng.random(4096) > 0.1

    def run(dev):
        t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
        out = {"ess_normalised": effective_sample_size(t(w / w.sum()), normalised=True),
               "chirality": make_chirality_filter(raw=True, threshold=0.5, mean_diff=1.0)(
                   t(x), torch.tensor(mask, device=dev))}
        base = UniformGaussianBase(60, (0, 5, 7), circular_bound=2.0, dtype=torch.float64,
                                   device=dev)
        out["uniform_base"] = base.log_prob(t(x))
        shift = PeriodicShift(60, (0, 5, 7), 1.3, bound=2.0, device=dev)
        out["periodic_shift"] = shift.forward_and_log_det(t(x))[0]
        flow = Flow(60, [shift]).to(device=dev, dtype=torch.float64)
        assert flow.base_dist is flow.base and flow.event_shape == (60,)
        assert DefensiveMixture(flow).event_shape == (60,)
        out["flow_default_base"] = flow.log_prob(t(x))
        p = t(x[:4, :8])
        opt = make_optimizer(1e-2, 1.0)
        guarded_update(opt, [t(x[4:8, :8])], opt.init([p]), flow_params=[p],
                       loss=t(1.0))
        out["guarded_update"] = p
        for op in (HamiltonianMonteCarlo(2, n_outer=3), Metropolis(2, n_updates=2)):
            info = op.init_info(device=dev)
            assert info["p_accept"].device.type == torch.device(dev).type
        return {k: v.detach().cpu() for k, v in out.items()}

    card_out, cpu_out = run(device), run("cpu")
    gaps = {}
    for k in card_out:
        a, b = card_out[k], cpu_out[k]
        if a.dtype == torch.bool:
            assert torch.equal(a, b), k
            gaps[k] = 0.0
        else:
            assert torch.equal(torch.isinf(a), torch.isinf(b)), k
            fin = torch.isfinite(b)
            gaps[k] = float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0
            assert gaps[k] <= 1e-12, (k, gaps[k])
    print(f"[{card}] phase 17(e) the options fab_tpu has and the port gained, on the card "
          "against the CPU (f64): " + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items()))
    return gaps


def phase17_path(device, card, tmp) -> dict:
    """Phase 17: the experiments/*.sh studies and the options the port gained."""
    t0 = time.time()
    out = {"studies": study_path(device, card, tmp)}
    out["trajectory"] = trajectory_path(device, card, tmp)
    out["options"] = options_path(device, card)
    out["phase_s"] = time.time() - t0
    print(f"[{card}] phase 17: {out['phase_s']:.1f} s (budget {PHASE17_BUDGET_S} s)")
    return out


# ------------------------------------------------------------------ phase 18
# The compiled step (Trainer.make_train_step: one step captured as a CUDA graph) on
# the trainers phases 3, 7 and 9 leave: ManyWell-32 (K1), LGCP-1600 (K2; its step
# was captured by phase 7's run) and GMM-40 (f64; captured by phase 9's runner).
# Each takes turns with an eager twin (a copy of its model) from one state and seed.
GRAPH_TURNS = {"ManyWell-32": 3, "LGCP-1600": 3, "GMM-40": 5}
GRAPH_SCANNED = 4
PHASE18_BUDGET_S = 120


def _twin(trainer):
    """A trainer like ``trainer`` on a copy of its model, with no compiled step."""
    import copy

    twin = copy.copy(trainer)
    twin.model, twin._programs = copy.deepcopy(trainer.model), {}
    return twin


def _device_events(fn):
    """fn() under torch.profiler: (wall ms, {kernel name: (ms, count)} of the device
    work fn launched, the same of the kernels its CUDA graph launches held, the
    device records that belong to no launch in the profiled window). A device record
    is fn's when its correlation id is that of a CUDA API call made in the window;
    records of earlier graph replays can reach a later window."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    # One pass over the records (a replay of aldp_snf's graph leaves 1.5M of them):
    # the device's by (correlation id, name), the host's CUDA calls by id.
    cuda = torch.autograd.DeviceType.CUDA
    on_card = collections.defaultdict(lambda: [0, 0])
    launched, graph_launches, call_names = set(), set(), set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            record = on_card[(e.correlation_id(), e.name())]
            record[0] += e.duration_ns()
            record[1] += 1
            continue
        name = e.name()
        if name.startswith(("cuda", "cu")):
            call_names.add(name)
            launched.add(e.correlation_id())
            if "GraphLaunch" in name:
                graph_launches.add(e.correlation_id())
    assert graph_launches, sorted(call_names)
    by_name, in_graph, foreign = {}, {}, 0
    for (correlation, name), (ns, n) in on_card.items():
        if correlation not in launched:
            foreign += n
            continue
        for table in (by_name, in_graph) if correlation in graph_launches else (by_name,):
            ms, count = table.get(name, (0.0, 0))
            table[name] = (ms + ns / 1e6, count + n)
    return wall, by_name, in_graph, foreign


# K1's and K2's kernels, as their sources name them.
GRAPH_KERNELS = ("k1_tf32x3_chain", "k2_split_rows", "k2_tf32x3_dense", "k2_tf32x3_coupling",
                 "k2_row_sum", "k2_prepare_weight", "nccl")


def _graph_kernels(cuda_graph) -> dict:
    """The kernel nodes of a captured graph (kept: ``keep_graph=True``) by name, read
    through libcuda (cuGraphGetNodes, cuGraphKernelNodeGetParams_v2,
    cuFuncGetName): {name: nodes} for GRAPH_KERNELS, "kernel nodes" for all, and
    "host nodes" and "memcpy nodes" (the C++ energy server's calls)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(cuda_graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    node_type, get_params = cu.cuGraphNodeGetType, cu.cuGraphKernelNodeGetParams_v2
    node_type.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    get_params.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    kind = ctypes.c_int()
    params = (ctypes.c_byte * 512)()  # CUDA_KERNEL_NODE_PARAMS_v2; func comes first
    func = ctypes.c_void_p.from_buffer(params)
    # Kernel nodes by function (aldp_snf's graph holds 1.48M nodes of ~300 functions).
    by_func, by_type = collections.Counter(), collections.Counter()
    for node in nodes:
        assert node_type(node, ctypes.byref(kind)) == 0
        by_type[kind.value] += 1
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        assert get_params(node, params) == 0
        by_func[func.value] += 1
    names = collections.Counter()
    for f, count in by_func.items():
        name = ctypes.c_char_p()
        assert cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(f)) == 0
        names[name.value.decode()] += count
    out = {word: sum(c for name, c in names.items() if word in name) for word in GRAPH_KERNELS}
    out["kernel nodes"] = sum(names.values())
    out["memcpy nodes"], out["host nodes"] = by_type[1], by_type[3]  # CU_GRAPH_NODE_TYPE_*
    return out


def _kernel_count(by_name, word) -> int:
    """Launches of the kernels whose names hold ``word`` (the trace demangles them:
    ``void k1_tf32x3_chain(...)``)."""
    return sum(n for name, (_, n) in by_name.items() if word in name)


def graph_turns(label, trainer, state, batch, tol, card, eval_check=False, phase=18,
                turns=None, warm=True, scanned=True, bitwise=False) -> dict:
    """Phase 18 (or 13, 19) on one path: the compiled step of ``trainer`` against its
    eager twin from ``state`` and one seed, ``turns`` each in turns (after a warm-up
    step each, unless ``warm`` is False); agreement after the turns (``bitwise``:
    asserted bit for bit); the kernels', the mesh's and the energy server's counts
    per captured step against the twin's; a profiled replay (device busy, K1's and
    K2's kernels per step; host nodes, one per server call); optionally perform_eval
    after both; make_scanned_train_step against single replays (``scanned``)."""
    import torch
    from torch.utils import _pytree as pytree

    from fab_tpu_torch import graph
    from fab_tpu_torch.native import AldpEnergyServer
    from fab_tpu_torch.parallel import mesh
    from fab_tpu_torch.utils.logging import ListLogger

    device = trainer.device
    turns = turns or GRAPH_TURNS[label]
    t_path = time.time()
    captured_before = batch in trainer._programs
    eager = _twin(trainer)
    states = {"graph": state, "eager": _clone_state(state)}
    gens = {k: torch.Generator(device=device).manual_seed(18) for k in states}
    step = trainer.make_train_step(batch)
    program = trainer._program(batch)
    take = {"graph": lambda s: step(s, gens["graph"]),
            "eager": lambda s: eager.train_step(s, gens["eager"], batch)}

    def timed(kind):
        torch.cuda.synchronize()
        t0 = time.time()
        states[kind], info = take[kind](states[kind])
        torch.cuda.synchronize()
        loss = float(info["loss"])
        assert math.isfinite(loss), f"{label} {kind}: non-finite loss"
        if "n_valid" in info:
            assert int(info["n_valid"]) > 0, f"{label} {kind}: no valid AIS row"
        return (time.time() - t0) * 1e3

    _zero_counts()
    if warm:
        warm_ms = {kind: timed(kind) for kind in ("graph", "eager")}
        warm_text = (f"warm-up step graphed {warm_ms['graph']:.1f} ms, eager "
                     f"{warm_ms['eager']:.1f} ms")
    else:
        warm_text = "no warm-up step (the path's kernels ran before)"
    assert warm or captured_before, f"{label}: a turn without warm-up would time the capture"
    print(f"[{card}] phase {phase} {label}: step "
          f"{'captured by the run before' if captured_before else 'captured now'}: capture "
          f"{program.capture_s:.2f} s, instantiation {program.instantiate_s:.3f} s, private "
          f"pool {program.pool_bytes / 2**30:.2f} GiB, {len(program.tape.ops)} taped draws "
          f"and splits; {warm_text}")
    n = turns
    order = [("graph", "eager", "eager", "graph")[i % 4] for i in range(2 * n)]
    ms = {"graph": [], "eager": []}
    _zero_counts()
    mesh.COUNTS.clear()
    replays, server_calls = program.replays, AldpEnergyServer.calls
    for kind in order:
        ms[kind].append(timed(kind))
    wrapper_counts = dict(_counts(), **{f"{a} {k}": v for (a, k), v in mesh.COUNTS.items()},
                          **{"server calls": AldpEnergyServer.calls - server_calls})
    per_step = program.captured_counts
    assert program.replays - replays == n
    medians = {k: statistics.median(v) for k, v in ms.items()}
    print(f"[{card}] phase {phase} {label} steps in turns {'/'.join(order)}: graphed "
          f"{', '.join(f'{t:.1f}' for t in ms['graph'])} ms, eager "
          f"{', '.join(f'{t:.1f}' for t in ms['eager'])} ms; median {medians['graph']:.1f} / "
          f"{medians['eager']:.1f} ms")
    # The wrappers and the mesh count the eager twin's launches and collectives only;
    # a replay's are the captured step's.
    for k, v in per_step.items():
        assert wrapper_counts.get(k, 0) == n * v, (label, k, wrapper_counts.get(k), v)
    print(f"[{card}] phase {phase} {label}: kernel, collective and server-call counts per "
          f"captured step {per_step} (the eager twin's per step equal), times {n} replays")
    diff = _state_diff(trainer, states["graph"], eager, states["eager"])
    assert max(v for k, v in diff.items() if k != "bitwise") <= tol, (label, diff)
    assert diff["bitwise"] or not bitwise, (label, "not bitwise equal", diff)
    print(f"[{card}] phase {phase} {label} after {n + int(warm)} steps each: max relative "
          "difference "
          + ", ".join(f"{k} {v:.3e}" for k, v in diff.items() if k != "bitwise")
          + f" (tolerance {tol:g}); bitwise equal: {diff['bitwise']}")

    out = {"graph_ms": ms["graph"], "eager_ms": ms["eager"], "medians": medians,
           "diff": diff, "per_step": per_step, "capture_s": program.capture_s,
           "instantiate_s": program.instantiate_s, "pool_bytes": program.pool_bytes,
           "captured_by_run": captured_before}
    if eval_check:
        evals = {}
        for kind, t in (("graph", trainer), ("eager", eager)):
            logger, t.logger = t.logger, ListLogger()
            t.perform_eval(states[kind], torch.Generator(device=device).manual_seed(81), 1,
                           batch, batch)
            evals[kind], t.logger = t.logger.history, logger
        keys = [k for k, v in evals["eager"].items() if k != "step"]
        rel = {k: abs(evals["graph"][k][0] - evals["eager"][k][0])
               / max(abs(evals["eager"][k][0]), 1e-30) for k in keys
               if math.isfinite(evals["eager"][k][0])}
        assert all(math.isfinite(evals["graph"][k][0]) == math.isfinite(evals["eager"][k][0])
                   for k in keys)
        assert max(rel.values()) <= 1e-5, rel
        print(f"[{card}] phase {phase} {label} perform_eval after the graphed steps against after "
              f"the eager ones (same seed): {len(keys)} columns, max relative difference "
              f"{max(rel.values()):.3e} (tolerance 1e-5)")
        out["eval_max_rel"] = max(rel.values())

    # One replay under the profiler, and the graph's own kernel nodes.
    wall, by_name, in_graph, foreign = _device_events(lambda: take["graph"](states["graph"]))
    busy = sum(v[0] for v in by_name.values())
    words = {"k1_tf32x3_chain": "k1_tf32x3_chain", "k2_tf32x3_coupling": "k2_tf32x3_coupling",
             "k2_split_rows": "k2_split_rows", "k2_tf32x3_dense": "k2_tf32x3_dense",
             "k2_row_sum": "k2_row_sum", "k2_prepare_weight": "k2_prepare_weight"}
    launches = {k: _kernel_count(in_graph, w) for k, w in words.items()}
    nodes = _graph_kernels(program.graph)
    want = {"k1_tf32x3_chain": per_step["k1"], "k2_tf32x3_coupling": per_step["k2"],
            "k2_split_rows": per_step["k2"], "k2_tf32x3_dense": 2 * per_step["k2"],
            "k2_row_sum": per_step["k2"], "k2_prepare_weight": per_step["k2_rebuilds"]}
    assert {k: nodes[k] for k in want} == want, (nodes, want)
    # The energy server's calls: one host node and three copies each.
    calls = per_step.get("server calls", 0)
    assert nodes["host nodes"] == calls and nodes["memcpy nodes"] >= 3 * calls, (nodes, calls)
    # The replay ran the path's kernels. The profiler's records of a graph's kernels
    # are not exact (a replay of LGCP-1600's 75k nodes lost 1 of 400 coupling records;
    # one of GMM-40's named 42 records K1, which that graph does not hold), so the
    # exact count is the graph's own, above.
    assert all(launches[k] > 0 for k, v in want.items() if v), (launches, want)
    print(f"[{card}] phase {phase} {label}: the graph holds {nodes['kernel nodes']} kernel nodes "
          f"(read through libcuda), of them " + ", ".join(
              f"{k} {nodes[k]}" for k in want) + f", and {nodes['host nodes']} host nodes "
          f"and {nodes['memcpy nodes']} memcpy nodes ({calls} server calls captured): the "
          "captured counts")
    print(f"[{card}] phase {phase} {label} profiled replay: wall {wall:.1f} ms (profiler on), "
          f"device busy {busy:.1f} ms ({busy / medians['graph']:.1%} of the graphed median "
          f"step), {sum(v[1] for v in by_name.values())} device ops "
          f"({sum(v[1] for v in in_graph.values())} in the graph's one launch; {foreign} "
          f"records of no launch of this replay left out); its records by name "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    if launches != want:
        print(f"[{card}] phase {phase} {label}: the profiler's records against the graph's "
              "nodes: " + ", ".join(f"{k} {launches[k]} / {v}" for k, v in want.items()
                                    if launches[k] != v)
              + " (the records of graph kernels are off, not the graph)")
    out.update(busy=busy / medians["graph"], profiled_kernels=launches, graph_nodes=nodes)

    # The copy of the new state into the static one, at the end of every step, timed
    # as the graph runs it: captured alone and replayed.
    copies = [t.clone() for t in program.static]
    copy_graph = torch.cuda.CUDAGraph()
    with graph.collector_paused(), torch.cuda.graph(copy_graph):
        for c, s in zip(copies, program.static):
            c.copy_(s)
    copy_ms = _time_ms(copy_graph.replay, n=10)
    size = sum(t.numel() * t.element_size() for t in program.static)
    del copies, copy_graph
    print(f"[{card}] phase {phase} {label}: the state's copy back ({size / 1e6:.1f} MB of static "
          f"state) {copy_ms:.3f} ms a step")
    out["copy_back_ms"] = copy_ms

    out["replays"] = program.replays
    out["path_s"] = time.time() - t_path
    if not scanned:
        print(f"[{card}] phase {phase} {label}: {out['path_s']:.1f} s")
        return out
    # make_scanned_train_step(batch, 4) against 4 single replays from one state.
    start = _clone_state(states["graph"])
    saved = {k: v.clone() for k, v in trainer.model.flow.state_dict().items()}
    runs = {}
    for kind in ("scanned", "single"):
        trainer.model.flow.load_state_dict(saved)
        gen = torch.Generator(device=device).manual_seed(180)
        s = _clone_state(start)
        if kind == "scanned":
            s, _ = trainer.make_scanned_train_step(batch, GRAPH_SCANNED)(s, gen)
        else:
            for _ in range(GRAPH_SCANNED):
                s, _ = step(s, gen)
        runs[kind] = (_clone_state(s), {k: v.clone() for k, v in
                                        trainer.model.flow.state_dict().items()})
    leaves = lambda s: pytree.tree_leaves(tuple(s)[:-1])
    same = (all(torch.equal(runs["scanned"][1][k], v) for k, v in runs["single"][1].items())
            and all(torch.equal(a, b) for a, b in zip(leaves(runs["scanned"][0]),
                                                      leaves(runs["single"][0]))))
    assert same and runs["scanned"][0].step == runs["single"][0].step
    print(f"[{card}] phase {phase} {label}: make_scanned_train_step({batch}, {GRAPH_SCANNED}) "
          f"equals {GRAPH_SCANNED} single replays bitwise (parameters and every state tensor)")
    out["replays"] = program.replays
    out["path_s"] = time.time() - t_path
    print(f"[{card}] phase {phase} {label}: {out['path_s']:.1f} s")
    return out


def _graph_record(run: dict, kernel: str) -> dict:
    """A kernel's phase-18 figures for the kernels line: it runs inside the path's
    captured step."""
    return {
        "launches_per_captured_step": run["per_step"][kernel], "replays": run["replays"],
        "launches_in_replays": run["per_step"][kernel] * run["replays"],
        "profiled_replay_kernels": run["profiled_kernels"],
        "graph_kernel_nodes": run["graph_nodes"],
        "step_ms_graphed": run["graph_ms"], "step_ms_eager": run["eager_ms"],
        "device_busy_share_graphed": run["busy"], "capture_s": run["capture_s"],
        "instantiate_s": run["instantiate_s"], "pool_bytes": run["pool_bytes"],
        "max_rel_diff_vs_eager": {k: v for k, v in run["diff"].items() if k != "bitwise"},
        "bitwise_vs_eager": run["diff"]["bitwise"], "copy_back_ms": run["copy_back_ms"],
    }


def phase18_path(card, mw, lgcp, gmm) -> dict:
    """Phase 18: the compiled step on ManyWell-32 (K1 in the graph), LGCP-1600 (K2 in
    the graph, and perform_eval after graphed against after eager steps) and GMM-40
    (f64), each ``(trainer, state)``."""
    t0 = time.time()
    out = {"ManyWell-32": graph_turns("ManyWell-32", *mw, MW_BATCH, 1e-5, card)}
    out["LGCP-1600"] = graph_turns("LGCP-1600", *lgcp, LG_BATCH, 1e-5, card, eval_check=True)
    out["GMM-40"] = graph_turns("GMM-40", *gmm, 128, 1e-12, card)
    out["phase_s"] = time.time() - t0
    print(f"[{card}] phase 18: {out['phase_s']:.1f} s (budget {PHASE18_BUDGET_S} s)")
    return out


# ------------------------------------------------------------------ phase 19
# The compiled programs of the spline, LARS, SNF and data-mesh paths (graph.py): the ALDP
# family's steps (captured by phases 11-12's runs), GMM-40's LARS and SNF steps
# (phase 12's runs), ManyWell-32's data-parallel step under NCCL at world size 1
# (captured here), and the compiled fill against the eager one. Each path takes
# turns with an eager twin from one state and seed.
PHASE19_BUDGET_S = 300
PHASE19_TURNS = {"ManyWell-32 data-parallel": 3, "GMM-40-rbd": 5, "GMM-40-snf": 5,
                 "aldp.yaml": 1, "aldp_rbd": 1, "aldp_snf": 1,
                 "ManyWell-32 target_forward_kl": 3, "GMM-40 WrappedTorchDist target": 3,
                 "GMM-40 WrappedModuleFlow": 3}
# aldp.yaml's and aldp_rbd's turns before their cut for the host-drawn paths' room.
PHASE19_TURNS_BEFORE = {"aldp.yaml": 2, "aldp_rbd": 2}
# aldp.yaml's fill cut in length only: 64 batches of 1024 rows to FILL_BATCHES (4
# until the smoke took 1430 s on a slow host).
FILL_BATCHES = 1


def _rss_gib() -> float:
    """This process's resident host memory (GiB)."""
    with open("/proc/self/status") as f:
        line = next(line for line in f if line.startswith("VmRSS:"))
    return int(line.split()[1]) / 2**20


def _record_builds() -> None:
    """Every program's build records the host's resident memory before and after it
    (``program.rss_gib``)."""
    from fab_tpu_torch import graph

    build = graph.Program._build

    def recorded(self, state):
        before = _rss_gib()
        build(self, state)
        self.rss_gib = (before, _rss_gib())

    graph.Program._build = recorded


def fill_turns(label, trainer, batches, batch, card, tol) -> dict:
    """The compiled fill of a copy of ``trainer`` (its buffer's minimum set to
    ``batches`` batches) against the eager fill of another copy, from one seed: the
    buffers and the transition states compared, each fill's seconds."""
    import dataclasses
    from unittest import mock

    import torch

    from fab_tpu_torch import graph

    twins = {kind: _twin(trainer) for kind in ("compiled", "eager")}
    states, seconds = {}, {}
    for kind, twin in twins.items():
        twin.buffer = dataclasses.replace(trainer.buffer, min_sample_length=batches * batch)
        refuse = mock.patch.object(graph, "graph_supported",
                                   lambda t: (False, "the eager twin of phase 19's fill"))
        torch.cuda.synchronize()
        t0 = time.time()
        with refuse if kind == "eager" else contextlib.nullcontext():
            states[kind] = twin.init_state(torch.Generator(device=trainer.device).manual_seed(19),
                                           batch_size=batch)
        torch.cuda.synchronize()
        seconds[kind] = time.time() - t0
    fill = twins["compiled"].fill_program
    assert fill.graph is not None and fill.replays == batches
    assert twins["eager"].fill_program is None
    a, b = states["compiled"], states["eager"]
    assert int(a.buffer_state.n_added) == int(b.buffer_state.n_added) == batches * batch
    rel = lambda x, y: float((x.double() - y.double()).abs().max()
                             / y.double().abs().max().clamp(min=1e-30))
    finite = torch.isfinite(b.buffer_state.log_w)
    assert torch.equal(finite, torch.isfinite(a.buffer_state.log_w)), label
    diff = {"x": rel(a.buffer_state.x, b.buffer_state.x),
            "log_w": rel(a.buffer_state.log_w[finite], b.buffer_state.log_w[finite]),
            "transition": max(rel(v, b.transition_state[k])
                              for k, v in a.transition_state.items())}
    bitwise = (all(torch.equal(x, y) for x, y in zip(a.buffer_state, b.buffer_state))
               and all(torch.equal(v, b.transition_state[k])
                       for k, v in a.transition_state.items()))
    assert max(diff.values()) <= tol, (label, diff)
    print(f"[{card}] phase 19 {label} fill of {batches} batches of {batch}: compiled "
          f"{seconds['compiled']:.2f} s ({fill.replays} replays of the captured pass; capture "
          f"{fill.capture_s:.2f} s, instantiation {fill.instantiate_s:.3f} s, private pool "
          f"{fill.pool_bytes / 2**30:.2f} GiB, kernel counts per pass {fill.captured_counts}), "
          f"eager {seconds['eager']:.2f} s; max relative difference "
          + ", ".join(f"{k} {v:.3e}" for k, v in diff.items())
          + f" (tolerance {tol:g}); bitwise equal: {bitwise}")
    return {"seconds": seconds, "diff": diff, "bitwise": bitwise,
            "captured": fill.captured_counts, "replays": fill.replays,
            "capture_s": fill.capture_s, "instantiate_s": fill.instantiate_s,
            "pool_bytes": fill.pool_bytes}


def data_mesh_turns(trainer, state, card) -> dict:
    """ManyWell-32's data-parallel step compiled under an NCCL group of world size 1:
    graph_turns against its eager twin on the mesh; its captured collectives against
    ``expected_collectives``, K1's 38 nodes in its graph."""
    import torch

    from fab_tpu_torch import graph
    from fab_tpu_torch.parallel import distributed, mesh

    device = trainer.device
    assert distributed.initialize(device, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                  world_size=1, rank=0)
    try:
        with mesh.use_mesh(mesh.make_mesh()):
            supported, reason = graph.graph_supported(trainer)
            assert supported and "nccl collectives" in reason, reason
            print(f"[{card}] phase 19 ManyWell-32 data-parallel: {reason}")
            run = graph_turns("ManyWell-32 data-parallel", trainer, state, MW_BATCH, 1e-5, card,
                              phase=19, turns=PHASE19_TURNS["ManyWell-32 data-parallel"])
    finally:
        distributed.shutdown()
    captured = {k: v for k, v in run["per_step"].items() if " " in k and k != "server calls"}
    expect = expected_collectives(4, 1, 8)
    assert sum(captured.values()) == expect["total"], (captured, expect)
    assert run["graph_nodes"]["k1_tf32x3_chain"] == 38, run["graph_nodes"]
    print(f"[{card}] phase 19 ManyWell-32 data-parallel: collectives per captured step "
          f"{captured} = {sum(captured.values())}, reckoned from the code {expect['total']}; "
          f"K1 {run['graph_nodes']['k1_tf32x3_chain']} kernel nodes, NCCL "
          f"{run['graph_nodes']['nccl']} kernel nodes in the graph")
    return run


def _forward_kl_trainer(device):
    """ManyWell-32 target_forward_kl (many_well.yaml's flow with flow.fused=true, K1;
    fab.loss_type=target_forward_kl: no AIS, the exact draws by rejection sampling),
    the plain Trainer, f32, and its initial state."""
    import torch

    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.targets import ManyWellEnergy
    from fab_tpu_torch.train import Trainer, make_optimizer

    flow = make_realnvp(MW_DIM, MW_LAYERS, MW_NODES, fused=True, device=device,
                        generator=torch.Generator(device=device).manual_seed(15))
    model = FABModel.create(flow, ManyWellEnergy(MW_DIM, device=device),
                            loss_type="target_forward_kl", use_ais=False)
    trainer = Trainer(model, make_optimizer(3e-4, 100.0), device=device)
    return trainer, trainer.init_state(torch.Generator(device=device).manual_seed(15))


def _wrapped_trainers(device) -> dict:
    """Phase 19's wrapped paths at GMM-40's shape (f64, batch 128, gmm.yaml's Metropolis
    AIS as phase 15(b)): a RealNVP (gmm.yaml's 15 layers of width 80) over a
    WrappedTorchDist target (GMM-40's 40 components as a MixtureSameFamily,
    validate_args off), and a WrappedModuleFlow (_smoke_module, its draws through
    fab_tpu_torch.random) over the GMM-40 target; each with its initial state."""
    import torch

    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import Metropolis
    from fab_tpu_torch.targets import GMM
    from fab_tpu_torch.train import Trainer, make_optimizer
    from fab_tpu_torch.wrappers import WrappedModuleFlow, WrappedTorchDist

    f64, dists = torch.float64, torch.distributions
    gmm = GMM(dim=2, n_mixes=40, loc_scaling=40.0, log_var_scaling=1.0,
              true_expectation_estimation_n_samples=1000, dtype=f64, device=device)
    mixture = dists.MixtureSameFamily(
        dists.Categorical(logits=torch.zeros(40, dtype=f64, device=device),
                          validate_args=False),
        dists.Independent(dists.Normal(gmm.locs, gmm.scales, validate_args=False), 1,
                          validate_args=False), validate_args=False)
    flows = {
        "GMM-40 WrappedTorchDist target": (
            make_realnvp(2, 15, 40, generator=torch.Generator(device=device).manual_seed(16),
                         dtype=f64, device=device), WrappedTorchDist.wrap(mixture)),
        "GMM-40 WrappedModuleFlow": (WrappedModuleFlow(_smoke_module(2, device), 2), gmm),
    }
    out = {}
    for label, (flow, target) in flows.items():
        model = FABModel.create(
            flow, target, transition_operator=Metropolis(
                n_ais_intermediate_distributions=1, n_updates=1, max_step_size=5.0,
                min_step_size=5.0, adjust_step_size=False, target_p_accept=0.65),
            n_intermediate_distributions=1, alpha=2.0, loss_type="fab_alpha_div")
        trainer = Trainer(model, make_optimizer(1e-4, 100.0), dtype=f64, device=device)
        out[label] = (trainer, trainer.init_state(
            torch.Generator(device=device).manual_seed(17)))
    return out


def phase19_path(card, mw, dp, gmm, aldp, rbd, snf) -> dict:
    """Phase 19: each ``(trainer, state)``'s compiled step against its eager twin
    (``graph_turns``), and the compiled fill against the eager one on aldp.yaml (cut
    to FILL_BATCHES batch) and ManyWell-32 (its 4 passes); then the paths that
    draw on the host: ManyWell-32 target_forward_kl (K1 in the graph, the rejection
    draws in the noise pass) and the two wrapped paths."""
    from fab_tpu_torch.ops import coupling_kernel as ck

    t0 = time.time()
    out = {"ManyWell-32 data-parallel": data_mesh_turns(*dp, card)}
    for label, (trainer, state) in gmm.items():
        out[label] = graph_turns(label, trainer, state, 128, 1e-12, card, phase=19,
                                 turns=PHASE19_TURNS[label], scanned=False)
    # The ALDP steps were captured by phases 11-12's runs, their kernels ran there:
    # no warm-up step.
    print(f"[{card}] phase 19 cut: turns " + ", ".join(
        f"{k} {v} -> {PHASE19_TURNS[k]}" for k, v in PHASE19_TURNS_BEFORE.items()))
    for label, (trainer, state) in (("aldp.yaml", aldp), ("aldp_rbd", rbd), ("aldp_snf", snf)):
        out[label] = graph_turns(label, trainer, state, 1024, 1e-5, card, phase=19,
                                 turns=PHASE19_TURNS[label], warm=False, scanned=False)
        program = trainer._program(1024)
        before, after = program.rss_gib
        print(f"[{card}] phase 19 {label}: the program's build (warm-up step, capture, "
              f"instantiation) took the host's resident memory from {before:.2f} to "
              f"{after:.2f} GiB")
        out[label]["rss_gib"] = program.rss_gib
        if label == "aldp.yaml":
            print(f"[{card}] aldp.yaml fill cut (length only): "
                  f"training.replay_buffer.min_length = {FILL_BATCHES} (aldp.yaml: 64; "
                  "4 before the last cut)")
            out["fill aldp.yaml"] = fill_turns("aldp.yaml", trainer, FILL_BATCHES, 1024, card,
                                               1e-5)
    _zero_counts()
    out["fill ManyWell-32"] = fill_turns("ManyWell-32", mw[0], 4, MW_BATCH, card, 1e-5)
    assert out["fill ManyWell-32"]["captured"]["k1"] == 22
    assert _counts()["k1"] == 2 * 22 + 4 * 22  # the compiled twin's warm-up and
    # capture, and the eager twin's 4 passes
    assert ck.fused_coupling_apply.launches == 0
    out.update(host_drawn_turns(mw[0].device, card))
    out["phase_s"] = time.time() - t0
    print(f"[{card}] phase 19: {out['phase_s']:.1f} s (budget {PHASE19_BUDGET_S} s)")
    return out


def host_drawn_turns(device, card) -> dict:
    """Phase 19's paths that draw on the host (``random.host_draw`` in the noise
    pass): ManyWell-32 target_forward_kl (K1 in the graph) and the two wrapped paths,
    each compiled against its eager twin, bitwise."""
    t_host, out = time.time(), {}
    trainer, state = _forward_kl_trainer(device)
    run = graph_turns("ManyWell-32 target_forward_kl", trainer, state, MW_BATCH, 1e-5, card,
                      phase=19, turns=PHASE19_TURNS["ManyWell-32 target_forward_kl"],
                      scanned=False, bitwise=True)
    # K1 per step: the exact draws' inverse pass and its backward recompute.
    assert run["per_step"]["k1"] == 1 and run["per_step"]["k1_recomputes"] == 1, run["per_step"]
    assert run["graph_nodes"]["k1_tf32x3_chain"] == 1
    ops = trainer._program(MW_BATCH).tape.ops
    assert [op[0] for op in ops] == ["host"], ops
    print(f"[{card}] phase 19 ManyWell-32 target_forward_kl: the tape holds one host draw "
          f"{ops[0][2]} ({MW_DIM // 2} wells' rejection sampling, in the noise pass); K1 "
          f"{run['per_step']['k1']} launch and {run['per_step']['k1_recomputes']} recompute per "
          "captured step")
    out["ManyWell-32 target_forward_kl"] = run
    for label, (trainer, state) in _wrapped_trainers(device).items():
        out[label] = graph_turns(label, trainer, state, 128, 1e-12, card, phase=19,
                                 turns=PHASE19_TURNS[label], scanned=False, bitwise=True)
        assert not any(v for k, v in out[label]["per_step"].items()), out[label]["per_step"]
    print(f"[{card}] phase 19 host-drawn paths: {time.time() - t_host:.1f} s")
    return out


def drive(device, gen, name, card) -> list:
    """Phases 2-19; returns the kernel records."""
    _record_builds()
    t0, phase_s = time.time(), {}
    # ------------------------------------------------ 2-4. K1 and the ManyWell path
    k1 = check_k1(device, gen)
    mw, *mw_trainer = manywell_path(device, gen, card)
    k1_timing, k1_bounds = time_k1(k1, name, card)
    phase_s["2-4 K1, ManyWell"] = time.time() - t0

    # Phases 5-13 share one directory: phase 13 evaluates the checkpoints and runs
    # that phases 6-7, 9, 11 and 12 leave there.
    with tempfile.TemporaryDirectory() as tmp:
        # ------------------------------------------------ 5-7. K2 and the LGCP path
        k2 = check_k2(device, gen)
        lg_dir = os.path.join(tmp, "lgcp")
        trainer, state, lg = lgcp_path(device, gen, card, lg_dir)
        # Phase 17's trajectory: the flow after phase 6's steps and after phase 7's run.
        trajectory = os.path.join(tmp, "lgcp_run", "model_checkpoints")
        _save_flow_checkpoint(trainer, state,
                              os.path.join(trajectory, f"iter_{state.step}", "state.pkl"))
        lgcp_run_entry(trainer, state, gen, card, lg_dir)
        _save_flow_checkpoint(trainer, state, os.path.join(tmp, "lgcp_checkpoint", "state.pkl"))
        shutil.copytree(os.path.join(tmp, "lgcp_checkpoint"),
                        os.path.join(trajectory, f"iter_{state.step + 2}"))
        lgcp_trainer = (trainer, state)  # phase 18's; its step was captured by the run
        del trainer, state
        k2_timing, k2_bounds, k2_library, k2_rebuild = time_k2(k2, name, card)
        phase_s["5-7 K2, LGCP"] = time.time() - t0

        # ------------------------------------------------ 8. K1 at the wide chains
        k1_wide = check_k1_wide(device, gen, name, card)
        phase_s["8 K1 wide"] = time.time() - t0

        # ------------------------------------------------ 9-10. the YAML runners
        gmm = gmm_runner(device, gen, card, tmp)
        many_well_runner(card, tmp)
        phase_s["9-10 runners"] = time.time() - t0

        # Phases 14-16's commands that need nothing of this process, started here to run
        # beside phases 11-13 (see _Started).
        started = {"launcher": launcher_start(device, tmp), "scaling": scaling_start(),
                   "model_axis": model_axis_start(device, tmp)}
        print(f"[{card}] started before phase 11, to run beside it: phase 14's launcher run, "
              "16(b)'s bench_scaling and 15(a)'s two model-axis ranks")

        # ------------------------------------------------ 11. ALDP
        aldp = aldp_path(device, gen, card, tmp)
        phase_s["11 ALDP"] = time.time() - t0

        # ------------------------------------------------ 12. the LARS base and SNF
        lars_snf = lars_snf_path(device, gen, card, tmp)
        phase_s["12 LARS and SNF"] = time.time() - t0

        # ------------------------------------------------ 13. server, profiler, scripts
        tools = tools_path(device, gen, card, tmp)
        phase_s["13 host C++, profile, evaluation"] = time.time() - t0

        # ------------------------------------------------ 14. data parallel, DCP
        dp = data_parallel_path(device, card, tmp, started["launcher"])
        phase_s["14 data parallel"] = time.time() - t0

        # ------------------------------------------------ 15. model axis, wrappers
        t15 = time.time()
        ma = model_axis_path(device, card, tmp, started["model_axis"])
        wrappers_path(device, card)
        phase_s["15 model axis, wrappers"] = time.time() - t0
        print(f"[{card}] phase 15: {time.time() - t15:.1f} s")

        # ------------------------------------------------ 16. bench, scripts
        p16 = phase16_path(device, card, tmp, started["scaling"])
        phase_s["16 bench, scripts"] = time.time() - t0

        # ------------------------------------------------ 17. studies, options
        p17 = phase17_path(device, card, tmp)
        phase_s["17 studies, options"] = time.time() - t0

        # ------------------------------------------------ 18. the compiled step
        p18 = phase18_path(card, mw_trainer, lgcp_trainer, gmm.pop("trainer"))
        del lgcp_trainer
        phase_s["18 compiled step"] = time.time() - t0

        # ------------------------------------------------ 19. the programs since
        trainers = lars_snf.pop("trainers")
        p19 = phase19_path(card, mw_trainer, dp.pop("trainer"),
                           {k: trainers.pop(k) for k in ("GMM-40-rbd", "GMM-40-snf")},
                           aldp.pop("trainer"), trainers.pop("aldp_rbd"),
                           trainers.pop("aldp_snf"))
        del mw_trainer, trainers
        phase_s["19 compiled programs"] = time.time() - t0

    kernels = [
        {
            "name": "fused_realnvp_pass",
            "route": "cuda",
            "source": "fab_tpu_torch/ops/csrc/realnvp_kernel.cu",
            "replaces": "fab_tpu/ops/realnvp_kernel.py:134",
            "launches": mw["total"]["k1"],
            "max_abs_err": max(e[0] for e in k1["errors"].values()),
            "ms": k1_timing[True][0],
            "plain_ms": k1_timing[True][1],
            "bound_ms": k1_bounds["3xtf32"][0],
            "bound_by": k1_bounds["3xtf32"][1],
            "library_ms": None,
            "bound": "3xTF32 on the tensor cores (f32 accuracy), as K1 computes",
            "bound_ms_f32_fma": k1_bounds["f32_fma"][0],
            "bound_by_f32_fma": k1_bounds["f32_fma"][1],
            "mode": "inverse (37 of the 38 launches per ManyWell-32 step)",
            "ms_forward": k1_timing[False][0],
            "plain_ms_forward": k1_timing[False][1],
            "max_abs_err_log_det": max(e[1] for e in k1["errors"].values()),
            "max_abs_err_ragged": max(e[0] for k, e in k1["errors"].items() if "B=" in k),
            "step_ms": mw["steady_ms"],
            "samples_per_s": MW_BATCH / mw["steady_ms"] * 1e3,
            "device_busy_share": mw["busy"],
            "profiled_step_k1_ms": mw["k1_group_ms"],
            "log_det_bitwise_repeatable": True,
            "wide_chains": k1_wide,
            "launches_data_parallel": dp["k1_launches"],
            "data_parallel": {
                "world_size": 1, "backend": "nccl", "step_ms": dp["dp_ms"],
                "plain_step_ms": dp["plain_ms"], "device_busy_share": dp["busy"],
                "nccl_ms_per_step": dp["nccl_ms"], "collectives_per_step": dp["collectives"],
                "max_rel_diff_vs_plain": {k: v for k, v in dp["diff"].items()
                                          if k != "bitwise"},
                "bitwise_vs_plain": dp["diff"]["bitwise"],
                "dcp_save_ms": dp["dcp_save_ms"], "dcp_load_ms": dp["dcp_load_ms"],
                "dcp_bytes": dp["dcp_bytes"], "launcher_run_s": dp["launcher_s"],
                "collective_ms": dp["collective_ms"],
                "collectives_ms_per_step": dp["collectives_ms_per_step"],
            },
            "bench": dict(p16["bench"]["bench"], median_fused_step_ms=p16["bench"]["fused_ms"],
                          median_plain_step_ms=p16["bench"]["plain_ms"],
                          median_eager_fused_step_ms=p16["bench"]["eager_fused_ms"],
                          median_eager_plain_step_ms=p16["bench"]["eager_plain_ms"],
                          bench_scaling=p16["bench"]["scaling"]),
            "in_graph": _graph_record(p18["ManyWell-32"], "k1"),
            "in_forward_kl_graph": _graph_record(p19["ManyWell-32 target_forward_kl"], "k1"),
            "in_graph_data_parallel": dict(
                _graph_record(p19["ManyWell-32 data-parallel"], "k1"), backend="nccl",
                world_size=1, collectives_per_captured_step=sum(
                    v for k, v in p19["ManyWell-32 data-parallel"]["per_step"].items()
                    if " " in k and k != "server calls")),
            "in_fill_graph": dict(mw["fill"],
                                  launches_per_captured_pass=mw["fill"]["captured"]["k1"],
                                  launches_in_replays=mw["fill"]["captured"]["k1"]
                                  * mw["fill"]["replays"],
                                  fill_s_compiled_vs_eager=p19["fill ManyWell-32"]["seconds"]),
            "launches_model_axis": sum(p[0] for p in ma["fused"]["k1_per_step"]),
            "model_axis": {
                "grid": [1, 2], "backend": "gloo (two ranks on one card)",
                "step_ms": ma["fused"]["ms"], "one_process_step_ms": ma["fused"]["ref_ms"],
                "max_rel_diff_vs_one_process": {k: v for k, v in ma["fused"]["diff"].items()
                                                if k != "bitwise"},
                "collectives_per_step": ma["fused"]["collectives"],
                "plain_flow": {"step_ms": ma["plain"]["ms"],
                               "one_process_step_ms": ma["plain"]["ref_ms"],
                               "collectives_per_step": ma["plain"]["collectives"],
                               "max_rel_diff_vs_one_process": {
                                   k: v for k, v in ma["plain"]["diff"].items()
                                   if k != "bitwise"}},
            },
        },
        {
            "name": "fused_coupling_apply",
            "route": "cuda",
            "source": "fab_tpu_torch/ops/csrc/coupling_kernel.cu",
            "replaces": "fab_tpu/ops/coupling_kernel.py:167",
            "launches": lg["total"]["k2"],
            "max_abs_err": max(e[0] for e in k2["errors"].values()),
            "ms": k2_timing[True][0],
            "plain_ms": k2_timing[True][1],
            "bound_ms": k2_bounds["3xtf32"][0],
            "bound_by": k2_bounds["3xtf32"][1],
            "library_ms": k2_library,
            "bound": "3xTF32 on the tensor cores (f32 accuracy), as K2 computes",
            "bound_ms_f32_fma": k2_bounds["f32_fma"][0],
            "bound_by_f32_fma": k2_bounds["f32_fma"][1],
            "library": "3 x cuBLAS f32 GEMM, no epilogue; no single call computes K2",
            "mode": "inverse (392 of the 400 launches per LGCP-1600 step)",
            "ms_forward": k2_timing[False][0],
            "plain_ms_forward": k2_timing[False][1],
            "max_abs_err_log_det": max(e[1] for e in k2["errors"].values()),
            "step_ms": lg["steady_ms"],
            "samples_per_s": LG_BATCH / lg["steady_ms"] * 1e3,
            "device_busy_share": lg["busy"],
            "max_abs_err_after_update": k2["errors"]["after update"][0],
            "log_det_bitwise_repeatable": True,
            "rebuilds_per_step": lg["rebuilds_per_step"],
            "rebuild_ms_per_coupling": k2_rebuild,
            "launches_evaluation": tools["eval"]["k2_launches"],
            "bench_lgcp_kernel": p16["lgcp_kernel"],
            "launches_in_graph_evaluation": p16["in_graph"]["launches"]["true"],
            "launches_trajectory_evaluation": p17["trajectory"]["launches"],
            "in_graph": _graph_record(p18["LGCP-1600"], "k2"),
            "in_fill_graph": dict(lg["fill"],
                                  launches_per_captured_pass=lg["fill"]["captured"]["k2"],
                                  launches_in_replays=lg["fill"]["captured"]["k2"]
                                  * lg["fill"]["replays"]),
            "launches_model_axis": ma["lgcp"]["counts"]["k2"],
            "model_axis": {"grid": [1, 2], "step_ms": ma["lgcp"]["step_ms"],
                           "rebuilds_per_step": ma["lgcp"]["counts"]["k2_rebuilds"],
                           "recomputes_per_step": ma["lgcp"]["counts"]["k2_recomputes"]},
        },
    ]
    print(f"[{card}] GMM-40 runner path (no kernel): median step {gmm['steady_ms']:.1f} ms, "
          f"{128 / gmm['steady_ms'] * 1e3:.1f} AIS samples/s, device busy "
          f"{gmm['busy']:.1%} of the median step")
    print(f"[{card}] ALDP path (no kernel): median step {aldp['steady_ms']:.1f} ms, "
          f"{1024 / aldp['steady_ms'] * 1e3:.1f} AIS samples/s, device busy "
          f"{aldp['busy']:.1%} of the median step")
    run = lars_snf["rbd"]
    print(f"[{card}] ALDP-rbd path (no kernel): a profiled eager step, device busy "
          f"{run['busy_profiled']:.1%} of its wall, {run['device_ops']} device ops")
    compiled = tools["host_cpp"]["compiled"]
    for backend in ("jax", "host_cpp"):
        run = tools["host_cpp"][backend]
        print(f"[{card}] ALDP aldp.yaml with system.backend={backend} (phase 13): eager median "
              f"step {run['steady_ms']:.1f} ms, {1024 / run['steady_ms'] * 1e3:.1f} AIS "
              f"samples/s"
              + (f", device busy {run['busy']:.1%}, {run['device_ops']} device ops"
                 if run["busy"] is not None else "")
              + f", {run['server_calls_per_step']} server calls per step; compiled median "
              f"{compiled['medians'][backend]:.1f} ms, device busy "
              f"{compiled['busy'][backend]:.1%}, {compiled['host_nodes'][backend]} host nodes")
    print(f"[{card}] data-parallel ManyWell-32 (NCCL, world size 1): median step "
          f"{statistics.median(dp['dp_ms']):.1f} ms against the plain trainer's "
          f"{statistics.median(dp['plain_ms']):.1f} ms in turns, device busy {dp['busy']:.1%}, "
          f"NCCL {dp['nccl_ms']:.3f} ms and {dp['collectives']} collectives per step")
    for phase, runs in ((18, p18), (19, p19)):
        for label, run in runs.items():
            if label != "phase_s" and not label.startswith("fill"):
                print(f"[{card}] {label} compiled step (phase {phase}): median "
                      f"{run['medians']['graph']:.1f} ms graphed against "
                      f"{run['medians']['eager']:.1f} ms eager, in turns; device busy "
                      f"{run['busy']:.1%} of the graphed step; capture {run['capture_s']:.2f} s, "
                      f"instantiation {run['instantiate_s']:.2f} s, "
                      f"{run['graph_nodes']['kernel nodes']} kernel nodes")
    for label in ("fill aldp.yaml", "fill ManyWell-32"):
        run = p19[label]
        print(f"[{card}] {label} (phase 19): compiled {run['seconds']['compiled']:.2f} s against "
              f"eager {run['seconds']['eager']:.2f} s")
    print(f"[{card}] wall time by phase (s, cumulative from phase 2): "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    return kernels


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--model-axis-rank"]:
        return model_axis_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fab_tpu_torch import native
    from fab_tpu_torch.ops import coupling_kernel as ck
    from fab_tpu_torch.ops import realnvp_kernel as rk

    # ------------------------------------------------------------ 1. environment
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        *libs, host_lib = pool.map(lambda m: m.build(), (rk, ck, native))
    rk._library()
    ck._library()
    native._library()
    print(f"built K1 and K2 with nvcc and the host C++ energy server with g++ "
          f"({', '.join(p.name for p in (*libs, host_lib))}) in {time.time() - t0:.2f} s")
    for path in libs:
        print(path.with_suffix(".ptxas.txt").read_text().strip())
    spills = _spills(libs[0].with_suffix(".ptxas.txt").read_text(), "k1_tf32x3_chain")
    assert spills == (0, 0), f"K1 spills registers: {spills} bytes stored / loaded"

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    try:
        kernels = drive(device, gen, name, card)
    finally:
        _stop_started()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
