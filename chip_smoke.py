#!/usr/bin/env python3
"""Drive the PyTorch port (fab_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases:
  1. Environment: the card's name and power limit, torch and CUDA versions; build
     every kernel of the main path from the sources in this checkout.
  2. Each kernel against its plain PyTorch version on the card at main-path shapes,
     with every parameter perturbed (a fresh coupling's last layer is zero).
  3. The main path: ManyWell-32 FAB with a prioritised buffer at bench.py's
     settings (batch 2048; RealNVP 10 x [coupling, width 320; LU]; HMC with 4
     intermediate distributions, 5 leapfrog steps; buffer 32768 / 8192; 8 replay
     batches), with the fused flow, so every flow pass runs through K1: init_state,
     then 5 train steps. Launch counters are zeroed just before and read just after.
  4. One more step under torch.profiler: device busy share and top device ops.
  5. Kernel timing with CUDA events at main-path shapes.

Prints the kernel JSON line, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero on any failure, and without a card.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# Peak rates for the bound: f32 on the CUDA cores and device-memory bandwidth
# (NVIDIA's H100 data sheet, dense; SXM at 700 W, PCIe at 350 W).
PEAKS = {
    "sxm": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
    "pcie": {"f32_flops": 51e12, "bytes_per_s": 2.0e12},
}

DIM, LAYERS, NODES_PER_DIM, BATCH = 32, 10, 10, 2048
N_STEPS = 5


def _peaks(name: str) -> dict:
    return PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


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


def _perturb(flow, generator, scale: float = 0.005) -> None:
    """Perturb every parameter. Larger scales overflow exp() in a 10-layer chain."""
    import torch

    with torch.no_grad():
        for p in flow.parameters():
            p.add_(scale * torch.randn(p.shape, generator=generator, device=p.device))


def _max_rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fab_tpu_torch.buffer import PrioritisedReplayBuffer
    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.flows.fused import FusedPass, _stack_params
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.ops import realnvp_kernel as rk
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo
    from fab_tpu_torch.targets import ManyWellEnergy
    from fab_tpu_torch.train import PrioritisedBufferTrainer, make_optimizer

    # ------------------------------------------------------------ 1. environment
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.time()
    lib_path = rk.build()
    rk._library()
    print(f"built K1 ({lib_path.name}) in {time.time() - t0:.2f} s")
    print(lib_path.with_suffix(".ptxas.txt").read_text().strip())

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)

    # --------------------------------------- 2. K1 against its plain version
    fused = make_realnvp(DIM, LAYERS, NODES_PER_DIM, fused=True, generator=gen,
                        device=device)
    _perturb(fused, gen)
    plain = make_realnvp(DIM, LAYERS, NODES_PER_DIM, fused=False, generator=gen,
                        device=device)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(BATCH, DIM, generator=gen, device=device)
    keys = ("w1", "b1", "w2", "b2", "w3", "b3", "wlin", "lu_ld")
    operands = {}
    errors = {}
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
        y, ld_f = fused.forward_and_log_det(x)
        x_back, ld_i = fused.inverse_and_log_det(y)
        torch.cuda.synchronize()
        torch.testing.assert_close(x_back, x, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(ld_i, -ld_f, atol=1e-3, rtol=1e-4)
        print(f"K1 round trip: max|inverse(forward(x)) - x| {float((x_back - x).abs().max()):.3e}")
        # A [n, B, D] input is flattened into one launch, not run through the plain chain.
        before = rk.fused_realnvp_pass.launches
        x3 = x.reshape(4, BATCH // 4, DIM)
        z3, ld3 = fused.inverse_and_log_det(x3)
        z3_ref, ld3_ref = plain.inverse_and_log_det(x3)
        torch.cuda.synchronize()
        assert rk.fused_realnvp_pass.launches == before + 1
        torch.testing.assert_close(z3, z3_ref, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld3, ld3_ref, atol=1e-3, rtol=0)
        print(f"K1 on a {tuple(x3.shape)} input: one launch, max|z - plain| "
              f"{float((z3 - z3_ref).abs().max()):.3e}")

    cot_y = torch.randn(BATCH, DIM, generator=gen, device=device)
    cot_ld = torch.randn(BATCH, generator=gen, device=device)
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

    # ------------------------------------------------------------- 3. main path
    target = ManyWellEnergy(DIM, device=device)
    flow = make_realnvp(DIM, LAYERS, NODES_PER_DIM, fused=True, generator=gen,
                        device=device)
    op = HamiltonianMonteCarlo(
        n_ais_intermediate_distributions=4, n_outer=1, n_leapfrog=5, epsilon=1.0
    )
    model = FABModel.create(
        flow, target, transition_operator=op, n_intermediate_distributions=4,
        loss_type="fab_alpha_div",
    )
    buffer = PrioritisedReplayBuffer(
        dim=DIM, max_length=BATCH * 16, min_sample_length=BATCH * 4
    )
    trainer = PrioritisedBufferTrainer(
        model, make_optimizer(3e-4, 100.0), buffer, n_batches_buffer_sampling=8,
        w_adjust_max_clip=10.0, device=device,
    )

    rk.fused_realnvp_pass.launches = 0
    FusedPass.recomputes = 0
    torch.cuda.synchronize()
    t0 = time.time()
    state = trainer.init_state(gen, batch_size=BATCH)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    init_launches = rk.fused_realnvp_pass.launches
    assert init_launches == 22 * 4, f"init_state launched K1 {init_launches} times"
    step_ms, per_step = [], []
    for _ in range(N_STEPS):
        before = (rk.fused_realnvp_pass.launches, FusedPass.recomputes)
        t0 = time.time()
        state, info = trainer.train_step(state, gen, BATCH)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        per_step.append((rk.fused_realnvp_pass.launches - before[0],
                         FusedPass.recomputes - before[1]))
        loss = float(info["loss"])
        n_valid = int(info["n_valid"])
        print(f"step {state.step}: {step_ms[-1]:.1f} ms, replay loss {loss:.4f}, "
              f"n_valid {n_valid}, ess_ais {float(info['ess_ais']):.4f}, "
              f"update_applied {bool(info['update_applied'])}")
        assert math.isfinite(loss), "non-finite loss"
        assert n_valid > 0, "no valid AIS row"
    main_launches = rk.fused_realnvp_pass.launches
    assert all(p == (38, 29) for p in per_step), f"launches/recomputes per step: {per_step}"
    print(f"main path: K1 launches {main_launches} (init_state {init_launches}, "
          f"38 per step), backward recomputations {FusedPass.recomputes} (29 per step)")

    # Output check: finite parameters and buffer, and the trained fused flow agrees
    # with the plain Flow holding the same parameters on buffer rows.
    assert all(torch.isfinite(p).all() for p in flow.parameters())
    lw = state.buffer_state.log_w
    assert int(torch.isfinite(lw).sum()) > 0 and not torch.isnan(lw).any()
    check = make_realnvp(DIM, LAYERS, NODES_PER_DIM, fused=False, generator=gen,
                        device=device)
    check.load_state_dict(flow.state_dict())
    rows = state.buffer_state.x[torch.isfinite(lw)][:256]
    with torch.no_grad():
        lq_fused, lq_plain = flow.log_prob(rows), check.log_prob(rows)
    torch.testing.assert_close(lq_fused, lq_plain, atol=1e-3, rtol=1e-4)
    steady = statistics.median(step_ms[1:])
    print(f"[{card}] ManyWell-32 FAB+buffer train step: median {steady:.1f} ms "
          f"over steps 2-{N_STEPS} (all: {', '.join(f'{t:.1f}' for t in step_ms)}), "
          f"{BATCH / steady * 1e3:.1f} AIS samples/s; init_state {init_s:.2f} s")

    # -------------------------------------- 4. where one step's time goes
    # The AIS pass alone (the rest of a step is the buffer and the replay steps),
    # then one more step under torch.profiler: device busy time is the sum of the
    # device-side events only (one stream, so they do not overlap; the host ops
    # that launched them would count the same time twice) against the wall time.
    torch.cuda.synchronize()
    t0 = time.time()
    model.ais.sample_and_log_weights(state.transition_state, gen, BATCH, p_target=False,
                                     tune=False)
    torch.cuda.synchronize()
    ais_ms = (time.time() - t0) * 1e3
    print(f"[{card}] AIS pass alone: {ais_ms:.1f} ms ({ais_ms / steady:.1%} of the "
          f"median step)")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.time()
        state, info = trainer.train_step(state, gen, BATCH)
        torch.cuda.synchronize()
        prof_step_ms = (time.time() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    assert n_kernels > 0, "the profiler saw no device work"
    print(f"[{card}] profiled step: wall {prof_step_ms:.1f} ms (profiler on), device "
          f"busy {busy_ms:.1f} ms ({busy_ms / prof_step_ms:.1%} of the profiled wall, "
          f"{busy_ms / steady:.1%} of the median step), {n_kernels} device ops")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")

    # ---------------------------------------------------------------- 5. timing
    L, d_cond, H = operands[True][0].shape
    n_last = 2 * (DIM - d_cond)
    flops = 2.0 * BATCH * L * (d_cond * H + H * H + H * n_last + DIM * DIM)
    n_weights = sum(t.numel() for t in operands[True][:-2]) + L * DIM * DIM + L
    bytes_moved = 4.0 * (2 * BATCH * DIM + BATCH + n_weights)
    peaks = _peaks(name)
    t_ops = flops / peaks["f32_flops"] * 1e3
    t_bytes = bytes_moved / peaks["bytes_per_s"] * 1e3
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
              f"bound {max(t_ops, t_bytes):.4f} ms "
              f"({flops / 1e9:.3f} GFLOP, {bytes_moved / 1e6:.2f} MB)")
    print("library_ms: none - no single PyTorch call computes the fused RealNVP chain")
    kernels = [{
        "name": "fused_realnvp_pass",
        "route": "cuda",
        "source": "fab_tpu_torch/ops/csrc/realnvp_kernel.cu",
        "replaces": "fab_tpu/ops/realnvp_kernel.py:134",
        "launches": main_launches,
        "max_abs_err": max(e[0] for e in errors.values()),
        "ms": timing[True][0],
        "plain_ms": timing[True][1],
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "mode": "inverse (37 of the 38 launches per step)",
        "ms_forward": timing[False][0],
        "plain_ms_forward": timing[False][1],
        "max_abs_err_log_det": max(e[1] for e in errors.values()),
        "step_ms": steady,
        "samples_per_s": BATCH / steady * 1e3,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
