"""K2, the large-dim fused coupling kernel, against the plain coupling at LGCP-1600
shapes (``experiments/bench_lgcp_kernel.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.bench_lgcp_kernel [--batch 512] [--dim 1600]
        [--nodes-per-dim 2] [--layers 8] [--repeats 20] [--rounds 2] [--device cpu]

(a) One ``LargeFusedCoupling`` (B = 512, D = 1600, H = 3200, scale cap 5) with its
last layer set to 0.01 N(0, 1) on the columns K2 reads (the 128-column pad stays
zero): K2 against ``AffineCoupling``'s plain pass on the same parameters (largest
error below 1e-3, as the repository's script asserts), then forward and inverse of
each timed with CUDA events (``--repeats`` calls after 3 warm-up calls). Prints the
FLOP and weight-byte reckoning of ``bench_lgcp_kernel.py:82-89``, and K2's time
against the least time of its work in 3xTF32 on the tensor cores (products x 3 over
the dense TF32 peak, or the bytes it must move over the memory rate, whichever is
larger; NVIDIA's H100 data sheet).

(b) The whole LGCP flow (RealNVP ``--layers`` x [coupling, width D x nodes, cap 5;
LU]): ``sample_and_log_prob`` and ``log_prob`` with ``fused_coupling`` off and on,
timed in turns over ``--rounds`` rounds (median per entry). The fused flow must launch
K2 on the card (counted).

On the CPU (``--device cpu``) K2's wrapper takes its plain version: the run checks
the script, not the kernel, and the times are the CPU's. The last stdout line is one
JSON object of the figures.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows import LargeFusedCoupling, make_realnvp
from fab_tpu_torch.flows.coupling import AffineCoupling
from fab_tpu_torch.ops import coupling_kernel

# Dense TF32 tensor-core peak and memory rate (NVIDIA's H100 data sheet).
H100_PEAKS = {"sxm": (495e12, 3.35e12), "pcie": (378e12, 2.0e12)}


def time_ms(fn, n: int, device: torch.device, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``n`` calls after ``warmup`` calls: CUDA events on the
    card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n


def tf32x3_bound_ms(B: int, dc: int, dt: int, H: int, device: torch.device):
    """(bound ms, what bounds it) of one K2 call on an H100: 3 TF32 products per
    product over the tensor cores' peak, or each input read once and each output
    written once over the memory rate; None off an H100."""
    if device.type != "cuda" or "H100" not in torch.cuda.get_device_name(device):
        return None
    name = torch.cuda.get_device_name(device).lower()
    tf32, rate = H100_PEAKS["pcie" if "pcie" in name else "sxm"]
    flops = 2.0 * B * (dc * H + H * H + H * 2 * dt)
    bytes_moved = 4.0 * (B * dc + B * dt + dc * H + H + H * H + H + H * 2 * dt + 2 * dt
                         + B * dt + B)
    t_ops, t_bytes = 3 * flops / tf32 * 1e3, bytes_moved / rate * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def layer_bench(args, device, generator) -> dict:
    dim, B = args.dim, args.batch
    width = dim * args.nodes_per_dim
    layer = LargeFusedCoupling(dim, width, scale_cap=5.0, device=device)
    layer.reset_parameters(generator)
    last = layer.mlp[-1]
    with torch.no_grad():
        cols = 2 * layer.d_trans
        last.w[:, :cols] = 0.01 * torch.randn(last.w.shape[0], cols, generator=generator,
                                              device=device)
    z = torch.randn(B, dim, generator=generator, device=device)
    modes = {
        "fwd": (layer.forward_and_log_det,
                lambda x: AffineCoupling.forward_and_log_det(layer, x)),
        "inv": (layer.inverse_and_log_det,
                lambda x: AffineCoupling.inverse_and_log_det(layer, x)),
    }
    out = {}
    with torch.no_grad():
        for mode, (kernel, plain) in modes.items():
            before = coupling_kernel.fused_coupling_apply.launches
            (y_k, ld_k), (y_p, ld_p) = kernel(z), plain(z)
            if device.type == "cuda" and coupling_kernel.fused_coupling_apply.launches == before:
                raise RuntimeError("the fused coupling did not launch K2 on the card")
            err = float((y_k - y_p).abs().max())
            err_ld = float((ld_k - ld_p).abs().max())
            print(f"single-layer {mode} correctness: max err {err:.3e} (log-det {err_ld:.3e})")
            assert err < 1e-3, f"K2 {mode} is {err:.3e} off the plain coupling"
            t_k = time_ms(lambda: kernel(z), args.repeats, device)
            t_p = time_ms(lambda: plain(z), args.repeats, device)
            print(f"layer {mode}: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  speedup "
                  f"{t_p / t_k:.2f}x")
            out[mode] = {"max_abs_err": err, "max_abs_err_log_det": err_ld,
                         "kernel_ms": t_k, "plain_ms": t_p}
    flops = 2 * B * (dim // 2) * width + 2 * B * width * width + 2 * B * width * (dim + 128)
    wbytes = 4 * ((dim // 2) * width + width * width + width * (dim + 128))
    t_k = out["fwd"]["kernel_ms"] / 1e3
    print(f"per-layer: {flops / 1e9:.1f} GFLOP, weights {wbytes / 1e6:.1f} MB "
          "(bench_lgcp_kernel.py:82-89's reckoning); kernel achieves "
          f"{flops / t_k / 1e12:.2f} TFLOP/s, weight-stream {wbytes / t_k / 1e9:.1f} GB/s")
    bound = tf32x3_bound_ms(B, layer.d_cond, layer.d_trans, width, device)
    if bound is not None:
        out["bound_ms"], out["bound_by"] = bound
        print(f"3xTF32 bound {bound[0]:.4f} ms ({bound[1]}): kernel at "
              f"{bound[0] / out['fwd']['kernel_ms']:.1%} (forward), "
              f"{bound[0] / out['inv']['kernel_ms']:.1%} (inverse)")
    return out


def flow_bench(args, device) -> dict:
    dim, B = args.dim, args.batch
    flows = {
        fused: make_realnvp(dim, args.layers, args.nodes_per_dim, scale_cap=5.0,
                            fused_coupling=fused,
                            generator=torch.Generator(device=device).manual_seed(3),
                            device=device)
        for fused in (False, True)
    }
    generator = torch.Generator(device=device).manual_seed(0)
    times = {fused: {"sample_and_log_prob": [], "log_prob": []} for fused in flows}
    launches = {}
    with torch.no_grad():
        x = {fused: flow.sample_and_log_prob(B, generator)[0] for fused, flow in flows.items()}
        for r in range(args.rounds):
            for fused in ((False, True) if r % 2 == 0 else (True, False)):
                flow = flows[fused]
                before = coupling_kernel.fused_coupling_apply.launches
                flow.sample_and_log_prob(B, generator)
                launches[fused] = coupling_kernel.fused_coupling_apply.launches - before
                times[fused]["sample_and_log_prob"].append(time_ms(
                    lambda: flow.sample_and_log_prob(B, generator), args.repeats, device))
                times[fused]["log_prob"].append(time_ms(
                    lambda: flow.log_prob(x[fused]), args.repeats, device))
    if device.type == "cuda" and launches[True] != args.layers:
        raise RuntimeError(f"the fused flow launched K2 {launches[True]} times per pass, "
                           f"not {args.layers}")
    out = {}
    for fused in flows:
        med = {k: statistics.median(v) for k, v in times[fused].items()}
        out["fused" if fused else "plain"] = dict(med, k2_launches_per_pass=launches[fused])
        print(f"flow fused_coupling={fused}: sample_and_log_prob "
              f"{med['sample_and_log_prob']:.2f} ms, log_prob {med['log_prob']:.2f} ms   "
              f"[{B / med['sample_and_log_prob'] * 1e3:.0f} samples/s]; K2 launches per "
              f"pass {launches[fused]}")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--dim", type=int, default=1600)
    p.add_argument("--nodes-per-dim", type=int, default=2)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    torch.set_float32_matmul_precision("highest")  # the plain path in f32, no TF32
    generator = torch.Generator(device=device).manual_seed(0)
    result = {"layer": layer_bench(args, device, generator), "flow": flow_bench(args, device),
              "batch": args.batch, "dim": args.dim, "width": args.dim * args.nodes_per_dim,
              "layers": args.layers}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
