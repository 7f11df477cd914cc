"""Time K2 against an earlier K2 source in one process, in turns, at the LGCP-1600
shapes (B=512, D=1600, H=3200, scale cap 5), on one CUDA card.

    python3 -m fab_tpu_torch.k2_compare --old-src PATH [--repeats 50] [--rounds 2]

PATH is a K2 CUDA source with the earlier C interface: ``fused_coupling_apply_f32``
taking the weights as stored ([K, N]) and the workspaces h1, h2 [B, H] and partial
[B, coupling_partial_tiles(d_trans)], as the SIMT kernel in the repository's history
does (``git show <commit>:fab_tpu_torch/ops/csrc/coupling_kernel.cu``). It is built
like any kernel source (``ops/build.py``).

Per mode (forward, inverse) and round the order is old, new, new, old; each time is
CUDA events around ``--repeats`` calls after a warm-up call. Both kernels are held
against the plain version on the same inputs first, and all three are compared with
the plain version in float64. The plain version, the three
cuBLAS f32 GEMMs (a yardstick K2 never calls) and the rebuild of one coupling's
prepared weights are timed in the same process. Prints the card line and one JSON
line.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import pathlib
import statistics
import subprocess

import torch

from fab_tpu_torch.flows import LargeFusedCoupling
from fab_tpu_torch.ops import build as build_lib
from fab_tpu_torch.ops import coupling_kernel as ck

DIM, WIDTH, BATCH, CAP = 1600, 3200, 512, 5.0


def _old_library(src: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_lib.build(src)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_coupling_apply_f32.argtypes = (
        [ptr] * 13 + [i32] * 5 + [ctypes.c_float, i32, ptr]
    )
    lib.fused_coupling_apply_f32.restype = i32
    lib.coupling_partial_tiles.argtypes = [i32]
    lib.coupling_partial_tiles.restype = i32
    return lib


def _old_apply(lib, zc, zt, w1, b1, w2, b2, w3p, b3p, cap, inverse):
    B, dc = zc.shape
    dt, H, P = zt.shape[1], w1.shape[1], w3p.shape[1]
    empty = functools.partial(torch.empty, dtype=torch.float32, device=zc.device)
    y, log_det = empty((B, dt)), empty((B,))
    h1, h2 = empty((B, H)), empty((B, H))
    partial = empty((B, lib.coupling_partial_tiles(dt)))
    err = lib.fused_coupling_apply_f32(
        *(t.data_ptr() for t in (zc, zt, w1, b1, w2, b2, w3p, b3p, y, log_det, h1, h2,
                                 partial)),
        B, dc, dt, H, P, float(cap), int(inverse),
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"the earlier K2 failed to launch: error {err}")
    return y, log_det


def time_ms(fn, n: int) -> float:
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-src", type=pathlib.Path, required=True)
    parser.add_argument("--repeats", type=int, default=50)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_compare: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    old = _old_library(args.old_src)
    ck._library()

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    layer = LargeFusedCoupling(DIM, WIDTH, scale_cap=CAP, device=device)
    layer.reset_parameters(gen)
    with torch.no_grad():
        for p in layer.parameters():  # the last layer starts at zero
            p.add_(0.01 * torch.randn(p.shape, generator=gen, device=device))
        layer.mlp[-1].w[:, 2 * layer.d_trans:] = 0.0
        layer.mlp[-1].b[2 * layer.d_trans:] = 0.0
    x = torch.randn(BATCH, DIM, generator=gen, device=device)
    zc, zt = (t.contiguous() for t in layer._split(x))
    weights = [t for d in layer.mlp for t in (d.w, d.b)]
    dt, H = zt.shape[1], WIDTH
    kernels = {
        "old": lambda inv: _old_apply(old, zc, zt, *weights, CAP, inv),
        "new": lambda inv: ck.fused_coupling_apply(zc, zt, *weights, CAP, inv),
    }
    result = {"card": card, "repeats": args.repeats, "rounds": args.rounds}
    with torch.no_grad():
        for inverse in (False, True):
            mode = "inverse" if inverse else "forward"
            y_ref, ld_ref = ck.fused_coupling_apply_reference(zc, zt, *weights, CAP, inverse)
            y64, _ = ck.fused_coupling_apply_reference(
                *(t.double() for t in (zc, zt, *weights)), CAP, inverse
            )
            result[f"plain_{mode}_max_abs_err_f64"] = float((y_ref.double() - y64).abs().max())
            for label, fn in kernels.items():
                y, ld = fn(inverse)
                torch.cuda.synchronize()
                torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
                torch.testing.assert_close(ld, ld_ref, atol=2e-3, rtol=0)
                result[f"{label}_{mode}_max_abs_err"] = float((y - y_ref).abs().max())
                result[f"{label}_{mode}_max_abs_err_f64"] = float((y.double() - y64).abs().max())
            print(f"[{card}] K2 {mode}: max|y - float64 version|: new "
                  f"{result[f'new_{mode}_max_abs_err_f64']:.3e}, earlier "
                  f"{result[f'old_{mode}_max_abs_err_f64']:.3e}, plain f32 "
                  f"{result[f'plain_{mode}_max_abs_err_f64']:.3e}")
            times = {"old": [], "new": []}
            for _ in range(args.rounds):
                for label in ("old", "new", "new", "old"):
                    times[label].append(time_ms(lambda: kernels[label](inverse), args.repeats))
            for label, ts in times.items():
                result[f"{label}_{mode}_ms"] = statistics.mean(ts)
                result[f"{label}_{mode}_ms_all"] = ts
            result[f"speedup_{mode}"] = result[f"old_{mode}_ms"] / result[f"new_{mode}_ms"]
            result[f"plain_{mode}_ms"] = time_ms(
                lambda: ck.fused_coupling_apply_reference(zc, zt, *weights, CAP, inverse),
                args.repeats,
            )
            print(f"[{card}] K2 {mode}: new {result[f'new_{mode}_ms']:.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times['new'])}), earlier "
                  f"{result[f'old_{mode}_ms']:.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times['old'])}): "
                  f"{result[f'speedup_{mode}']:.2f}x; plain {result[f'plain_{mode}_ms']:.4f} ms")
        w1, w2, w3p = weights[0], weights[2], weights[4][:, : 2 * dt]
        h1 = torch.relu(zc @ w1)
        h2 = torch.relu(h1 @ w2)
        result["library_ms"] = time_ms(lambda: (zc @ w1, h1 @ w2, h2 @ w3p), args.repeats)
        result["rebuild_ms_per_coupling"] = time_ms(
            lambda: [ck.prepare_weight_on_card(w, n) for w, n in
                     ((weights[0], H), (weights[2], H), (weights[4], 2 * dt))],
            args.repeats,
        )
    print(f"[{card}] 3 x cuBLAS f32 GEMM (yardstick): {result['library_ms']:.4f} ms; "
          f"prepared-weight rebuild of one coupling: {result['rebuild_ms_per_coupling']:.4f} ms")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
