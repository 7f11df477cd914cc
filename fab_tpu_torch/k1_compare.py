"""Time K1 against an earlier K1 source in one process, in turns, at the ManyWell-32
shapes (B=2048, D=32, H=320, L=10), on one CUDA card.

    python3 -m fab_tpu_torch.k1_compare --old-src PATH [--repeats 50] [--rounds 2]

PATH is an earlier K1 CUDA source, built like any kernel source (``ops/build.py``),
with either C interface in the repository's history: the Hopper kernel's
(``realnvp_set_encoder`` and ``fused_realnvp_pass_f32`` as this source has them,
``git show 26761ad:fab_tpu_torch/ops/csrc/realnvp_kernel.cu``), launched through
this wrapper, or the f32-FMA kernel's, whose ``fused_realnvp_pass_f32`` takes
(x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, y, ld, B, D, dc, H, L, inverse, threads,
stream) (``git show 0953cb5:fab_tpu_torch/ops/csrc/realnvp_kernel.cu``).

Per mode (forward, inverse) and round the order is old, new, cluster1, cluster4,
cluster4, cluster1, new, old: "new" is K1 as the port launches it (clusters of 2
blocks sharing one weight stream), "cluster1" and "cluster4" the same source built
with ``-DK1_CLUSTER=1`` (no sharing) and ``=4``. Each time is CUDA events around
``--repeats`` calls after a warm-up call. Every kernel is held against the plain
version on the same inputs first, and all are compared with the plain version in
float64. The plain version is timed in the same process. Prints the card line and
one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess

import torch

from fab_tpu_torch.flows import make_realnvp
from fab_tpu_torch.flows.fused import _stack_params
from fab_tpu_torch.k2_compare import time_ms
from fab_tpu_torch.ops import build as build_lib
from fab_tpu_torch.ops import realnvp_kernel as rk

DIM, LAYERS, NODES, BATCH = 32, 10, 10, 2048
KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "wlin", "lu_ld")


def _old_kernel(src: pathlib.Path):
    """The earlier source's launch function, (x, *operands, inverse) -> (y, ld)."""
    if "realnvp_set_encoder" in src.read_text():  # the Hopper kernel's interface
        lib = rk.load_library(build_lib.build(src))
        return lambda x, *ops: rk.launch_kernel(x, *ops, lib=lib)
    lib = ctypes.CDLL(str(build_lib.build(src)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_realnvp_pass_f32.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
    lib.fused_realnvp_pass_f32.restype = i32
    return lambda x, *ops: _fma_pass(lib, x, *ops)


def _fma_pass(lib, x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, inverse):
    B, D = x.shape
    L, dc, H = w1.shape
    y = torch.empty_like(x)
    ld = torch.empty((B,), dtype=x.dtype, device=x.device)
    threads = min(1024, (max(H, 2 * (D - dc), 32) + 31) // 32 * 32)
    err = lib.fused_realnvp_pass_f32(
        *(t.data_ptr() for t in (x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, y, ld)),
        B, D, dc, H, L, int(inverse), threads, torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"the earlier K1 failed to launch: error {err}")
    return y, ld


def _cluster_library(cluster: int) -> ctypes.CDLL:
    """K1's source built with clusters of ``cluster`` blocks, through a one-line
    source in the (gitignored) build directory that includes it."""
    build_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build_lib.BUILD_DIR / f"k1_cluster{cluster}.cu"
    src.write_text(f'#define K1_CLUSTER {cluster}\n#include "{rk.SRC.resolve()}"\n')
    return rk.load_library(build_lib.build(src))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-src", type=pathlib.Path, required=True)
    parser.add_argument("--repeats", type=int, default=50)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_compare: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    old = _old_kernel(args.old_src)
    variants = {c: _cluster_library(c) for c in (1, 4)}

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    flow = make_realnvp(DIM, LAYERS, NODES, fused=True, generator=gen, device=device)
    with torch.no_grad():
        for p in flow.parameters():  # the coupling's last layer starts at zero
            p.add_(0.005 * torch.randn(p.shape, generator=gen, device=device))
    x = torch.randn(BATCH, DIM, generator=gen, device=device)
    result = {"card": card, "repeats": args.repeats, "rounds": args.rounds}
    with torch.no_grad():
        for inverse in (False, True):
            mode = "inverse" if inverse else "forward"
            s = _stack_params(flow, inverse)
            ops = [s[k].contiguous() for k in KEYS]
            kernels = {
                "old": lambda: old(x, *ops, inverse),
                "new": lambda: rk.launch_kernel(x, *ops, inverse),
                "cluster1": lambda: rk.launch_kernel(x, *ops, inverse, lib=variants[1]),
                "cluster4": lambda: rk.launch_kernel(x, *ops, inverse, lib=variants[4]),
            }
            y_ref, ld_ref = rk.fused_realnvp_pass_reference(x, *ops, inverse)
            y64, _ = rk.fused_realnvp_pass_reference(x.double(), *(t.double() for t in ops),
                                                     inverse)
            result[f"plain_{mode}_max_abs_err_f64"] = float((y_ref.double() - y64).abs().max())
            for label, fn in kernels.items():
                y, ld = fn()
                torch.cuda.synchronize()
                torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
                torch.testing.assert_close(ld, ld_ref, atol=1e-3, rtol=0)
                result[f"{label}_{mode}_max_abs_err"] = float((y - y_ref).abs().max())
                result[f"{label}_{mode}_max_abs_err_f64"] = float((y.double() - y64).abs().max())
            print(f"[{card}] K1 {mode}: max|y - float64 version|: new "
                  f"{result[f'new_{mode}_max_abs_err_f64']:.3e}, earlier "
                  f"{result[f'old_{mode}_max_abs_err_f64']:.3e}, plain f32 "
                  f"{result[f'plain_{mode}_max_abs_err_f64']:.3e}")
            times = {label: [] for label in kernels}
            for _ in range(args.rounds):
                for label in ("old", "new", "cluster1", "cluster4",
                              "cluster4", "cluster1", "new", "old"):
                    times[label].append(time_ms(kernels[label], args.repeats))
            for label, ts in times.items():
                result[f"{label}_{mode}_ms"] = statistics.mean(ts)
                result[f"{label}_{mode}_ms_all"] = ts
            result[f"speedup_{mode}"] = result[f"old_{mode}_ms"] / result[f"new_{mode}_ms"]
            result[f"plain_{mode}_ms"] = time_ms(
                lambda: rk.fused_realnvp_pass_reference(x, *ops, inverse), args.repeats
            )
            print(f"[{card}] K1 {mode}: new {result[f'new_{mode}_ms']:.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times['new'])}), earlier "
                  f"{result[f'old_{mode}_ms']:.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times['old'])}): "
                  f"{result[f'speedup_{mode}']:.2f}x; clusters of 1 "
                  f"{result[f'cluster1_{mode}_ms']:.4f} ms, of 4 "
                  f"{result[f'cluster4_{mode}_ms']:.4f} ms; plain "
                  f"{result[f'plain_{mode}_ms']:.4f} ms")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
