"""K1: the fused RealNVP chain (forward or inverse) with its log-det.

Replaces the Pallas TPU kernel ``fab_tpu/ops/realnvp_kernel.py:fused_realnvp_pass``
(``pallas_call`` at line 134, body ``_kernel``). The CUDA source is
``csrc/realnvp_kernel.cu``; its header says what bounds the kernel on an H100
(tensor-core operations: 3 x 4.865 GFLOP of TF32 per pass at B=2048, D=32, H=320,
L=10, 0.0295 ms at 495 TFLOP/s) and the design: 3xTF32 ``mma.sync`` products on
16-row tiles, weights streamed by TMA through an mbarrier ring and shared by
multicast across a cluster of 2 blocks, activations kept in shared memory.

- ``fused_realnvp_pass`` launches the kernel for CUDA tensors and takes the plain
  PyTorch version, ``fused_realnvp_pass_reference``, only for CPU tensors. The
  kernel computes in f32 and casts back, as the TPU kernel does; the plain version
  computes in the input dtype. ``fused_realnvp_pass.launches`` counts launches.
- ``plan_launch`` is the CPU mirror of the library's launch (blocks, clusters, ring
  slots, shared memory, and L2 reads reckoned from the shapes): it gives the shape
  the kernel runs at and refuses a shape the kernel cannot take. TMA reads rows
  whose byte strides are multiples of 16, so the kernel takes D a multiple of 4 and
  an even d_trans and H a multiple of 4; a shape that misses only that is zero-padded
  by the wrapper (``_embed``: exact, the padded entries stay zero). Any width runs
  whose 16 rows of activations fit in shared memory beside a ring of 2 slots (each
  ring stage is at most 32 deep and 320 wide); a wider one raises.
- ``fused_realnvp_pass_tf32x3_emulated`` repeats the kernel's arithmetic (splits
  and order of sums) in plain PyTorch for the CPU tests; the main path never calls
  it.

The library is built with ``nvcc`` at first use into ``_build/`` (gitignored, see
``build.py``) and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import Tuple

import torch

from fab_tpu_torch.ops import build as build_lib
from fab_tpu_torch.ops.tf32x3 import matmul_tf32x3, matmul_tf32x3_staged, split_tf32

SRC = build_lib.CSRC / "realnvp_kernel.cu"

ROWS = 16  # batch rows per block: one m16 tile
CLUSTER = 2  # blocks that share one weight stream (K1_CLUSTER in the source)
CONSUMER_WARPS = 8
MAX_SLOTS = 4
MAX_SMEM = 232448  # bytes of shared memory a block can have on an H100
_BOX = 32  # columns of a TMA box: one 128-byte swizzle row
GROUP = 8 * 5 * CONSUMER_WARPS  # 320: columns of H per group (5 tiles per warp)
_MAX_BOX_ROWS = 256  # TMA's largest box dimension


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one K1 launch is laid out (``csrc/realnvp_kernel.cu``)."""

    D: int  # the shape the kernel runs at: the caller's, zero-padded for TMA
    d_cond: int
    H: int
    blocks: int  # ceil(B / 16) rounded up to whole clusters
    clusters: int
    padded_rows: int  # rows of the last tiles past B: zero, never stored
    h_pad: int  # H rounded up to 32 (TMA zero-fills the columns past H)
    groups: int  # 320-column groups of H (and 320-deep chunks of W3)
    d_cond_pad: int  # d_cond rounded up to 8: W1's depth in 8-deep steps
    n3_pad: int  # 2 * d_trans rounded up to 8
    z_stride: int  # floats per row of z in shared memory: D rounded up to 32, plus 8
    # One layer's ring stages in the order the kernel takes them on the forward
    # pass (the inverse takes Wlin first): (weight, boxes, rows per box).
    stages: Tuple[Tuple[str, int, int], ...]
    slot_bytes: int
    slots: int
    smem_bytes: int
    tma_bytes_per_pass: int  # one weight stream, boxes as loaded (with zero fill)
    # Reckoned from the shapes, not measured: every cluster's weight stream plus
    # each block's biases and lu_ld, and the same with one stream per block.
    l2_read_bytes: int
    l2_read_bytes_unshared: int

    @property
    def stages_per_layer(self) -> int:
        return len(self.stages)


def plan_launch(B: int, D: int, d_cond: int, H: int, L: int) -> LaunchPlan:
    """The launch the kernel makes for these shapes, or a ValueError that says why
    it cannot take them."""
    if not 0 < d_cond < D:
        raise ValueError(f"fused_realnvp_pass: d_cond={d_cond} must lie in (0, {D})")
    if B < 1 or L < 1 or H < 1:
        raise ValueError(f"fused_realnvp_pass: B={B}, H={H}, L={L}")
    # Zero padding for TMA's 16-byte strides: d_trans to even, D to a multiple of 4
    # (d_cond to even first, then d_trans by 2 more), H to a multiple of 4.
    dc, dt = _round_up(d_cond, 2), _round_up(D - d_cond, 2)
    dt += (dc + dt) % 4
    Dk, Hk = dc + dt, _round_up(H, 4)
    h_pad = _round_up(Hk, _BOX)
    cbs = h_pad // _BOX
    group_boxes = GROUP // _BOX
    groups = -(-cbs // group_boxes)
    widths = [min(group_boxes, cbs - group_boxes * g) for g in range(groups)]
    r1, rl = _round_up(dc, 8), _round_up(Dk, 8)
    n3_pad = _round_up(2 * dt, 8)
    wl_boxes = -(-Dk // _BOX)
    stages = (
        [("w1", n, min(r1, _BOX)) for n in widths for _ in range(-(-r1 // _BOX))]
        + [("w2", n, _BOX) for n in widths for _ in range(cbs)]
        + [("w3", n, _BOX) for _ in range(-(-n3_pad // _BOX)) for n in widths]
        + [("wlin", wl_boxes, rl)]
    )
    z_stride = _round_up(Dk, _BOX) + 8
    sh = h_pad + 8
    h1_floats = max(ROWS * sh, CONSUMER_WARPS * ROWS * n3_pad)
    h2_floats = ROWS * max(sh, n3_pad)
    slot_bytes = max(min(cbs, group_boxes) * _BOX * 4 * _BOX, wl_boxes * rl * 4 * _BOX)
    fixed = 1024 + 4 * (2 * ROWS * z_stride + h1_floats + h2_floats)
    slots = min(MAX_SLOTS, (MAX_SMEM - fixed) // (slot_bytes + 16))
    if slots < 2 or rl > _MAX_BOX_ROWS:
        raise ValueError(
            f"fused_realnvp_pass: at D={D}, d_cond={d_cond}, H={H} the 16 rows' "
            f"activations ({fixed} B) and a ring of 2 slots of {slot_bytes} B exceed the "
            f"{MAX_SMEM} bytes of shared memory a block can have"
        )
    blocks = _round_up(-(-B // ROWS), CLUSTER)
    tma = L * sum(n * rows * 4 * _BOX for _, n, rows in stages)
    biases = 4 * L * (2 * Hk + 2 * dt + 1)
    return LaunchPlan(
        D=Dk, d_cond=dc, H=Hk, blocks=blocks, clusters=blocks // CLUSTER,
        padded_rows=blocks * ROWS - B, h_pad=h_pad, groups=groups, d_cond_pad=r1,
        n3_pad=n3_pad, z_stride=z_stride, stages=tuple(stages), slot_bytes=slot_bytes,
        slots=slots, smem_bytes=fixed + slots * (slot_bytes + 16), tma_bytes_per_pass=tma,
        l2_read_bytes=blocks // CLUSTER * tma + blocks * biases,
        l2_read_bytes_unshared=blocks * (tma + biases),
    )


def _embed(plan: LaunchPlan, x, w1, b1, w2, b2, w3, b3, wlin, lu_ld):
    """The operands zero-padded to the kernel's shape, and the columns of its y that
    are the caller's. z's columns [0, d_cond) stay put and [d_cond, D) move to
    [plan.d_cond, plan.d_cond + d_trans); every padded weight row and column is zero,
    so a padded column of z stays zero (shift and log_scale 0, a zero row of Wlin)
    and adds nothing to the log-det: the result is exact."""
    B, D = x.shape
    L, d_cond, H = w1.shape
    d_trans, dt = D - d_cond, plan.D - plan.d_cond
    keep = torch.cat([torch.arange(d_cond), plan.d_cond + torch.arange(d_trans)]).to(x.device)
    pairs = torch.cat([torch.arange(d_trans), dt + torch.arange(d_trans)]).to(x.device)

    def pad(t, shape, *index):
        out = t.new_zeros(shape)
        out[index] = t
        return out

    every = slice(None)
    return (
        pad(x, (B, plan.D), every, keep),
        pad(w1, (L, plan.d_cond, plan.H), every, slice(0, d_cond), slice(0, H)),
        pad(b1, (L, plan.H), every, slice(0, H)),
        pad(w2, (L, plan.H, plan.H), every, slice(0, H), slice(0, H)),
        pad(b2, (L, plan.H), every, slice(0, H)),
        pad(w3, (L, plan.H, 2 * dt), every, slice(0, H), pairs),
        pad(b3, (L, 2 * dt), every, pairs),
        pad(wlin, (L, plan.D, plan.D), every, keep[:, None], keep[None, :]),
        lu_ld,
    ), keep


def build() -> pathlib.Path:
    """Compile the kernel library (if its sources changed) and return its path."""
    return build_lib.build(SRC)


def load_library(path: pathlib.Path) -> ctypes.CDLL:
    """A built K1 library, ready to launch (``_library`` is this repository's
    source; ``k1_compare`` loads builds of it with other cluster sizes)."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_realnvp_pass_f32.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
    lib.fused_realnvp_pass_f32.restype = i32
    lib.realnvp_set_encoder.argtypes = [ptr]
    lib.realnvp_set_encoder.restype = None
    # The tensor maps are encoded by libcuda's cuTensorMapEncodeTiled; libcuda is
    # already loaded by PyTorch's CUDA runtime.
    libcuda = ctypes.CDLL("libcuda.so.1")
    lib.realnvp_set_encoder(ctypes.cast(libcuda.cuTensorMapEncodeTiled, ctypes.c_void_p))
    lib.realnvp_error_string.argtypes = [i32]
    lib.realnvp_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return load_library(build())


def fused_realnvp_pass_reference(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    w3: torch.Tensor,
    b3: torch.Tensor,
    wlin: torch.Tensor,
    lu_ld: torch.Tensor,
    inverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (``fab_tpu/flows/fused.py:_reference_pass``)."""
    L, d_cond, _ = w1.shape
    d_trans = x.shape[-1] - d_cond
    z = x
    ld = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def coupling(z, l, ld):
        zc, zt = z[:, :d_cond], z[:, d_cond:]
        h = torch.relu(zc @ w1[l] + b1[l])
        h = torch.relu(h @ w2[l] + b2[l])
        o = h @ w3[l] + b3[l]
        shift, log_scale = o[:, :d_trans], o[:, d_trans:]
        if inverse:
            zt = (zt - shift) * torch.exp(-log_scale)
            ld = ld - log_scale.sum(-1)
        else:
            zt = zt * torch.exp(log_scale) + shift
            ld = ld + log_scale.sum(-1)
        return torch.cat([zc, zt], -1), ld

    if inverse:
        for l in range(L - 1, -1, -1):
            z = z @ wlin[l].T
            ld = ld - lu_ld[l, 0]
            z, ld = coupling(z, l, ld)
    else:
        for l in range(L):
            z, ld = coupling(z, l, ld)
            z = z @ wlin[l].T
            ld = ld + lu_ld[l, 0]
    return z, ld


def fused_realnvp_pass(
    x: torch.Tensor,
    w1: torch.Tensor,  # [L, d_cond, H]
    b1: torch.Tensor,  # [L, H]
    w2: torch.Tensor,  # [L, H, H]
    b2: torch.Tensor,  # [L, H]
    w3: torch.Tensor,  # [L, H, 2*d_trans]
    b3: torch.Tensor,  # [L, 2*d_trans]
    wlin: torch.Tensor,  # [L, D, D]: W forward, W^-1 inverse
    lu_ld: torch.Tensor,  # [L, 1]: per-layer LU log-det
    inverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass through the whole chain. Returns (y [B, D], log_det [B])."""
    if x.device.type == "cpu":
        return fused_realnvp_pass_reference(
            x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, inverse
        )
    out = launch_kernel(x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, inverse)
    fused_realnvp_pass.launches += 1
    return out


fused_realnvp_pass.launches = 0


def launch_kernel(x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, inverse, lib=None):
    """The kernel on CUDA tensors, uncounted (``lib``: another build of the source,
    for ``k1_compare``)."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_realnvp_pass: unsupported device {x.device}")
    operands = (x, w1, b1, w2, b2, w3, b3, wlin, lu_ld)
    if any(t.device != x.device for t in operands):
        raise ValueError("fused_realnvp_pass: all operands must be on one device")
    if any(not t.is_floating_point() for t in operands):
        raise TypeError("fused_realnvp_pass: operands must be floating point")
    if x.dim() != 2:
        raise ValueError(f"fused_realnvp_pass: x must be [B, D], got {tuple(x.shape)}")
    B, D = x.shape
    L, d_cond, H = w1.shape
    n_last = 2 * (D - d_cond)
    expected = {
        "b1": (L, H), "w2": (L, H, H), "b2": (L, H), "w3": (L, H, n_last),
        "b3": (L, n_last), "wlin": (L, D, D), "lu_ld": (L, 1),
    }
    given = {"b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3, "wlin": wlin,
             "lu_ld": lu_ld}
    for name, shape in expected.items():
        if tuple(given[name].shape) != shape:
            raise ValueError(
                f"fused_realnvp_pass: {name} has shape {tuple(given[name].shape)}, "
                f"expected {shape}"
            )
    plan = plan_launch(max(B, 1), D, d_cond, H, L)
    if B == 0:
        return torch.empty_like(x), x.new_empty((0,))
    # The kernel computes in f32 and casts back (realnvp_kernel.py:115,147). TMA
    # reads the weights from 16-byte aligned addresses: a view off that is copied.
    f32 = [t.to(torch.float32).contiguous() for t in operands]
    keep = None
    if (plan.D, plan.d_cond, plan.H) != (D, d_cond, H):
        f32, keep = _embed(plan, *f32)
    f32 = [t.clone() if t.data_ptr() % 16 else t for t in f32]
    y = torch.empty((B, plan.D), dtype=torch.float32, device=x.device)
    ld = torch.empty((B,), dtype=torch.float32, device=x.device)
    lib = lib or _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_realnvp_pass_f32(
            *(t.data_ptr() for t in f32),
            y.data_ptr(),
            ld.data_ptr(),
            B, plan.D, plan.d_cond, plan.H, L, int(inverse), stream,
        )
    if err != 0:
        raise RuntimeError(
            "fused_realnvp_pass launch failed: "
            + lib.realnvp_error_string(err).decode()
        )
    if keep is not None:
        y = y[:, keep]
    return y.to(x.dtype), ld.to(x.dtype)


def _w3_step_ranges(h_pad: int):
    """For each consumer warp, the 8-deep steps of W3's product it sums, one slice of
    each 320-deep chunk of the depth (one ring stage): [w n / 8, (w + 1) n / 8) of a
    chunk's n steps."""
    steps, chunk = h_pad // 8, GROUP // 8
    return [
        [(s0 + w * n // CONSUMER_WARPS, s0 + (w + 1) * n // CONSUMER_WARPS)
         for s0, n in ((s0, min(chunk, steps - s0)) for s0 in range(0, steps, chunk))]
        for w in range(CONSUMER_WARPS)
    ]


def fused_realnvp_pass_tf32x3_emulated(
    x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, inverse
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch (float32), in its stage order: every
    product of the coupling MLP in 3xTF32 from hi/lo splits; W1's and W2's depth in
    32-deep stages summed apart and added in order (a column's sum does not depend on
    its 320-column group); W3's depth in the consumer warps' slices of each 320-deep
    chunk, a warp's chunk sums added in chunk order and the warps' partials in warp
    order after the bias; the LU mix in f32. The tensor cores' own order of sums
    inside a step is not repeated."""
    f = lambda t: t.to(torch.float32)
    x, w1, b1, w2, b2, w3, b3, wlin, lu_ld = map(f, (x, w1, b1, w2, b2, w3, b3, wlin, lu_ld))
    L, d_cond, H = w1.shape
    d_trans = x.shape[-1] - d_cond
    ranges = _w3_step_ranges(_round_up(H, _BOX))

    def product(a, w):  # a [B, K] @ w [K, N] as one 3xTF32 sum
        return matmul_tf32x3(split_tf32(a), split_tf32(w.T.contiguous()))

    def coupling(z, l, ld):
        zc, zt = z[:, :d_cond], z[:, d_cond:]
        h = torch.relu(matmul_tf32x3_staged(zc, w1[l], _BOX) + b1[l])
        h = torch.relu(matmul_tf32x3_staged(h, w2[l], _BOX) + b2[l])
        o = b3[l].expand(x.shape[0], -1)
        for mine in ranges:
            total = None
            for s0, s1 in mine:
                part = product(h[:, 8 * s0:8 * s1], w3[l, 8 * s0:8 * s1])
                total = part if total is None else total + part
            o = o + total
        shift, log_scale = o[:, :d_trans], o[:, d_trans:]
        if inverse:
            return torch.cat([zc, (zt - shift) * torch.exp(-log_scale)], -1), ld - log_scale.sum(-1)
        return torch.cat([zc, zt * torch.exp(log_scale) + shift], -1), ld + log_scale.sum(-1)

    z, ld = x, torch.zeros(x.shape[0], device=x.device)
    for l in (range(L - 1, -1, -1) if inverse else range(L)):
        if inverse:
            z, ld = z @ wlin[l].T, ld - lu_ld[l, 0]
        z, ld = coupling(z, l, ld)
        if not inverse:
            z, ld = z @ wlin[l].T, ld + lu_ld[l, 0]
    return z, ld
