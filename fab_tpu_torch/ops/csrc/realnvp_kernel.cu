// Fused RealNVP chain (forward or inverse) with log-det (K1), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fab_tpu/ops/realnvp_kernel.py:fused_realnvp_pass
// (pallas_call at line 134, body `_kernel`). Same function, same operand order and
// layout:
//   x [B, D]; w1 [L, dc, H]; b1 [L, H]; w2 [L, H, H]; b2 [L, H];
//   w3 [L, H, 2*dt]; b3 [L, 2*dt]; wlin [L, D, D]; lu_ld [L]
// with dt = D - dc. Per layer: h1 = relu(zc W1 + b1), h2 = relu(h1 W2 + b2),
// o = h2 W3 + b3 = (shift, log_scale); zt <- zt * exp(ls) + shift (forward) or
// (zt - shift) * exp(-ls) (inverse); then z <- z Wlin^T; log_det +/-= sum(ls) and
// +/- lu_ld. The inverse walks the layers in reverse, LU mix first.
//
// What bounds it, at the ManyWell-32 shapes (B=2048, D=32, dc=dt=16, H=320, L=10):
//   - 4.865 GFLOP per pass, which must keep f32 accuracy (the Pallas kernel runs in
//     f32). In 3xTF32 on the tensor cores (three TF32 products per product, 495
//     TFLOP/s dense) that is 0.0295 ms; in f32 FMAs on the CUDA cores (67 TFLOP/s)
//     0.0726 ms. Device memory: 5.31 MB (x, y, log_det, the weights once), 0.0016 ms
//     at 3.35 TB/s. So operations bound it.
//   - The weights (4.78 MB per pass) do not fit one SM's shared memory: every block
//     streams all of them. With one block per 16 rows that is 128 blocks x 4.78 MB =
//     611 MB of L2 reads per pass, ~1.9 TB/s for a kernel taking 0.325 ms.
//
// Design:
//   - Products run on the tensor cores as `mma.sync.aligned.m16n8k8 ... .tf32` in
//     3xTF32: each operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
//     rounded as cvt.rna.tf32.f32 rounds (tf32_bits), in registers as its fragment
//     is loaded, and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms
//     first. mma.sync and not wgmma: wgmma needs 64-row tiles, so B=2048 would be 32
//     row tiles on 32 of 132 SMs, and those alone need 3 x 4.865 GFLOP / (32 x 3.75
//     TFLOP/s) ~ 0.12 ms. A 16-row m16 tile keeps 128 blocks in one wave.
//   - The tensor cores truncate their f32 sums (see coupling_kernel.cu). Each
//     32-deep stage of W2 is summed from zero on its own and added to the running sum
//     on the CUDA cores, rounded to nearest; a CPU model of truncating accumulation
//     (tf32x3.py:truncating_chain) puts one accumulator over depth 320 at 10x the
//     error of this order. The narrow W3 product splits its depth over the 8
//     consumer warps (<= 40 deep each) and adds their partial sums in warp order.
//   - Weights stream by TMA (`cp.async.bulk.tensor`, 128B swizzle, out-of-bounds
//     rows and columns zero-filled) through a ring of 4 mbarrier-guarded 40 KB slots
//     filled by one producer warp. The stream does not depend on the data: W1, the
//     W2 chunks (32 rows each), W3 and Wlin of each layer, in the order of use, so
//     the producer runs ahead across layer boundaries, gated only by free slots.
//   - Blocks share the stream through a thread-block cluster (2 blocks, each with its
//     own 16 rows): each block loads every other box of a stage with
//     `.multicast::cluster` to both blocks, and a slot is released only when every
//     consumer warp of the cluster has finished with it (each warp arrives on the
//     slot's barrier in every block). L2 reads fall to one weight stream per cluster:
//     64 x 4.75 MB = 304 MB per pass (reckoned from the shapes). Clusters of 4 would
//     halve that again, but they measured twice as slow: 128 blocks of 212 KB in
//     clusters of 4 do not all fit one wave. CLUSTER is fixed at compile time
//     (K1_CLUSTER, default 2); k1_compare.py builds and times other sizes.
//   - A weight tile lands as 32-column boxes, row k of a box 128 bytes with its
//     16-byte chunks XOR-swizzled by k % 8. Fragment k index i of an 8-deep step is
//     mapped to row 2 (i % 4) + i / 4: then a warp's 32 B-fragment loads hit 32
//     banks, and each thread's two A values are neighbours (one 8-byte load). A
//     lane's B offsets are worked out once per phase. Activations (z twice, h1, h2
//     for the block's 16 rows, 47 KB at H=320) stay in shared memory for the whole
//     chain with row strides of 8 mod 32 floats, so their fragment loads and the
//     epilogues' stores are free of bank conflicts.
//   - Bias, ReLU, the affine step, the LU mix (f32 FMAs: 16 x 32 x 32 per layer, into
//     the other z buffer) and the per-row log-det (summed in a fixed order, no
//     atomics: bitwise repeatable) are fused, so nothing but x, the weights, y and
//     log_det touches device memory. Biases, b3 and lu_ld are read a phase ahead.
//   - 8 consumer warps (each owns every 8th 8-column tile of h1 and h2) and one
//     producer warp per block; 212 KB of shared memory at H=320, one block per SM.
//     With 9 warps, 3 share one SM sub-partition's 16K registers: 168 a thread, all
//     of them used, so what is live in W2's products decides whether ptxas spills.
//   - Wide chains run the same code path. Every ring stage is at most 32 deep and
//     320 wide (GROUP: 8 warps x 5 tiles x 8 columns), so the slot size does not grow
//     with H or D: W1 and W2 are streamed per 320-column group of H (the warps keep
//     their 5 tiles and loop over the groups, so the register count stays put), W1 in
//     32-deep stages past d_cond = 32, W3 per 32-column group of 2 dt and per
//     320-deep chunk of H (each chunk's warp partial summed apart and added in chunk
//     order), and z and Wlin over as many 32-column boxes as D needs, z's row stride
//     D rounded up to 32 plus 8 (8 mod 32). Every sum keeps a fixed order.
// Shapes: D % 4 == 0, dt even, H % 4 == 0 (TMA strides are multiples of 16 bytes;
// the wrapper, realnvp_kernel.py, zero-pads a shape that misses only the alignment
// and mirrors this layout in plan_launch), and the 16 rows' activations with a ring
// of at least 2 slots within a block's 227 KB of shared memory (H up to ~1000 at
// D = 32). Ragged rows are zero and never stored.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper_common.cuh"

namespace {

constexpr int ROWS = 16;                      // batch rows per block: one m16 tile
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = CONSUMERS + 32;       // and one producer warp
constexpr int NT_MAX = 5;                     // 8-column tiles per warp and group
constexpr int N3_TILES_MAX = 4;               // 8-column tiles of a W3 column group
constexpr int BOX = 32;                       // box width: one 128-byte swizzle row
constexpr int ROW_BYTES = 4 * BOX;
constexpr int GROUP = 8 * NT_MAX * CONSUMER_WARPS;  // 320: columns of a group of H
constexpr int GROUP_BOXES = GROUP / BOX;
constexpr int MAX_SMEM = 232448;
constexpr int MAX_BOX_ROWS = 256;             // TMA's largest box dimension
constexpr int MAX_SLOTS = 4;
#ifndef K1_CLUSTER
#define K1_CLUSTER 2
#endif
constexpr int CLUSTER = K1_CLUSTER;           // blocks that share one weight stream
static_assert(CLUSTER >= 1 && CLUSTER <= 8, "a portable cluster has 1 to 8 blocks");

enum Kind { W1 = 0, W2 = 1, W3 = 2, WL = 3 };

struct Shape {
  int B, D, dc, dt, H, L, inverse, slots;
  int h_pad;      // H rounded up to 32
  int cbs;        // 32-column boxes across H (= 32-row chunks down H)
  int groups;     // 320-column groups of H (= 320-row chunks of W3's depth)
  int r1;         // dc rounded up to 8: W1's depth
  int w1_rows;    // W1 box rows: r1, at most 32
  int w1_chunks;  // W1's 32-deep stages
  int rl;         // D rounded up to 8: Wlin box rows
  int wl_boxes;   // Wlin's 32-column boxes (along the depth k)
  int n3_tiles;   // 8-column tiles of 2 * dt
  int n3_groups;  // W3's 32-column groups
  int sz;         // row stride of z (floats): D rounded up to 32, plus 8
  int sh;         // row stride of h1, h2 (floats), 8 mod 32
  int h1_floats;  // h1 region; it also holds the W3 partial sums
  int h2_floats;  // h2 region; it also holds log_scale
  int slot_bytes;
};

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// 32-column boxes of H in column group g (or 32-row boxes in W3's depth chunk g).
__host__ __device__ inline int group_boxes(const Shape& s, int g) {
  return imin(GROUP_BOXES, s.cbs - GROUP_BOXES * g);
}

// Dynamic shared memory: 1 KB to align the ring to the swizzle's 1024-byte period,
// the ring (as many slots as fit, up to MAX_SLOTS), 2 barriers per slot, then z, h1,
// h2. Returns false for a shape the kernel cannot take.
__host__ bool make_shape(int B, int D, int dc, int H, int L, int inverse, Shape& s, int& smem) {
  s.B = B; s.D = D; s.dc = dc; s.dt = D - dc; s.H = H; s.L = L; s.inverse = inverse;
  if (B < 1 || L < 1 || dc < 1 || s.dt < 1 || D % 4 || s.dt % 2 || H < 1 || H % 4)
    return false;
  s.h_pad = round_up(H, BOX);
  s.cbs = s.h_pad / BOX;
  s.groups = (s.cbs + GROUP_BOXES - 1) / GROUP_BOXES;
  s.r1 = round_up(dc, 8);
  s.w1_rows = imin(s.r1, BOX);
  s.w1_chunks = (s.r1 + BOX - 1) / BOX;
  s.rl = round_up(D, 8);
  s.wl_boxes = (D + BOX - 1) / BOX;
  s.n3_tiles = round_up(2 * s.dt, 8) / 8;
  s.n3_groups = (s.n3_tiles + N3_TILES_MAX - 1) / N3_TILES_MAX;
  s.sz = round_up(D, BOX) + 8;
  s.sh = s.h_pad + 8;
  const int n3p = 8 * s.n3_tiles;
  s.h1_floats = imax(ROWS * s.sh, CONSUMER_WARPS * ROWS * n3p);
  s.h2_floats = ROWS * imax(s.sh, n3p);
  // The largest stage: a group of W2 (or W1, W3), or Wlin.
  s.slot_bytes = imax(imin(s.cbs, GROUP_BOXES) * BOX * ROW_BYTES, s.wl_boxes * s.rl * ROW_BYTES);
  const int fixed = 1024 + 4 * (2 * ROWS * s.sz + s.h1_floats + s.h2_floats);
  s.slots = (MAX_SMEM - fixed) / (s.slot_bytes + 16);
  s.slots = s.slots < MAX_SLOTS ? s.slots : MAX_SLOTS;
  smem = fixed + s.slots * (s.slot_bytes + 16);
  return s.slots >= 2 && s.rl <= MAX_BOX_ROWS;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The 8 consumer warps only; the producer warp runs ahead on its own.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// Arrive on the barrier at the same offset in block `cta` of the cluster, with the
// default (.release.cta) semantics, as CUTLASS's cluster pipelines do: with
// .release.cluster every release stalled its warp, and the kernel ran much slower.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(bar), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
}

// One TMA box into the same offset of every block in `mask`, each block's barrier
// at `bar` told of its bytes.
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32 for a finite x in two integer instructions: add half a TF32 ulp
// to the magnitude and clear the low 13 bits (round to nearest, ties away from
// zero). ptxas expands the cvt itself into a longer sequence with inf/nan checks; an
// inf or nan operand still gives an inf or nan product.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}

// d += A B in 3xTF32 for one 8-deep step: lo hi, hi lo, then hi hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split(b0, b0h, b0l);
  split(b1, b1h, b1l);
  mma_tf32(d, a_lo, b0h, b1h);
  mma_tf32(d, a_hi, b0l, b1l);
  mma_tf32(d, a_hi, b0h, b1h);
}

// This lane's A fragment of the 8-deep step at depth k (a multiple of 8), from its
// two rows of activations (a_top = row g, a_bot = row g + 8, both already offset by
// 2 t), split into hi and lo; with MASK, depth from k_left on (k_valid - 2 t) reads as
// zero (z holds zt past dc; h1 and h2 hold zeros past H). Fragment column i of the
// step is depth k + 2 (i % 4) + i / 4.
template <bool MASK>
__device__ __forceinline__ void load_a(const float* a_top, const float* a_bot, int k,
                                       int k_left, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 top = *reinterpret_cast<const float2*>(a_top + k);
  const float2 bot = *reinterpret_cast<const float2*>(a_bot + k);
  const bool in0 = !MASK || k < k_left, in1 = !MASK || k + 1 < k_left;
  const float v[4] = {in0 ? top.x : 0.f, in0 ? bot.x : 0.f, in1 ? top.y : 0.f,
                      in1 ? bot.y : 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], hi[i], lo[i]);
}

// This lane's bias values of one column group, columns col0 + 8 W j + {0, 1} for its
// tiles j (W consumer warps), zero past H; read well before they are needed. A
// function forced inline: a call here would make the kernel save registers around it.
__device__ __forceinline__ void load_bias(const float* bias, int H, int col0,
                                          float (&bias_v)[NT_MAX][2]) {
#pragma unroll
  for (int j = 0; j < NT_MAX; ++j) {
    const int n = col0 + 8 * CONSUMER_WARPS * j;
    bias_v[j][0] = n < H ? __ldg(bias + n) : 0.f;
    bias_v[j][1] = n + 1 < H ? __ldg(bias + n + 1) : 0.f;
  }
}

struct Args {
  const float* x;
  const float* b1;
  const float* b2;
  const float* b3;
  const float* lu_ld;
  float* y;
  float* ld;
  Shape s;
};

__global__ void __launch_bounds__(THREADS, 1)
    k1_tf32x3_chain(const __grid_constant__ CUtensorMap tm_w1,
                    const __grid_constant__ CUtensorMap tm_w2,
                    const __grid_constant__ CUtensorMap tm_w3,
                    const __grid_constant__ CUtensorMap tm_wl, const __grid_constant__ Args a) {
  const Shape& s = a.s;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t full = ring_u32 + s.slots * s.slot_bytes;  // landed: 1 arrival + bytes
  const uint32_t empty = full + 8 * s.slots;  // released: every consumer warp of the cluster
  float* z_buf = reinterpret_cast<float*>(ring + s.slots * (s.slot_bytes + 16));  // 2 x [16][sz]
  float* h1 = z_buf + 2 * ROWS * s.sz;  // [16][sh]; the W3 partials
  float* h2 = h1 + s.h1_floats;         // [16][sh]; log_scale
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * ROWS;
  const uint32_t rank = cluster_rank();

  if (tid == 0) {
    for (int i = 0; i < s.slots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMER_WARPS * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < ROWS * s.sz; i += THREADS) {
    const int r = i / s.sz, k = i % s.sz, row = row0 + r;
    z_buf[i] = (k < s.D && row < s.B) ? a.x[static_cast<size_t>(row) * s.D + k] : 0.f;
  }
  __syncthreads();
  cluster_sync();  // every block's barriers exist before any multicast or remote arrive

  if (warp == CONSUMER_WARPS) {
    // ------------------------------------------------------------- producer warp
    if (lane == 0) {
      const CUtensorMap* maps[4] = {&tm_w1, &tm_w2, &tm_w3, &tm_wl};
      constexpr uint16_t mask = static_cast<uint16_t>((1u << CLUSTER) - 1);
      int it = 0;
      // One stage: n boxes of `rows` rows, box j at (column, row) (c0 + j d0, c1 + j d1)
      // of layer l, side by side in the slot.
      auto put = [&](int kind, int n, int rows, int c0, int c1, int d0, int d1, int l) {
        const int slot = it % s.slots;
        if (it >= s.slots) mbar_wait(empty + 8 * slot, ((it / s.slots) + 1) & 1);
        const uint32_t bar = full + 8 * slot;
        const int box_bytes = rows * ROW_BYTES;
        mbar_expect_tx(bar, n * box_bytes);
        const uint32_t dst = ring_u32 + slot * s.slot_bytes;
        for (int j = rank; j < n; j += CLUSTER)
          tma_load_3d_multicast(dst + j * box_bytes, maps[kind], bar, c0 + j * d0, c1 + j * d1,
                                l, mask);
        ++it;
      };
      // The consumers take the stages in this order: W1 and W2 per column group of H
      // (W1 in 32-deep stages, W2 in 32-deep chunks), W3 per 32-column group and
      // 320-deep chunk, and Wlin, first on the inverse.
      for (int step = 0; step < s.L; ++step) {
        const int l = s.inverse ? s.L - 1 - step : step;
        if (s.inverse) put(WL, s.wl_boxes, s.rl, 0, 0, BOX, 0, l);
        for (int g = 0; g < s.groups; ++g)
          for (int c = 0; c < s.w1_chunks; ++c)
            put(W1, group_boxes(s, g), s.w1_rows, GROUP * g, BOX * c, BOX, 0, l);
        for (int g = 0; g < s.groups; ++g)
          for (int c = 0; c < s.cbs; ++c)
            put(W2, group_boxes(s, g), BOX, GROUP * g, BOX * c, BOX, 0, l);
        for (int g3 = 0; g3 < s.n3_groups; ++g3)
          for (int c = 0; c < s.groups; ++c)
            put(W3, group_boxes(s, c), BOX, BOX * g3, GROUP * c, 0, BOX, l);
        if (!s.inverse) put(WL, s.wl_boxes, s.rl, 0, 0, BOX, 0, l);
      }
    }
    __syncwarp();
  } else {
    // ------------------------------------------------------- the consumer warps
    const int g = lane / 4, t = lane % 4;
    const int n_tiles = s.h_pad / 8;
    const int n3 = 2 * s.dt, n3p = 8 * s.n3_tiles;
    int it = 0;
    float ld = 0.f;  // log-det of row tid, held by threads tid < 16
    float* z = z_buf;              // z now; the LU mix writes the other buffer
    float* z_next = z_buf + ROWS * s.sz;

    auto wait_slot = [&]() -> const uint8_t* {
      const int slot = it % s.slots;
      mbar_wait(full + 8 * slot, (it / s.slots) & 1);
      return ring + slot * s.slot_bytes;
    };
    auto release_slot = [&]() {
      __syncwarp();
      if (lane < CLUSTER) mbar_arrive_remote(empty + 8 * (it % s.slots), lane);
      ++it;
    };
    // Byte offsets, in a box of 32-column rows, of this lane's two B values for an
    // 8-deep step starting at row 0 (the next step is 1024 bytes on) and column col.
    auto b_offsets = [&](int col, int& off0, int& off1) {
      const int base = 2 * t * ROW_BYTES + ((col & 3) << 2);
      off0 = base + (((col >> 2) ^ (2 * t)) << 4);
      off1 = base + ROW_BYTES + (((col >> 2) ^ (2 * t + 1)) << 4);
    };

    // out = relu(act W + b) of layer l, one 320-column group of H after another; per
    // group, the stages of W (W1: 32-deep stages of its r1 rows, the last one
    // k_steps_all left over; W2: cbs stages of 4 8-deep steps), columns past H zero.
    // Each stage's product is summed from zero, then added. A warp's tiles past the
    // last one (small H only) multiply the group's tile 0 again and are not stored.
    // bias_v holds this lane's bias values of group 0 (load_bias), read a phase
    // ahead; later groups' (wide chains only) are read in the epilogue, so that no
    // more registers are live in the products than at H <= 320: the kernel is at its
    // register cap (9 warps: 3 share one SM sub-partition's 16K registers, 168 each).
    auto dense = [&](auto mask, const float* act, int stride, int k_valid, int k_steps_all,
                     int box_rows, const float (&bias_v)[NT_MAX][2], float* out, int l) {
      constexpr bool MASK = decltype(mask)::value;  // W1 (b1): masked depth, ragged stages
      const int box_bytes = box_rows * ROW_BYTES;
      const int n_stages = (8 * k_steps_all + BOX - 1) / BOX;
      const float* a_top = act + g * stride + 2 * t;
      const float* a_bot = a_top + 8 * stride;
      for (int grp = 0; grp < s.groups; ++grp) {
        const int tile0 = GROUP / 8 * grp;
        int off0[NT_MAX], off1[NT_MAX];
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j) {
          int tile = warp + CONSUMER_WARPS * j;  // in the group
          tile = tile0 + tile < n_tiles ? tile : 0;
          b_offsets((tile & 3) * 8 + g, off0[j], off1[j]);
          off0[j] += (tile >> 2) * box_bytes;
          off1[j] += (tile >> 2) * box_bytes;
        }
        float acc[NT_MAX][4];
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
        for (int c = 0; c < n_stages; ++c) {
          const uint8_t* w = wait_slot();
          const int k_steps = MASK ? imin(BOX / 8, k_steps_all - BOX / 8 * c) : BOX / 8;
          float part[NT_MAX][4];
#pragma unroll
          for (int j = 0; j < NT_MAX; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
          for (int ks = 0; ks < BOX / 8; ++ks) {
            if (ks >= k_steps) break;
            const int k = BOX * c + 8 * ks;
            uint32_t a_hi[4], a_lo[4];
            load_a<MASK>(a_top, a_bot, k, k_valid - 2 * t, a_hi, a_lo);
#pragma unroll
            for (int j = 0; j < NT_MAX; ++j) {
              const float b0 = *reinterpret_cast<const float*>(w + off0[j] + ks * 1024);
              const float b1 = *reinterpret_cast<const float*>(w + off1[j] + ks * 1024);
              mma_3xtf32(part[j], a_hi, a_lo, b0, b1);
            }
          }
          release_slot();
#pragma unroll
          for (int j = 0; j < NT_MAX; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
        }
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j) {
          const int tile = tile0 + warp + CONSUMER_WARPS * j;
          if (tile >= n_tiles) continue;
          const int n = 8 * tile + 2 * t;
          float bv0 = bias_v[j][0], bv1 = bias_v[j][1];
          if (grp > 0) {
            const float* bias = (MASK ? a.b1 : a.b2) + static_cast<size_t>(l) * s.H;
            bv0 = n < s.H ? __ldg(bias + n) : 0.f;
            bv1 = n + 1 < s.H ? __ldg(bias + n + 1) : 0.f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = n < s.H ? fmaxf(acc[j][2 * h] + bv0, 0.f) : 0.f;
            const float v1 = n + 1 < s.H ? fmaxf(acc[j][2 * h + 1] + bv1, 0.f) : 0.f;
            *reinterpret_cast<float2*>(out + (g + 8 * h) * s.sh + n) = make_float2(v0, v1);
          }
        }
      }
    };

    // z_next <- z Wlin^T (Wlin holds W^-1 on the inverse), f32 FMAs in depth order,
    // 4 depths per 16-byte load from Wlin's 32-column box of that depth; a thread's
    // outputs (16 x D of them) go two at a time, side by side. Then the buffers swap
    // and the log-det takes lu.
    auto lu_mix = [&](float lu) {
      const uint8_t* wl = wait_slot();
      const int box_bytes = s.rl * ROW_BYTES;
      for (int i0 = tid; i0 < ROWS * s.D; i0 += 2 * CONSUMERS) {
        int r[2], col[2];
        float acc[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = i0 + q * CONSUMERS;
          r[q] = i < ROWS * s.D ? i / s.D : 0;
          col[q] = i < ROWS * s.D ? i % s.D : 0;
        }
#pragma unroll 4
        for (int k = 0; k < s.D; k += 4) {
          const uint8_t* box = wl + (k / BOX) * box_bytes;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float4 zv = *reinterpret_cast<const float4*>(z + r[q] * s.sz + k);
            const float4 wv = *reinterpret_cast<const float4*>(
                box + col[q] * ROW_BYTES + ((((k % BOX) >> 2) ^ (col[q] & 7)) << 4));
            acc[q] = fmaf(zv.w, wv.w, fmaf(zv.z, wv.z, fmaf(zv.y, wv.y, fmaf(zv.x, wv.x, acc[q]))));
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (i0 + q * CONSUMERS < ROWS * s.D) z_next[r[q] * s.sz + col[q]] = acc[q];
      }
      release_slot();
      consumer_sync();
      float* swap = z;
      z = z_next;
      z_next = swap;
      if (tid < ROWS) ld = s.inverse ? ld - lu : ld + lu;
    };

    // Small operands are read a phase or more ahead, so their latency hides behind
    // the products: b2 during W1's barrier, b1 of the next layer, b3 and the next
    // lu_ld after W2 (not before it: W2's products hold the most registers).
    const int layer0 = s.inverse ? s.L - 1 : 0;
    const int r_aff = tid / s.dt, c_aff = tid % s.dt;  // this thread's first affine element
    const bool affine = tid < ROWS * s.dt;
    float b1_v[NT_MAX][2], b2_v[NT_MAX][2];
    const int col0 = 8 * warp + 2 * t;  // this lane's first bias column of a group
    load_bias(a.b1 + static_cast<size_t>(layer0) * s.H, s.H, col0, b1_v);
    float lu = tid < ROWS ? __ldg(a.lu_ld + layer0) : 0.f;
    for (int step = 0; step < s.L; ++step) {
      const int l = s.inverse ? s.L - 1 - step : step;
      const int l_next = s.inverse ? l - 1 : l + 1;
      if (s.inverse) lu_mix(lu);

      dense(std::true_type(), z, s.sz, s.dc, s.r1 / 8, s.w1_rows, b1_v, h1, l);
      load_bias(a.b2 + static_cast<size_t>(l) * s.H, s.H, col0, b2_v);
      consumer_sync();
      dense(std::false_type(), h1, s.sh, s.H, s.h_pad / 8, BOX, b2_v, h2, l);
      if (step + 1 < s.L) load_bias(a.b1 + static_cast<size_t>(l_next) * s.H, s.H, col0, b1_v);
      const float* b3 = a.b3 + static_cast<size_t>(l) * n3;
      const float b_shift = affine ? __ldg(b3 + c_aff) : 0.f;
      const float b_ls = affine ? __ldg(b3 + s.dt + c_aff) : 0.f;
      if (tid < ROWS) lu = __ldg(a.lu_ld + (s.inverse ? (step + 1 < s.L ? l_next : l) : l));
      consumer_sync();

      // o = h2 W3 + b3, per 32-column group of W3 and per 320-deep chunk of h2: in a
      // chunk of n 8-deep steps warp w sums steps [w n / W, (w + 1) n / W) (W warps);
      // chunk 0's sum is stored to the warp's partials in shared memory and each later
      // chunk's added to them (each lane to its own elements: no barrier), in chunk
      // order; the warps' partials are added in warp order after the bias. Chunk 0 is
      // written out on its own so that a chain of one chunk runs no accumulation.
      {
        const float* a_top = h2 + g * s.sh + 2 * t;
        const float* a_bot = a_top + 8 * s.sh;
        // Chunk c's products into part: this warp's slice of its 8-deep steps.
        auto w3_chunk = [&](int c, const int (&off0)[N3_TILES_MAX],
                            const int (&off1)[N3_TILES_MAX], float (&part)[N3_TILES_MAX][4]) {
          const uint8_t* w3 = wait_slot();
          const int steps = imin(GROUP / 8, s.h_pad / 8 - GROUP / 8 * c);
#pragma unroll
          for (int j = 0; j < N3_TILES_MAX; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
          for (int ks = warp * steps / CONSUMER_WARPS; ks < (warp + 1) * steps / CONSUMER_WARPS;
               ++ks) {
            uint32_t a_hi[4], a_lo[4];
            load_a<false>(a_top, a_bot, GROUP * c + 8 * ks, 0, a_hi, a_lo);
#pragma unroll
            for (int j = 0; j < N3_TILES_MAX; ++j) {
              const float b0 = *reinterpret_cast<const float*>(w3 + off0[j] + ks * 1024);
              const float b1 = *reinterpret_cast<const float*>(w3 + off1[j] + ks * 1024);
              mma_3xtf32(part[j], a_hi, a_lo, b0, b1);
            }
          }
          release_slot();
        };
        for (int g3 = 0; g3 < s.n3_groups; ++g3) {
          const int tiles = imin(N3_TILES_MAX, s.n3_tiles - N3_TILES_MAX * g3);
          int off0[N3_TILES_MAX], off1[N3_TILES_MAX];
          float* mine = h1 + warp * ROWS * n3p + BOX * g3;
#pragma unroll
          for (int j = 0; j < N3_TILES_MAX; ++j)
            b_offsets(8 * (j < tiles ? j : 0) + g, off0[j], off1[j]);
          float part[N3_TILES_MAX][4];
          w3_chunk(0, off0, off1, part);
#pragma unroll
          for (int j = 0; j < N3_TILES_MAX; ++j) {
            if (j >= tiles) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(mine + (g + 8 * h) * n3p + 8 * j + 2 * t) =
                  make_float2(part[j][2 * h], part[j][2 * h + 1]);
          }
          for (int c = 1; c < s.groups; ++c) {
            w3_chunk(c, off0, off1, part);
#pragma unroll
            for (int j = 0; j < N3_TILES_MAX; ++j) {
              if (j >= tiles) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float2* dst = reinterpret_cast<float2*>(mine + (g + 8 * h) * n3p + 8 * j + 2 * t);
                *dst = make_float2(dst->x + part[j][2 * h], dst->y + part[j][2 * h + 1]);
              }
            }
          }
        }
      }
      consumer_sync();
      // The affine step, one (row, column) at a time per thread; log_scale is kept in
      // h2 for the row sums. A thread's first element (row r_aff, column c_aff) has its
      // b3 values read ahead; further elements (16 dt > 256 only) read theirs here.
      auto affine_step = [&](int r, int c, float shift, float ls) {
#pragma unroll
        for (int w = 0; w < CONSUMER_WARPS; ++w) {
          shift += h1[(w * ROWS + r) * n3p + c];
          ls += h1[(w * ROWS + r) * n3p + s.dt + c];
        }
        float* zt = z + r * s.sz + s.dc + c;
        *zt = s.inverse ? (*zt - shift) * expf(-ls) : *zt * expf(ls) + shift;
        h2[r * n3p + c] = ls;
      };
      if (affine) affine_step(r_aff, c_aff, b_shift, b_ls);
      for (int i = tid + CONSUMERS; i < ROWS * s.dt; i += CONSUMERS) {
        const int c = i % s.dt;
        affine_step(i / s.dt, c, __ldg(b3 + c), __ldg(b3 + s.dt + c));
      }
      consumer_sync();
      // Each row's log_scale sum, in column order. h2 is next written after the next
      // layer's W1 phase and its barrier.
      if (tid < ROWS) {
        float sum = 0.f;
#pragma unroll 4
        for (int c = 0; c < s.dt; ++c) sum += h2[tid * n3p + c];
        ld = s.inverse ? ld - sum : ld + sum;
      }

      if (!s.inverse) lu_mix(lu);
    }

    for (int i = tid; i < ROWS * s.D; i += CONSUMERS) {
      const int r = i / s.D, k = i % s.D, row = row0 + r;
      if (row < s.B) a.y[static_cast<size_t>(row) * s.D + k] = z[r * s.sz + k];
    }
    if (tid < ROWS && row0 + tid < s.B) a.ld[row0 + tid] = ld;
  }
  // No block leaves while a multicast may still land in it or a remote warp may
  // still arrive on its barriers.
  __syncwarp();
  cluster_sync();
}

// ------------------------------------------------------------------------ host side

EncodeTiled g_encode = nullptr;

constexpr int kNoEncoder = -1;
constexpr int kEncodeFailed = -2;
constexpr int kBadShape = -3;

int encode(CUtensorMap* map, const float* base, cuuint32_t rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  if (g_encode == nullptr) return kNoEncoder;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = g_encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

// A [L][rows][cols] f32 tensor read in boxes of 32 columns x box_rows rows of one
// layer, 128B swizzle; past cols and rows: zeros.
int layer_map(CUtensorMap* map, const float* base, int cols, int rows, int L, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {4ull * cols, 4ull * cols * rows};
  const cuuint32_t box[3] = {BOX, static_cast<cuuint32_t>(box_rows), 1};
  return encode(map, base, 3, dims, strides, box);
}

}  // namespace

extern "C" {

void realnvp_set_encoder(void* fn) { g_encode = reinterpret_cast<EncodeTiled>(fn); }

// Launches one fused pass on `stream`, no synchronisation: ceil(B / 16) blocks
// rounded up to whole clusters of CLUSTER blocks. Returns 0, the first failing CUDA
// call's error, or a negative code (no encoder, a refused tensor map, a shape the
// kernel cannot take).
int fused_realnvp_pass_f32(const float* x, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3,
                           const float* b3, const float* wlin, const float* lu_ld,
                           float* y, float* ld, int B, int D, int dc, int H, int L,
                           int inverse, void* stream) {
  Args args;
  args.x = x; args.b1 = b1; args.b2 = b2; args.b3 = b3; args.lu_ld = lu_ld;
  args.y = y; args.ld = ld;
  int smem = 0;
  if (!make_shape(B, D, dc, H, L, inverse, args.s, smem)) return kBadShape;
  const Shape& s = args.s;
  CUtensorMap m1, m2, m3, ml;
  int err;
  if ((err = layer_map(&m1, w1, H, dc, L, s.w1_rows)) ||
      (err = layer_map(&m2, w2, H, H, L, BOX)) || (err = layer_map(&m3, w3, 2 * s.dt, H, L, BOX)) ||
      (err = layer_map(&ml, wlin, D, D, L, s.rl)))
    return err;
  cudaError_t e = cudaFuncSetAttribute(k1_tf32x3_chain,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(round_up((B + ROWS - 1) / ROWS, CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k1_tf32x3_chain, m1, m2, m3, ml, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* realnvp_error_string(int code) {
  if (code == kNoEncoder) return "no tensor-map encoder: realnvp_set_encoder was not called";
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  if (code == kBadShape) return "a shape the kernel cannot take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
