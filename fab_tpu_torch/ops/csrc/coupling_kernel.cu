// One affine-coupling layer at large event dim (K2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fab_tpu/ops/coupling_kernel.py:_coupling_pallas
// (pallas_call at line 167, body `_mlp3_blocks_kernel`). Same function:
//   h1 = relu(zc w1 + b1); h2 = relu(h1 w2 + b2); o = h2 w3p + b3p;
//   shift = o[:, :dt], ls = o[:, dt:2dt], optionally ls = cap * tanh(ls / cap);
//   forward: y = zt * exp(ls) + shift, log_det = sum(ls);
//   inverse: y = (zt - shift) * exp(-ls), log_det = -sum(ls).
//
// What bounds it: at the LGCP-1600 shapes (M=512, dc=dt=800, H=3200) one call is
// 18.35 GFLOP of f32 products against ~77 MB of operands. It must keep f32 accuracy
// (the Pallas kernel runs at precision `highest`), and one TF32 pass over a 3200-deep
// product misses by ~1e-3. The tensor cores keep it with three TF32 passes
// ("3xTF32"): a = a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi), and
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi (the dropped a_lo b_lo is ~2^-22 relative).
// That is 3 x 18.35 GFLOP at 495 TFLOP/s dense TF32 = 0.111 ms, against 0.023 ms for
// the bytes at 3.35 TB/s and 0.274 ms for plain f32 FMAs on the CUDA cores: bound by
// tensor-core operations.
//
// Design:
//   - Every product is `wgmma.mma_async ... .f32.tf32.tf32` with both operands in
//     shared memory. TF32 wgmma takes only K-major operands there, so the weights
//     (stored [K, N], N contiguous) are used through a prepared copy: W^T split into
//     hi and lo planes, [2, N, K_pad] with K padded to a multiple of 4 floats (16-byte
//     TMA strides). k2_prepare_weight builds it; the wrapper rebuilds it whenever the
//     weight changes (coupling_kernel.py:prepared_weight).
//   - Activations arrive split too: k2_split_rows turns zc into hi/lo planes
//     [2, M, dc_pad] (the pad is zero), and the epilogues of stages 1-2 write h1 and
//     h2 directly as hi/lo planes [2, M, H]. No operand is converted inside the GEMM.
//   - Each GEMM block is one consumer warpgroup (64 output rows) and one producer
//     warp. The producer's single thread streams 32-deep stages (one 128-byte swizzle
//     row per operand row) through a ring of mbarrier-guarded stages with TMA
//     (`cp.async.bulk.tensor`, 128B swizzle, out-of-bounds rows and depth
//     zero-filled), so the loads of stage k+2 are in flight while stage k is
//     multiplied. Per 8-deep step the consumer issues a_lo b_hi, a_hi b_lo, then
//     a_hi b_hi into one f32 sum: the small terms go in before the large one.
//   - The tensor cores truncate their f32 sums; over 1200 wgmma steps of a 3200-deep
//     product that drifts by ~1e-4 relative, ten times what plain f32 misses by. So
//     each 32-deep stage is summed on its own and added to the running sum on the
//     CUDA cores, rounded to nearest. The stage's products are waited for before
//     that add, so consecutive stages' wgmmas do not overlap.
//   - Stages 1-2: 64 x 200 tiles (8 x 16 = 128 blocks at M=512, H=3200, one wave on
//     132 SMs), 3 stages of 66 KB; epilogue bias + ReLU, split, stored as planes.
//   - Stage 3: a block's 112 columns are 56 shift columns j.. and their 56 log_scale
//     partners dt + j.., fetched by one 4-D TMA box from w3p^T seen as
//     [hi/lo][shift/log_scale][dt][H] (8 x 15 = 120 blocks at M=512, dt=800). A thread's
//     accumulator holds each shift value beside its partner, so the cap, the affine
//     step and the store of y happen in registers; each row's 56 log_scale values are
//     summed in a fixed order (per thread, then a fixed lane butterfly) into a per-
//     (row, column tile) partial. Only the first 2*dt columns of w3p are ever read.
//   - k2_row_sum adds each row's partials in column-tile order: the log-det is
//     bitwise repeatable, with no float atomics.
// Ragged rows, depth and columns are zero-filled by TMA and masked at the stores.

#include <cstddef>
#include <cstdint>

#include "hopper_common.cuh"

namespace {

constexpr int BM = 64;          // rows per block: one warpgroup's wgmma m64
constexpr int BK = 32;          // depth per stage: 32 floats = one 128-byte swizzle row
constexpr int DENSE_BN = 200;   // stages 1-2: output columns per block
constexpr int PAIRS = 56;       // stage 3: shift / log_scale column pairs per block
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp

// Bytes of one ring stage: hi and lo planes of a BM x BK tile of A and a BN x BK tile
// of B.
__host__ __device__ constexpr int stage_bytes(int bn) { return 2 * (BM + bn) * BK * 4; }
// As many stages as fit in ~220 KB, at most 4.
__host__ __device__ constexpr int ring_stages(int bn) {
  return (220 * 1024) / stage_bytes(bn) < 4 ? (220 * 1024) / stage_bytes(bn) : 4;
}
// Dynamic shared memory: the ring, its 2 x stages barriers, 1 KB to align the ring
// to the 1024-byte period of the 128B swizzle.
__host__ __device__ constexpr int smem_bytes(int bn) { return ring_stages(bn) * (stage_bytes(bn) + 16) + 1024; }

// wgmma shared-memory descriptor of a K-major tile whose rows are 128 bytes (BK
// floats) in the 128B swizzle, 8-row groups 1024 bytes apart, starting on a 1024-byte
// boundary. Adding 2 steps the start 32 bytes (8 floats, one k8 step) along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an asynchronous
// wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] = A[64 x 8] B[N x 8]^T (+ d if accumulate) in TF32, both from shared
// memory. Thread t of the
// warpgroup holds, for each 8-column group i, d[4i + 2h + c] = D[16 (t / 32) + (t % 32) / 4
// + 8h, 8i + 2 (t % 4) + c].
template <int N>
struct Wgmma;

template <>
struct Wgmma<200> {
  __device__ static __forceinline__ void mma(float (&d)[100], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
        "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99"
        "}, %100, %101, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<112> {
  __device__ static __forceinline__ void mma(float (&d)[56], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55"
        "}, %56, %57, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};


// The mainloop shared by both GEMMs: acc = A[m0:m0+64, :K] B[n0 rows, :K]^T in 3xTF32.
// A's map is over hi/lo planes [2, rows, K] (box BK x BM x 2). B's is the same over
// [2, N, K] (box BK x BN x 2) or, PAIRED, over w3p^T as [2][2][dt][K] (box
// BK x BN/2 x 2 x 2). Returns false in the producer warp, which has nothing more to
// do; the consumer warpgroup returns true with its accumulator.
template <int BN, bool PAIRED>
__device__ __forceinline__ bool mainloop(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                         int K, int m0, int n0, float (&acc)[BN / 2]) {
  constexpr int STAGES = ring_stages(BN);
  constexpr uint32_t A_BYTES = 2 * BM * BK * 4;
  constexpr uint32_t B_BYTES = 2 * BN * BK * 4;
  constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE;  // TMA landed: 1 arrival + bytes
  const uint32_t empty = full + 8 * STAGES;     // stage released: 128 arrivals
  const int n_k = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp: one thread issues every load
    if (threadIdx.x == CONSUMERS) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, ((kt / STAGES) + 1) & 1);
        const uint32_t a = ring + s * STAGE;
        mbar_expect_tx(full + 8 * s, STAGE);
        tma_load_3d(a, tm_a, full + 8 * s, kt * BK, m0, 0);
        if (PAIRED) {
          tma_load_4d(a + A_BYTES, tm_b, full + 8 * s, kt * BK, n0, 0, 0);
        } else {
          tma_load_3d(a + A_BYTES, tm_b, full + 8 * s, kt * BK, n0, 0);
        }
      }
    }
    return false;
  }

  // Each stage is summed into `part` (its first wgmma starts from zero), then added
  // to acc on the CUDA cores (see the header: the tensor cores truncate).
  float part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t a = ring + s * STAGE;
    const uint64_t a_hi = smem_desc(a), a_lo = smem_desc(a + A_BYTES / 2);
    const uint64_t b_hi = smem_desc(a + A_BYTES), b_lo = smem_desc(a + A_BYTES + B_BYTES / 2);
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t step = 2 * kk;
      Wgmma<BN>::mma(part, a_lo + step, b_hi + step, kk > 0);
      Wgmma<BN>::mma(part, a_hi + step, b_lo + step, 1);
      Wgmma<BN>::mma(part, a_hi + step, b_hi + step, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    mbar_arrive(empty + 8 * s);  // the stage's buffers are free for the producer
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }
  return true;
}

// Stages 1-2: out = relu(A B + bias) as hi/lo planes [2, M, N] (N even).
__global__ void __launch_bounds__(THREADS, 1)
    k2_tf32x3_dense(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ bias,
                    float* __restrict__ out, int M, int N, int K) {
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * DENSE_BN;
  float acc[DENSE_BN / 2];
  if (!mainloop<DENSE_BN, false>(&tm_a, &tm_b, K, m0, n0, acc)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = m0 + 16 * warp + lane / 4;
  const size_t plane = static_cast<size_t>(M) * N;
#pragma unroll
  for (int i = 0; i < DENSE_BN / 8; ++i) {
    const int n = n0 + 8 * i + 2 * (lane % 4);
    if (n >= N) continue;
    const float bias0 = bias[n], bias1 = bias[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r + 8 * h;
      if (m >= M) continue;
      const float v0 = fmaxf(acc[4 * i + 2 * h] + bias0, 0.f);
      const float v1 = fmaxf(acc[4 * i + 2 * h + 1] + bias1, 0.f);
      const float hi0 = tf32_rna(v0), hi1 = tf32_rna(v1);
      const size_t at = static_cast<size_t>(m) * N + n;
      *reinterpret_cast<float2*>(out + at) = make_float2(hi0, hi1);
      *reinterpret_cast<float2*>(out + plane + at) =
          make_float2(tf32_rna(v0 - hi0), tf32_rna(v1 - hi1));
    }
  }
}

// Stage 3: paired shift / log_scale tile, capped affine step, per-tile log_scale sums.
// partial[m, blockIdx.x] = sum of the (capped) log_scale of row m over this tile.
__global__ void __launch_bounds__(THREADS, 1)
    k2_tf32x3_coupling(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ b3p,
                       const float* __restrict__ zt, float* __restrict__ y,
                       float* __restrict__ partial, int M, int dt, int K, int n_tiles,
                       float cap, int inverse) {
  const int m0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * PAIRS;
  float acc[PAIRS];
  if (!mainloop<2 * PAIRS, true>(&tm_a, &tm_b, K, m0, j0, acc)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = m0 + 16 * warp + lane / 4;
  float ls_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < PAIRS / 8; ++i) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + 8 * i + 2 * (lane % 4) + c;
      if (j >= dt) continue;
      const float b_shift = b3p[j], b_ls = b3p[dt + j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r + 8 * h;
        if (m >= M) continue;
        // Column p of the tile is shift j0 + p; column PAIRS + p its log_scale.
        const float shift = acc[4 * i + 2 * h + c] + b_shift;
        float ls = acc[4 * (i + PAIRS / 8) + 2 * h + c] + b_ls;
        if (cap > 0.f) ls = cap * tanhf(ls / cap);
        const size_t at = static_cast<size_t>(m) * dt + j;
        const float z = zt[at];
        y[at] = inverse ? (z - shift) * expf(-ls) : z * expf(ls) + shift;
        ls_sum[h] += ls;
      }
    }
  }
  // The 4 lanes that hold a row's values, in a fixed order.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ls_sum[h] += __shfl_xor_sync(0xffffffffu, ls_sum[h], 1);
    ls_sum[h] += __shfl_xor_sync(0xffffffffu, ls_sum[h], 2);
    const int m = r + 8 * h;
    if (lane % 4 == 0 && m < M) partial[static_cast<size_t>(m) * n_tiles + blockIdx.x] = ls_sum[h];
  }
}

// out[0] = tf32(x), out[1] = tf32(x - out[0]) for x [M, K] into planes [2, M, K_pad],
// zero past column K.
__global__ void k2_split_rows(const float* __restrict__ x, int M, int K, int K_pad,
                              float* __restrict__ out) {
  const size_t n = static_cast<size_t>(M) * K_pad;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int m = static_cast<int>(i / K_pad), k = static_cast<int>(i % K_pad);
    const float v = k < K ? x[static_cast<size_t>(m) * K + k] : 0.f;
    const float hi = tf32_rna(v);
    out[i] = hi;
    out[n + i] = tf32_rna(v - hi);
  }
}

// The prepared copy of a weight w [K, ldw] (columns 0..N-1 used): hi/lo planes of
// w^T, out [2, N, K_pad], zero past row K of w. 32 x 32 tiles through shared memory,
// so reads run along N and writes along K.
__global__ void k2_prepare_weight(const float* __restrict__ w, int K, int N, int ldw,
                                  int K_pad, float* __restrict__ out) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const int k = k0 + dy, n = n0 + threadIdx.x;
    tile[dy][threadIdx.x] = (k < K && n < N) ? w[static_cast<size_t>(k) * ldw + n] : 0.f;
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(N) * K_pad;
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const int n = n0 + dy, k = k0 + threadIdx.x;
    if (n < N && k < K_pad) {
      const float v = tile[threadIdx.x][dy];
      const float hi = tf32_rna(v);
      const size_t at = static_cast<size_t>(n) * K_pad + k;
      out[at] = hi;
      out[plane + at] = tf32_rna(v - hi);
    }
  }
}

// log_det[m] = sign * sum_t partial[m, t], in tile order.
__global__ void k2_row_sum(const float* __restrict__ partial, int n_tiles, int M, float sign,
                           float* __restrict__ log_det) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float* p = partial + static_cast<size_t>(m) * n_tiles;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += p[t];
  log_det[m] = sign * s;
}

// ------------------------------------------------------------------------ host side

EncodeTiled g_encode = nullptr;

constexpr int kNoEncoder = -1;
constexpr int kEncodeFailed = -2;

int pad4(int k) { return (k + 3) / 4 * 4; }

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

// Hi/lo planes [2, rows, ld] holding a K-deep operand (K <= ld, ld % 4 == 0), read in
// boxes of BK x box_rows x 2 (past K and past `rows`: zeros).
int planes_map(CUtensorMap* map, const float* planes, int K, int rows, int ld, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows), 2};
  const cuuint64_t strides[2] = {4ull * ld, 4ull * ld * rows};
  const cuuint32_t box[3] = {BK, static_cast<cuuint32_t>(box_rows), 2};
  return encode(map, planes, 3, dims, strides, box);
}

// The prepared w3p^T [2, 2 dt, H] seen as [hi/lo][shift/log_scale][dt][H]: a box of
// BK x PAIRS x 2 x 2 brings PAIRS shift rows, their log_scale partners, hi and lo.
int paired_map(CUtensorMap* map, const float* w3t, int H, int dt) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(dt), 2, 2};
  const cuuint64_t strides[3] = {4ull * H, 4ull * H * dt, 8ull * H * dt};
  const cuuint32_t box[4] = {BK, PAIRS, 2, 2};
  return encode(map, w3t, 4, dims, strides, box);
}

}  // namespace

extern "C" {

void coupling_set_encoder(void* fn) { g_encode = reinterpret_cast<EncodeTiled>(fn); }

// Number of stage-3 column tiles, i.e. the width of the `partial` workspace.
int coupling_partial_tiles(int dt) { return (dt + PAIRS - 1) / PAIRS; }

// Builds the prepared copy of w [K, ldw] (its first N columns): out [2, N, pad4(K)].
int coupling_prepare_weight_f32(const float* w, int K, int N, int ldw, float* out,
                                void* stream) {
  const int k_pad = pad4(K);
  const dim3 grid((k_pad + 31) / 32, (N + 31) / 32);
  k2_prepare_weight<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      w, K, N, ldw, k_pad, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches one coupling layer on `stream`, no synchronisation. w1t [2, H, pad4(dc)],
// w2t [2, H, H], w3t [2, 2 dt, H] are the prepared weights. Workspaces: zc_planes
// [2, M, pad4(dc)], h1 and h2 [2, M, H], partial [M, coupling_partial_tiles(dt)].
// H must be a multiple of 4. Returns 0, the first non-zero cudaGetLastError(), or a
// negative code for a tensor map that could not be made.
int fused_coupling_apply_f32(const float* zc, const float* zt, const float* w1t,
                             const float* b1, const float* w2t, const float* b2,
                             const float* w3t, const float* b3p, float* y, float* ld,
                             float* zc_planes, float* h1, float* h2, float* partial, int M,
                             int dc, int dt, int H, float cap, int inverse, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dc_pad = pad4(dc);
  CUtensorMap a1, bw1, a2, bw2, a3, bw3;
  int err;
  if ((err = planes_map(&a1, zc_planes, dc, M, dc_pad, BM)) ||
      (err = planes_map(&bw1, w1t, dc, H, dc_pad, DENSE_BN)) ||
      (err = planes_map(&a2, h1, H, M, H, BM)) ||
      (err = planes_map(&bw2, w2t, H, H, H, DENSE_BN)) ||
      (err = planes_map(&a3, h2, H, M, H, BM)) || (err = paired_map(&bw3, w3t, H, dt)))
    return err;
  constexpr int dense_smem = smem_bytes(DENSE_BN);
  constexpr int paired_smem = smem_bytes(2 * PAIRS);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(k2_tf32x3_dense, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                dense_smem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(k2_tf32x3_coupling,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, paired_smem)) !=
          cudaSuccess)
    return static_cast<int>(e);

  const size_t n_split = static_cast<size_t>(M) * dc_pad;
  const int split_blocks = static_cast<int>((n_split + 255) / 256 < 1024 ? (n_split + 255) / 256 : 1024);
  k2_split_rows<<<split_blocks, 256, 0, s>>>(zc, M, dc, dc_pad, zc_planes);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int row_tiles = (M + BM - 1) / BM;
  const dim3 grid_h((H + DENSE_BN - 1) / DENSE_BN, row_tiles);
  k2_tf32x3_dense<<<grid_h, THREADS, dense_smem, s>>>(a1, bw1, b1, h1, M, H, dc);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k2_tf32x3_dense<<<grid_h, THREADS, dense_smem, s>>>(a2, bw2, b2, h2, M, H, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = coupling_partial_tiles(dt);
  k2_tf32x3_coupling<<<dim3(n_tiles, row_tiles), THREADS, paired_smem, s>>>(
      a3, bw3, b3p, zt, y, partial, M, dt, H, n_tiles, cap, inverse);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k2_row_sum<<<(M + 255) / 256, 256, 0, s>>>(partial, n_tiles, M, inverse ? -1.f : 1.f, ld);
  return static_cast<int>(cudaGetLastError());
}

const char* coupling_error_string(int code) {
  if (code == kNoEncoder) return "no tensor-map encoder: coupling_set_encoder was not called";
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
