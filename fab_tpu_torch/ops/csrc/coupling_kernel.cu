// One affine-coupling layer at large event dim (K2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fab_tpu/ops/coupling_kernel.py:_coupling_pallas
// (body `_mlp3_blocks_kernel`). Same function and operand layout:
//   zc [M, dc], zt [M, dt]; w1 [dc, H], b1 [H]; w2 [H, H], b2 [H];
//   w3p [H, P], b3p [P] with P >= 2*dt (the last layer padded to a multiple of 128
//   columns; only the first 2*dt columns are read).
//   h1 = relu(zc w1 + b1); h2 = relu(h1 w2 + b2); o = h2 w3p + b3p;
//   shift = o[:, :dt], ls = o[:, dt:2dt], optionally ls = cap * tanh(ls / cap);
//   forward: y = zt * exp(ls) + shift, log_det = sum(ls);
//   inverse: y = (zt - shift) * exp(-ls), log_det = -sum(ls).
//
// What bounds it: at the LGCP-1600 shapes (M=512, dc=dt=800, H=3200) one call is
// 18.4 GFLOP of f32 FMAs against ~77 MB of weights and activations: 0.27 ms at the
// H100's 67 TFLOP/s f32 rate versus 0.023 ms at 3.35 TB/s, so it is bound by
// operations.
//
// Why the TPU plan does not carry over: the Pallas kernel keeps one batch tile's h1
// and h2 in VMEM for all three products and streams the weights past them. Here a
// 16-row tile's h1 + h2 alone is 2 * 16 * 3200 * 4 B = 410 KB, against 227 KB of
// shared memory per block, so the activations cannot stay on chip for any tile that
// fills the card.
//
// Design instead: three register-blocked, shared-memory-tiled f32 GEMMs with fused
// epilogues. Each block computes a 64 x 64 output tile over the full depth, staged
// 16 deep through double-buffered shared memory (the next stage's global loads are
// in flight while the current one is multiplied); each of its 256 threads holds a
// 4 x 4 register tile. At M=512, H=3200 stages 1 and 2 launch 8 x 50 = 400 blocks.
//   1. h1 = relu(zc w1 + b1)  -> workspace (6.5 MB, stays in the 50 MB L2)
//   2. h2 = relu(h1 w2 + b2)  -> workspace
//   3. a block's 64 columns are 32 shift columns j.. and their 32 log_scale partners
//      dt + j..; the epilogue passes the tile through shared memory so that one
//      thread sees both, applies the cap and the affine step, writes y, and reduces
//      its row's 32 log_scale values with a fixed butterfly into a per-(row, column
//      tile) partial. The padded columns are never read.
//   4. a last pass sums each row's partials in column-tile order: the log-det is
//      deterministic, with no float atomics.
// Ragged edges in M, N and K are masked. Arithmetic is plain f32 FMAs (no TF32, no
// tensor cores).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;         // rows per block tile
constexpr int BN = 64;         // columns per block tile
constexpr int BK = 16;         // depth per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, a 4 x 4 register tile each
constexpr int HALF = BN / 2;   // stage 3: 32 shift + 32 log_scale columns per tile
constexpr int ASTR = BM + 4;   // row stride of the transposed A stage (padding)
constexpr int CSTR = BN + 1;   // row stride of the stage-3 epilogue tile

// Source column of B for column c of the tile, or -1 past the edge. Plain: n0 + c.
// Paired (stage 3, n0 = first shift column, n_valid = dt): shift column n0 + c for
// c < HALF, else its log_scale partner dt + n0 + c - HALF.
template <bool PAIRED>
__device__ __forceinline__ int source_col(int c, int n0, int n_valid) {
  if (PAIRED) {
    const int j = n0 + (c < HALF ? c : c - HALF);
    if (j >= n_valid) return -1;
    return c < HALF ? j : n_valid + j;
  }
  const int n = n0 + c;
  return n < n_valid ? n : -1;
}

// acc[i][j] = sum_k A[m0 + 4ty + i, k] * B[k, col(4tx + j)] over the full depth K.
template <bool PAIRED>
__device__ __forceinline__ void tile_product(const float* __restrict__ A, int lda,
                                             int M, int K,
                                             const float* __restrict__ B, int ldb,
                                             int m0, int n0, int n_valid, float* As,
                                             float* Bs, float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float ra[4], rb[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, k = idx % BK;  // A: 64 rows x 16 deep
      const int m = m0 + r, ka = k0 + k;
      ra[i] = (m < M && ka < K) ? A[static_cast<size_t>(m) * lda + ka] : 0.f;
      const int kb = k0 + idx / BN;  // B: 16 deep x 64 columns
      const int col = source_col<PAIRED>(idx % BN, n0, n_valid);
      rb[i] = (kb < K && col >= 0) ? B[static_cast<size_t>(kb) * ldb + col] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      As[(buf * BK + idx % BK) * ASTR + idx / BK] = ra[i];
      Bs[(buf * BK + idx / BN) * BN + idx % BN] = rb[i];
    }
  };

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_stages = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int cur = s & 1;
    if (s + 1 < n_stages) load((s + 1) * BK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[(cur * BK + kk) * ASTR + 4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[(cur * BK + kk) * BN + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (s + 1 < n_stages) store(cur ^ 1);
    __syncthreads();
  }
}

// C[M, N] = relu(A[M, K] B[K, N] + bias[N]), row-major, ldc = N.
__global__ void __launch_bounds__(THREADS)
    dense_relu_kernel(const float* __restrict__ A, int lda,
                      const float* __restrict__ B, int ldb,
                      const float* __restrict__ bias, float* __restrict__ C, int M,
                      int N, int K) {
  __shared__ __align__(16) float As[2 * BK * ASTR];
  __shared__ __align__(16) float Bs[2 * BK * BN];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[4][4];
  tile_product<false>(A, lda, M, K, B, ldb, m0, n0, N, As, Bs, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) C[static_cast<size_t>(m) * N + n] = fmaxf(acc[i][j] + bias[n], 0.f);
    }
  }
}

// Stage 3: paired shift / log_scale tile, capped affine step, per-tile log_scale sums.
// partial[m, blockIdx.x] = sum of the (capped) log_scale of row m over this tile.
__global__ void __launch_bounds__(THREADS)
    coupling_out_kernel(const float* __restrict__ h2, int H,
                        const float* __restrict__ w3p, int ldw3,
                        const float* __restrict__ b3p,
                        const float* __restrict__ zt, float* __restrict__ y,
                        float* __restrict__ partial, int M, int dt, int n_tiles,
                        float cap, int inverse) {
  __shared__ __align__(16) float As[2 * BK * ASTR];
  __shared__ __align__(16) float Bs[2 * BK * BN];
  __shared__ float Cs[BM * CSTR];
  const int m0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * HALF;
  float acc[4][4];
  tile_product<true>(h2, H, M, H, w3p, ldw3, m0, j0, dt, As, Bs, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(4 * ty + i) * CSTR + 4 * tx + j] = acc[i][j];
  __syncthreads();

  // One warp per row, one lane per column pair (shift j, log_scale dt + j).
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = j0 + lane;
  const bool col_ok = j < dt;
  const float b_shift = col_ok ? b3p[j] : 0.f;
  const float b_ls = col_ok ? b3p[dt + j] : 0.f;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    float ls = 0.f;
    if (col_ok && m < M) {
      const float shift = Cs[r * CSTR + lane] + b_shift;
      ls = Cs[r * CSTR + HALF + lane] + b_ls;
      if (cap > 0.f) ls = cap * tanhf(ls / cap);
      const size_t at = static_cast<size_t>(m) * dt + j;
      const float z = zt[at];
      y[at] = inverse ? (z - shift) * expf(-ls) : z * expf(ls) + shift;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    if (lane == 0 && m < M) partial[static_cast<size_t>(m) * n_tiles + blockIdx.x] = ls;
  }
}

// log_det[m] = sign * sum_t partial[m, t], in tile order.
__global__ void row_sum_kernel(const float* __restrict__ partial, int n_tiles, int M,
                               float sign, float* __restrict__ log_det) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float* p = partial + static_cast<size_t>(m) * n_tiles;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += p[t];
  log_det[m] = sign * s;
}

}  // namespace

extern "C" {

// Number of stage-3 column tiles, i.e. the width of the `partial` workspace.
int coupling_partial_tiles(int dt) { return (dt + HALF - 1) / HALF; }

// Launches one coupling layer on `stream`: four kernels, no synchronisation.
// Workspaces h1, h2 [M, H] and partial [M, coupling_partial_tiles(dt)] are the
// caller's. Returns the first non-zero cudaGetLastError() (0 = all launched; an M
// past 65535 row tiles of gridDim.y is refused there).
int fused_coupling_apply_f32(const float* zc, const float* zt, const float* w1,
                             const float* b1, const float* w2, const float* b2,
                             const float* w3p, const float* b3p, float* y, float* ld,
                             float* h1, float* h2, float* partial, int M, int dc,
                             int dt, int H, int P, float cap, int inverse,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = (M + BM - 1) / BM;
  const dim3 grid_h((H + BN - 1) / BN, row_tiles);
  dense_relu_kernel<<<grid_h, THREADS, 0, s>>>(zc, dc, w1, H, b1, h1, M, H, dc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_relu_kernel<<<grid_h, THREADS, 0, s>>>(h1, H, w2, H, b2, h2, M, H, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = coupling_partial_tiles(dt);
  coupling_out_kernel<<<dim3(n_tiles, row_tiles), THREADS, 0, s>>>(
      h2, H, w3p, P, b3p, zt, y, partial, M, dt, n_tiles, cap, inverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_sum_kernel<<<(M + 255) / 256, 256, 0, s>>>(partial, n_tiles, M,
                                                 inverse ? -1.f : 1.f, ld);
  return static_cast<int>(cudaGetLastError());
}

const char* coupling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
