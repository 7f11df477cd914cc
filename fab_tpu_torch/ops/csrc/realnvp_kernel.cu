// Fused RealNVP chain (forward or inverse) with log-det, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fab_tpu/ops/realnvp_kernel.py:fused_realnvp_pass
// (body `_kernel`). Same function, same operand order and layout:
//   x [B, D]; w1 [L, dc, H]; b1 [L, H]; w2 [L, H, H]; b2 [L, H];
//   w3 [L, H, 2*dt]; b3 [L, 2*dt]; wlin [L, D, D]; lu_ld [L]
// with dt = D - dc. Per layer: h1 = relu(zc W1 + b1), h2 = relu(h1 W2 + b2),
// o = h2 W3 + b3 = (shift, log_scale); zt <- zt * exp(ls) + shift (forward) or
// (zt - shift) * exp(-ls) (inverse); then z <- z Wlin^T; log_det +/-= sum(ls) and
// +/- lu_ld. The inverse walks the layers in reverse, LU mix first.
//
// What bounds it: at the ManyWell-32 shapes (B=2048, D=32, H=320, L=10) one pass is
// ~4.9 GFLOP of f32 FMAs against ~5 MB of weights and activations, so it is bound
// by the f32 FMA rate of the CUDA cores, not by memory.
//
// Design: the TPU kernel keeps every layer's weights in VMEM; here the weights
// (~4.8 MB) cannot fit one SM's shared memory but stay resident in the 50 MB L2.
// Each block owns ROWS rows of the batch and keeps their activations (z, h1, h2, o)
// in shared memory, transposed to [feature][row] so that one thread reads the ROWS
// values of a feature as float4 broadcasts. A thread owns one output column of a
// dense layer and accumulates all ROWS rows in registers while it streams the
// weight column from L2 (row-major [in, out] weights: neighbouring threads read
// neighbouring addresses). The narrow last layer (2*dt columns) splits its K
// dimension over thread groups and reduces in shared memory. Bias, ReLU, the
// affine step, the LU mix and the per-row log-det are fused into the same pass,
// so nothing but x, the weights, y and log_det touches device memory.
// Arithmetic is plain f32 (no TF32, no tensor cores).

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;  // batch rows per block

// out_T[j][r] = act(b[j] + sum_k in_T[k][r] * w[k, j]) for j < N; one column per thread.
template <bool RELU>
__device__ __forceinline__ void dense_cols(const float* in_T, int K,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b, int N,
                                           float* out_T) {
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc[ROWS];
    const float bj = __ldg(b + j);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = bj;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float wk = __ldg(w + static_cast<size_t>(k) * N + j);
      const float4* a = reinterpret_cast<const float4*>(in_T + k * ROWS);
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 f = a[q];
        acc[4 * q + 0] = fmaf(f.x, wk, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(f.y, wk, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(f.z, wk, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(f.w, wk, acc[4 * q + 3]);
      }
    }
    float4* o = reinterpret_cast<float4*>(out_T + j * ROWS);
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      float4 v = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      if (RELU) {
        v.x = fmaxf(v.x, 0.f);
        v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f);
        v.w = fmaxf(v.w, 0.f);
      }
      o[q] = v;
    }
  }
}

// out_T[j][r] = b[j] + sum_k in_T[k][r] * w[k, j] for a narrow N (blockDim >= N):
// blockDim / N thread groups each sum a slice of K into part, then one pass reduces.
__device__ __forceinline__ void dense_splitk(const float* in_T, int K,
                                             const float* __restrict__ w,
                                             const float* __restrict__ b, int N,
                                             float* out_T, float* part) {
  const int groups = blockDim.x / N;
  const int g = threadIdx.x / N;
  const int j = threadIdx.x % N;
  if (g < groups) {
    const int chunk = (K + groups - 1) / groups;
    const int k0 = g * chunk;
    const int k1 = min(K, k0 + chunk);
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int k = k0; k < k1; ++k) {
      const float wk = __ldg(w + static_cast<size_t>(k) * N + j);
      const float4* a = reinterpret_cast<const float4*>(in_T + k * ROWS);
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 f = a[q];
        acc[4 * q + 0] = fmaf(f.x, wk, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(f.y, wk, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(f.z, wk, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(f.w, wk, acc[4 * q + 3]);
      }
    }
    float4* p = reinterpret_cast<float4*>(part + (g * N + j) * ROWS);
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q)
      p[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();
  for (int it = threadIdx.x; it < N * ROWS; it += blockDim.x) {
    const int jj = it / ROWS;
    const int r = it % ROWS;
    float s = __ldg(b + jj);
    for (int gg = 0; gg < groups; ++gg) s += part[(gg * N + jj) * ROWS + r];
    out_T[jj * ROWS + r] = s;
  }
}

__global__ void realnvp_chain_kernel(const float* __restrict__ x,
                                     const float* __restrict__ w1,
                                     const float* __restrict__ b1,
                                     const float* __restrict__ w2,
                                     const float* __restrict__ b2,
                                     const float* __restrict__ w3,
                                     const float* __restrict__ b3,
                                     const float* __restrict__ wlin,
                                     const float* __restrict__ lu_ld,
                                     float* __restrict__ y, float* __restrict__ ld_out,
                                     int B, int D, int dc, int H, int L, int inverse) {
  extern __shared__ float4 smem4[];
  const int dt = D - dc;
  const int N3 = 2 * dt;
  float* z = reinterpret_cast<float*>(smem4);  // [D][ROWS]
  float* tmp = z + D * ROWS;                     // [D][ROWS]
  float* h1 = tmp + D * ROWS;                    // [H][ROWS]
  float* h2 = h1 + H * ROWS;                     // [H][ROWS]
  float* o = h2 + H * ROWS;                      // [2*dt][ROWS]
  float* part = o + N3 * ROWS;                   // [blockDim][ROWS]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;

  // Load the tile (rows past B are zero and never stored).
  for (int it = tid; it < D * ROWS; it += blockDim.x) {
    const int r = it / D;
    const int k = it % D;
    const int row = row0 + r;
    z[k * ROWS + r] = row < B ? x[static_cast<size_t>(row) * D + k] : 0.f;
  }
  float ld = 0.f;  // log-det of row `tid`, held by threads tid < ROWS
  __syncthreads();

  for (int s = 0; s < L; ++s) {
    const int l = inverse ? L - 1 - s : s;
    const float* W1 = w1 + static_cast<size_t>(l) * dc * H;
    const float* B1 = b1 + static_cast<size_t>(l) * H;
    const float* W2 = w2 + static_cast<size_t>(l) * H * H;
    const float* B2 = b2 + static_cast<size_t>(l) * H;
    const float* W3 = w3 + static_cast<size_t>(l) * H * N3;
    const float* B3 = b3 + static_cast<size_t>(l) * N3;
    const float* WL = wlin + static_cast<size_t>(l) * D * D;
    const float lu = __ldg(lu_ld + l);

    for (int half = 0; half < 2; ++half) {
      const bool do_lu = inverse ? half == 0 : half == 1;
      if (do_lu) {
        // z <- z Wlin^T (Wlin holds W^-1 on the inverse).
        for (int it = tid; it < D * ROWS; it += blockDim.x) {
          const int i = it / ROWS;
          const int r = it % ROWS;
          const float* wrow = WL + i * D;
          float acc = 0.f;
          for (int k = 0; k < D; ++k) acc = fmaf(z[k * ROWS + r], __ldg(wrow + k), acc);
          tmp[i * ROWS + r] = acc;
        }
        __syncthreads();
        for (int it = tid; it < D * ROWS; it += blockDim.x) z[it] = tmp[it];
        if (tid < ROWS) ld = inverse ? ld - lu : ld + lu;
        __syncthreads();
      } else {
        dense_cols<true>(z, dc, W1, B1, H, h1);
        __syncthreads();
        dense_cols<true>(h1, H, W2, B2, H, h2);
        __syncthreads();
        dense_splitk(h2, H, W3, B3, N3, o, part);
        __syncthreads();
        for (int it = tid; it < dt * ROWS; it += blockDim.x) {
          const int c = it / ROWS;
          const int r = it % ROWS;
          const float shift = o[c * ROWS + r];
          const float ls = o[(dt + c) * ROWS + r];
          float* zt = z + (dc + c) * ROWS + r;
          *zt = inverse ? (*zt - shift) * expf(-ls) : *zt * expf(ls) + shift;
        }
        if (tid < ROWS) {
          float sum = 0.f;
          for (int c = 0; c < dt; ++c) sum += o[(dt + c) * ROWS + tid];
          ld = inverse ? ld - sum : ld + sum;
        }
        __syncthreads();
      }
    }
  }

  for (int it = tid; it < D * ROWS; it += blockDim.x) {
    const int r = it / D;
    const int k = it % D;
    const int row = row0 + r;
    if (row < B) y[static_cast<size_t>(row) * D + k] = z[k * ROWS + r];
  }
  if (tid < ROWS && row0 + tid < B) ld_out[row0 + tid] = ld;
}

}  // namespace

extern "C" {

// Launches one fused pass on `stream`. Returns cudaGetLastError() (0 = launched).
int fused_realnvp_pass_f32(const float* x, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3,
                           const float* b3, const float* wlin, const float* lu_ld,
                           float* y, float* ld, int B, int D, int dc, int H, int L,
                           int inverse, int threads, void* stream) {
  const int dt = D - dc;
  const size_t smem =
      static_cast<size_t>(2 * D + 2 * H + 2 * dt + threads) * ROWS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      realnvp_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + ROWS - 1) / ROWS);
  realnvp_chain_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, w3, b3, wlin, lu_ld, y, ld, B, D, dc, H, L, inverse);
  return static_cast<int>(cudaGetLastError());
}

const char* realnvp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
