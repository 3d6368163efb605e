// Column minimum (K1) and fused min-trick (K2) for Hopper.
//
// Replaces the Pallas kernels of lapgnn_tpu/ops/pallas/colmin.py:
//   pallas_col_min   (_colmin_kernel):   out_j = min_i C_ij
//   pallas_min_trick (_mintrick_kernel): v_j   = min_i (C_ij - u_i)
//
// Bound: device-memory bytes.  Each call reads C once (B*n*m*4 bytes) and
// does one subtraction and one comparison per element, far below the card's
// arithmetic rate.  The TPU kernel carries a running minimum across a
// sequential grid; Hopper's blocks run in no order, so here:
//   * each thread owns one column, so a warp reads 128 contiguous bytes of a
//     row (coalesced) and the (C - u) intermediate never leaves registers;
//   * grid.y cuts the rows into chunks, enough blocks to fill all SMs even
//     when B * ceil(m / 256) is small;
//   * each block writes its partial minima to a (B, chunks, m) scratch, and a
//     second small launch reduces the chunks.
// A minimum is exact in any order, so the result equals the plain PyTorch
// version (C - u[:, None]).amin(0) bit for bit.  NaN propagates as in amin.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nan_min(float acc, float x) {
  // amin semantics: a NaN anywhere makes the minimum NaN.
  return (x < acc || isnan(x)) ? x : acc;
}

template <bool kHasU>
__global__ void __launch_bounds__(kThreads)
    colmin_partial(const float* __restrict__ C, const float* __restrict__ u,
                   float* __restrict__ part, int n, int m, int rows_per_chunk) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= m) return;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  const float* col = C + ((long long)b * n) * m + j;
  const float* ub = kHasU ? u + (long long)b * n : nullptr;
  float acc = INFINITY;
  for (int i = r0; i < r1; ++i) {
    float x = col[(long long)i * m];
    if (kHasU) x = x - ub[i];
    acc = nan_min(acc, x);
  }
  part[((long long)b * gridDim.y + chunk) * m + j] = acc;
}

__global__ void __launch_bounds__(kThreads)
    colmin_finish(const float* __restrict__ part, float* __restrict__ out,
                  int chunks, int m) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= m) return;
  const float* p = part + (long long)b * chunks * m + j;
  float acc = INFINITY;
  for (int c = 0; c < chunks; ++c) acc = nan_min(acc, p[(long long)c * m]);
  out[(long long)b * m + j] = acc;
}

}  // namespace

extern "C" {

// C: (B, n, m) f32 contiguous; u: (B, n) f32 or null (plain column min);
// part: (B, chunks, m) scratch; out: (B, m).  Returns cudaGetLastError().
int lapgnn_colmin(const float* C, const float* u, float* part, float* out,
                  int B, int n, int m, int chunks, int rows_per_chunk,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kThreads - 1) / kThreads, chunks, B);
  if (u != nullptr) {
    colmin_partial<true><<<grid, kThreads, 0, s>>>(C, u, part, n, m,
                                                   rows_per_chunk);
  } else {
    colmin_partial<false><<<grid, kThreads, 0, s>>>(C, u, part, n, m,
                                                    rows_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((m + kThreads - 1) / kThreads, B);
  colmin_finish<<<grid2, kThreads, 0, s>>>(part, out, chunks, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
