// Greedy primal upper bound of the training loss, for Hopper.
//
// Replaces the lax.scan of lapgnn_tpu/train/loss.py (_greedy_single,
// greedy_primal_upper), which has no Pallas kernel: XLA compiles the scan
// into one loop on the device.  For each instance b, rows are visited in a
// given order (the stable argsort of the masked row minima of the reduced
// costs, computed by the caller); each row takes the cheapest still-unused
// column of red[b] and adds cost[b, row, j] to the instance's total:
//
//   used = {}, total = 0
//   for row in order[b]:
//     j = argmin_j (used[j] ? +inf : red[b, row, j])   (first index on ties)
//     if valid[b, row]: used[j] = true
//     total = total + (valid[b, row] ? cost[b, row, j] : 0)
//
// The sum runs in float32 in visiting order, as the scan's carry does, so
// the kernel equals the plain version (and JAX) bit for bit.  A row whose
// unused entries are all +inf takes the first column whose value is +inf,
// used or not, as argmin does; a NaN counts as the smallest value and the
// first NaN wins (torch.argmin and jnp.argmin).
//
// Bound: the scan is sequential, n dependent steps an instance.  The bytes
// (red read once, B * n * n * 4) would take 5 us for one 2048 x 2048
// instance at 3.35 TB/s; each step has to finish a block-wide argmin
// before the next can mask its column, so the floor is n times the latency
// of one step: a row read from L2 plus two block barriers.  Design:
//   * one thread block per instance, up to 1024 threads striding along the
//     row, so a row is read coalesced, one or a few elements a thread;
//   * the used columns as a bitmap in shared memory;
//   * each step a (value, index) argmin: warp shuffles, then one merge of
//     the warps' partials in shared memory by warp 0;
//   * one thread marks the column and keeps the sum; the cost entry it
//     adds is loaded one step ahead of its use, so its latency hides under
//     the next step's scan;
//   * the next row's index and the next row itself (a prefetch into L2) are
//     requested while the current step runs.
// Instances run in parallel, one block each: B blocks on 132 SMs.
//
// C interface for ctypes: the launch returns its CUDA error code (0 when
// the launch was accepted).  No allocation, no synchronisation; it runs on
// the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kNoIndex = 0x7FFFFFFF;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

// Lexicographic (value, index) order with NaN smallest (torch.argmin).
__device__ __forceinline__ bool lex_less(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kAllLanes, v, off);
    const int oi = __shfl_xor_sync(kAllLanes, i, off);
    if (lex_less(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__global__ void __launch_bounds__(kMaxThreads)
greedy_kernel(const float* __restrict__ red, const float* __restrict__ cost,
              const int64_t* __restrict__ order, const uint8_t* __restrict__ valid,
              float* __restrict__ total, int n) {
  extern __shared__ unsigned used[];  // ceil(n / 32) words
  __shared__ float warp_val[kMaxWarps];
  __shared__ int warp_idx[kMaxWarps];

  const int b = blockIdx.x;
  const size_t nn = (size_t)n * (size_t)n;
  const float* R = red + (size_t)b * nn;
  const float* C = cost + (size_t)b * nn;
  const int64_t* ord = order + (size_t)b * n;
  const uint8_t* ok_row = valid ? valid + (size_t)b * n : nullptr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int words = (n + 31) >> 5;
  for (int w = tid; w < words; w += blockDim.x) used[w] = 0u;

  float sum = 0.0f;      // thread 0: the total so far
  float pending = 0.0f;  // thread 0: the entry of the last step, added next step
  int row = (int)ord[0];
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    const int next = t + 1 < n ? (int)ord[t + 1] : 0;
    const float* rrow = R + (size_t)row * n;
    if (t + 1 < n) {
      for (int j = tid * 32; j < n; j += blockDim.x * 32)
        prefetch_l2(R + (size_t)next * n + j);
    }
    const bool take = ok_row ? ok_row[row] != 0 : true;

    float bv = INFINITY;
    int bi = kNoIndex;
    for (int j = tid; j < n; j += blockDim.x) {
      const bool is_used = (used[j >> 5] >> (j & 31)) & 1u;
      const float x = is_used ? INFINITY : __ldg(rrow + j);
      if (lex_less(x, j, bv, bi)) {
        bv = x;
        bi = j;
      }
    }
    warp_argmin(bv, bi);
    if (lane == 0) {
      warp_val[warp] = bv;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < warps ? warp_val[lane] : INFINITY;
      bi = lane < warps ? warp_idx[lane] : kNoIndex;
      warp_argmin(bv, bi);
      if (lane == 0) {
        if (take) used[bi >> 5] |= 1u << (bi & 31);
        sum = sum + pending;
        pending = take ? C[(size_t)row * n + bi] : 0.0f;
      }
    }
    __syncthreads();
    row = next;
  }
  if (tid == 0) total[b] = sum + pending;
}

}  // namespace

extern "C" {

// red, cost: (B, n, n) float32, contiguous; order: (B, n) int64, each row a
// permutation of 0..n-1; valid: (B, n) bytes (0 / 1), or null for every row
// valid; total: (B,) float32.  threads: a multiple of 32 up to 1024.
int lapgnn_greedy_total(const float* red, const float* cost, const int64_t* order,
                        const uint8_t* valid, float* total, int B, int n, int threads,
                        cudaStream_t stream) {
  if (B < 1 || n < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned) * (size_t)((n + 31) / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_kernel<<<B, threads, smem, stream>>>(red, cost, order, valid, total, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
