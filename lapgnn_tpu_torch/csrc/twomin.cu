// Per-row two-minimum of C - v (K4) for Hopper.
//
// Replaces the Pallas kernel of lapgnn_tpu/ops/pallas/twomin.py
// (pallas_two_min / _twomin_kernel): for each row i of red = C - v[None, :],
//   argmin1_i = the first column attaining the row minimum,
//   min1_i    = red[i, argmin1_i],
//   min2_i    = the minimum of red[i, j] over j != argmin1_i,
// in one read of C.  It is the bid of every Jacobi-ARR round of the device
// solver (solver/seeded.py:jacobi_arr).
//
// Bound: device-memory bytes.  One call reads C once and v once and writes
// three (n,) vectors; the one subtraction and two compares per element are
// far below the card's arithmetic rate.  Design:
//   * one warp per row: C is row-major, so the 32 lanes stride along the row
//     and every load is coalesced; 16-byte loads (float4) when m % 4 == 0
//     and both rows and v are 16-byte aligned, 4-byte loads otherwise;
//   * each lane keeps (min1, idx1, min2) over the columns it reads, in
//     increasing column order, and the lanes merge through five butterfly
//     shuffles by the lexicographic rule on (value, index): the winner keeps
//     its min1 and idx1, and the new min2 is the minimum of the loser's
//     min1, the winner's min2 and the loser's min2.  Equal values at two
//     columns therefore give min2 == min1, as the masked form does;
//   * NaN follows torch.argmin: a NaN counts as the smallest value and the
//     first NaN wins; min2 is NaN when any other column is NaN (amin
//     propagates NaN), and +-inf order as usual;
//   * the argmin is written as int32 directly (no float round trip, so the
//     TPU kernel's n < 2^24 limit does not apply).
// min1 is the element at argmin1 itself, so it equals the gather form
// red.gather(argmin) bit for bit; min2 is a minimum, exact in any order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kNoIndex = 0x7FFFFFFF;

// Lexicographic (value, index) order with NaN smallest (torch.argmin).
__device__ __forceinline__ bool lex_less(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

// Minimum that propagates NaN (amin).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

struct TwoMin {
  float m1;
  int i1;
  float m2;

  // Column j comes after every column seen so far by this lane.
  __device__ __forceinline__ void push(float x, int j) {
    if (lex_less(x, j, m1, i1)) {
      m2 = nan_min(m1, m2);
      m1 = x;
      i1 = j;
    } else {
      m2 = nan_min(m2, x);
    }
  }

  __device__ __forceinline__ void merge(float om1, int oi1, float om2) {
    if (lex_less(om1, oi1, m1, i1)) {
      m2 = nan_min(m1, nan_min(m2, om2));
      m1 = om1;
      i1 = oi1;
    } else {
      m2 = nan_min(m2, nan_min(om1, om2));
    }
  }
};

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    twomin_kernel(const float* __restrict__ C, const float* __restrict__ v,
                  float* __restrict__ min1, float* __restrict__ min2,
                  int32_t* __restrict__ argmin, int n, int m) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (row >= n) return;
  const float* crow = C + ((long long)b * n + row) * m;
  const float* vb = v + (long long)b * m;

  TwoMin s{INFINITY, kNoIndex, INFINITY};
  if (kVec4) {
    const float4* c4 = reinterpret_cast<const float4*>(crow);
    const float4* v4 = reinterpret_cast<const float4*>(vb);
    const int m4 = m >> 2;
    for (int k = lane; k < m4; k += 32) {
      const float4 c = c4[k];
      const float4 w = __ldg(v4 + k);
      const int j = k << 2;
      s.push(c.x - w.x, j);
      s.push(c.y - w.y, j + 1);
      s.push(c.z - w.z, j + 2);
      s.push(c.w - w.w, j + 3);
    }
  } else {
    for (int j = lane; j < m; j += 32) s.push(crow[j] - __ldg(vb + j), j);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om1 = __shfl_xor_sync(0xFFFFFFFFu, s.m1, off);
    const int oi1 = __shfl_xor_sync(0xFFFFFFFFu, s.i1, off);
    const float om2 = __shfl_xor_sync(0xFFFFFFFFu, s.m2, off);
    s.merge(om1, oi1, om2);
  }
  if (lane == 0) {
    const long long o = (long long)b * n + row;
    min1[o] = s.m1;
    min2[o] = s.m2;
    argmin[o] = s.i1;
  }
}

}  // namespace

extern "C" {

// C: (B, n, m) f32 contiguous; v: (B, m) f32 contiguous; min1, min2: (B, n)
// f32; argmin: (B, n) int32.  vec4 != 0 selects 16-byte loads (the caller
// checks m % 4 == 0 and 16-byte alignment of C and v).  Returns
// cudaGetLastError().
int lapgnn_two_min(const float* C, const float* v, float* min1, float* min2,
                   int32_t* argmin, int B, int n, int m, int vec4,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kWarps - 1) / kWarps, B);
  if (vec4) {
    twomin_kernel<true><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
  } else {
    twomin_kernel<false><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
