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
// Bound: device-memory bytes (C and v read once, three (n,) vectors
// written).  In practice two things hold it above that bound.  At the
// solver's size (n = 2048, 16 MB, resident in L2 between ARR rounds) the
// whole read lasts a few microseconds, of which launch, ramp and tail are a
// good part: a row reduction of the same matrix by the framework takes as
// long.  And the compares are not free: about ten integer-pipe operations
// a column, on a pipe half as wide as the float pipe, which is as much time
// as the bytes take once the matrix streams from device memory at full
// rate.  Design:
//   * one warp per row striding along it, eight rows a block; C is
//     row-major, so every load is coalesced; 16-byte loads when m % 4 == 0
//     and both bases are 16-byte aligned, 4-byte loads otherwise; the loop
//     is unrolled so that four loads of C and four of v are requested before
//     the first compare;
//   * the compare state of a lane is branch-free (KeyState): the reduced
//     cost becomes an order key on which NaN is smallest and -0.0 equals
//     +0.0, and the two smallest (key, column) pairs are kept by integer
//     min / max / select.  Lanes merge through five butterfly shuffles of
//     the pairs as 64-bit words.  min1 and min2 are then the elements at the
//     two columns, read again, so their bits are the gather form's;
//   * for a matrix that does not fit in L2 the earlier state (FloatState:
//     float compares with a branch per column, fewer integer operations
//     on the common path) is faster and is kept; the caller chooses;
//   * NaN follows torch.argmin: a NaN counts as the smallest value and the
//     first NaN wins; min2 is NaN when any other column is NaN (amin
//     propagates NaN), and +-inf order as usual; equal values at two columns
//     give min2 == min1, as the masked form does;
//   * the argmin is written as int32 directly (no float round trip, so the
//     TPU kernel's n < 2^24 limit does not apply).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNoIndex = 0x7FFFFFFF;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kTopKey = 0xFFFFFFFFu;

// Order key of a reduced cost x = c - w, as torch.argmin orders floats: NaN
// below everything, -0.0 equal to +0.0.  Adding +0.0 turns -0.0 into +0.0;
// the usual order-isomorphic map of f32 onto uint32 follows (negatives
// bit-inverted, positives sign-flipped); the result of a float operation on
// a NaN is the canonical NaN 0x7FFFFFFF, whose image 0xFFFFFFFF the final
// + 1 wraps to 0, below the image of -inf.  No key is 0xFFFFFFFF.
__device__ __forceinline__ uint32_t order_key(float c, float w) {
  const uint32_t u = __float_as_uint((c - w) + 0.0f);
  return (u ^ ((uint32_t)((int32_t)u >> 31) | kSign)) + 1u;
}

__device__ __forceinline__ unsigned long long pack(uint32_t k, int j) {
  return ((unsigned long long)k << 32) | (uint32_t)j;
}
__device__ __forceinline__ unsigned long long min64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long max64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? b : a;
}

// The two smallest (key, column) pairs of the columns seen so far, in
// lexicographic order: (k1, j1) is the first argmin, (k2, j2) the smallest
// of the rest (k2 == k1 on a tie).  Everything is branch-free integer
// min / max / select, a few operations a column with short dependence
// chains, because at the solver's size the compares, not the bytes, are
// what the SMs wait for.
struct KeyState {
  uint32_t k1, k2;
  int j1, j2;

  __device__ __forceinline__ void init() {
    k1 = k2 = kTopKey;
    j1 = j2 = kNoIndex;
  }

  // Column j comes after every column seen so far by this lane, so a
  // strict compare keeps the first index among equals.
  __device__ __forceinline__ void push(float c, float w, int j) {
    const uint32_t k = order_key(c, w);
    const bool lt1 = k < k1;
    const bool lt2 = k < k2;
    j2 = lt1 ? j1 : (lt2 ? j : j2);
    k2 = min(k2, max(k1, k));
    j1 = lt1 ? j : j1;
    k1 = min(k1, k);
  }

  // Another partial of the same row, over any other set of columns: the
  // smaller first pair wins, and the second is the smallest of the loser's
  // first pair and both seconds.  Pairs are distinct (columns differ), so
  // 64-bit (key, column) words order them.
  __device__ __forceinline__ void merge(unsigned long long o1, unsigned long long o2) {
    const unsigned long long p1 = pack(k1, j1), p2 = pack(k2, j2);
    const unsigned long long n1 = min64(p1, o1);
    const unsigned long long n2 = min64(max64(p1, o1), min64(p2, o2));
    k1 = (uint32_t)(n1 >> 32);
    j1 = (int)(uint32_t)n1;
    k2 = (uint32_t)(n2 >> 32);
    j2 = (int)(uint32_t)n2;
  }

  __device__ __forceinline__ void merge_lanes() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o1 = __shfl_xor_sync(kAllLanes, pack(k1, j1), off);
      const unsigned long long o2 = __shfl_xor_sync(kAllLanes, pack(k2, j2), off);
      merge(o1, o2);
    }
  }

  // min1 and min2 are the elements at the two columns themselves, read
  // again: the bits of the gather form, the sign of a zero and a NaN
  // included.  A row of one column has no second: +inf.
  __device__ __forceinline__ void write(const float* crow, const float* vb,
                                        float* min1, float* min2,
                                        int32_t* argmin, long long o) const {
    min1[o] = crow[j1] - vb[j1];
    min2[o] = j2 == kNoIndex ? INFINITY : crow[j2] - vb[j2];
    argmin[o] = j1;
  }
};

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

// The same two minima kept as floats: (m1, i1) the first argmin, m2 the
// minimum of the rest.
struct FloatState {
  float m1;
  int i1;
  float m2;

  __device__ __forceinline__ void init() {
    m1 = m2 = INFINITY;
    i1 = kNoIndex;
  }

  // Column j comes after every column seen so far by this lane.
  __device__ __forceinline__ void push(float c, float w, int j) {
    const float x = c - w;
    if (lex_less(x, j, m1, i1)) {
      m2 = nan_min(m1, m2);
      m1 = x;
      i1 = j;
    } else {
      m2 = nan_min(m2, x);
    }
  }

  // The winner keeps its m1 and i1; the new m2 is the minimum of the
  // loser's m1 and both m2.
  __device__ __forceinline__ void merge(float om1, int oi1, float om2) {
    if (lex_less(om1, oi1, m1, i1)) {
      m2 = nan_min(m1, nan_min(m2, om2));
      m1 = om1;
      i1 = oi1;
    } else {
      m2 = nan_min(m2, nan_min(om1, om2));
    }
  }

  __device__ __forceinline__ void merge_lanes() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om1 = __shfl_xor_sync(kAllLanes, m1, off);
      const int oi1 = __shfl_xor_sync(kAllLanes, i1, off);
      const float om2 = __shfl_xor_sync(kAllLanes, m2, off);
      merge(om1, oi1, om2);
    }
  }

  __device__ __forceinline__ void write(const float*, const float*, float* min1,
                                        float* min2, int32_t* argmin,
                                        long long o) const {
    min1[o] = m1;
    min2[o] = m2;
    argmin[o] = i1;
  }
};

// The four columns 4q .. 4q+3 of one 16-byte vector.
template <typename State>
__device__ __forceinline__ void push4(State& s, const float4& c, const float4& w,
                                      int q) {
  const int j = q << 2;
  s.push(c.x, w.x, j);
  s.push(c.y, w.y, j + 1);
  s.push(c.z, w.z, j + 2);
  s.push(c.w, w.w, j + 3);
}

// One warp per row.  kUnroll loads of C and of v are requested before the
// first compare; a lane's columns still come in increasing order.
template <typename State, bool kVec4, int kUnroll>
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

  State s;
  s.init();
  if (kVec4) {
    const float4* c4 = reinterpret_cast<const float4*>(crow);
    const float4* v4 = reinterpret_cast<const float4*>(vb);
    const int m4 = m >> 2;
    int q = lane;
    for (; q + 32 * (kUnroll - 1) < m4; q += 32 * kUnroll) {
      float4 c[kUnroll], w[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        c[i] = __ldg(c4 + q + 32 * i);
        w[i] = __ldg(v4 + q + 32 * i);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) push4(s, c[i], w[i], q + 32 * i);
    }
    for (; q < m4; q += 32) push4(s, __ldg(c4 + q), __ldg(v4 + q), q);
  } else {
    int j = lane;
    for (; j + 32 * (kUnroll - 1) < m; j += 32 * kUnroll) {
      float c[kUnroll], w[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        c[i] = __ldg(crow + j + 32 * i);
        w[i] = __ldg(vb + j + 32 * i);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) s.push(c[i], w[i], j + 32 * i);
    }
    for (; j < m; j += 32) s.push(__ldg(crow + j), __ldg(vb + j), j);
  }

  s.merge_lanes();
  if (lane == 0) s.write(crow, vb, min1, min2, argmin, (long long)b * n + row);
}

template <typename State>
cudaError_t launch(const float* C, const float* v, float* min1, float* min2,
                   int32_t* argmin, int B, int n, int m, int vec, int unroll,
                   cudaStream_t s) {
  const dim3 grid((n + kWarps - 1) / kWarps, B);
  if (unroll == 4) {
    if (vec) {
      twomin_kernel<State, true, 4><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
    } else {
      twomin_kernel<State, false, 4><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
    }
  } else if (unroll == 1) {
    if (vec) {
      twomin_kernel<State, true, 1><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
    } else {
      twomin_kernel<State, false, 1><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// C: (B, n, m) f32 contiguous; v: (B, m) f32 contiguous; min1, min2: (B, n)
// f32; argmin: (B, n) int32.  The caller chooses the geometry: `vec` != 0
// for 16-byte loads (m % 4 == 0, C and v 16-byte aligned), `unroll` 1 or 4
// loads requested ahead, `float_state` != 0 for the float compare state instead
// of the integer keys.  Returns a cudaError_t.
int lapgnn_two_min(const float* C, const float* v, float* min1, float* min2,
                   int32_t* argmin, int B, int n, int m, int vec, int unroll,
                   int float_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec && (m % 4 != 0 || reinterpret_cast<uintptr_t>(C) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(v) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      float_state ? launch<FloatState>(C, v, min1, min2, argmin, B, n, m, vec, unroll, s)
                  : launch<KeyState>(C, v, min1, min2, argmin, B, n, m, vec, unroll, s));
}

}  // extern "C"
