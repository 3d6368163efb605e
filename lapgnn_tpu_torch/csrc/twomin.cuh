// Device code of the per-row two-minimum of C - v (K4), shared by the K4
// kernel (csrc/twomin.cu) and the Jacobi-ARR kernel's bid (csrc/arr.cu), so
// that both compute the same bits.  The compare states, the order keys and
// their reasons are documented in csrc/twomin.cu.  Also the (value, index)
// order and the NaN-propagating minimum that the solver kernels
// (csrc/augment.cu) reduce with.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lapgnn {

constexpr int kNoIndex = 0x7FFFFFFF;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kTopKey = 0xFFFFFFFFu;

// How a row scan reads v.  K4's v is read-only for the whole launch; the
// persistent ARR kernel keeps a block-local copy of v (in the block's shared
// memory, or in a region of device memory that only the block writes), which
// the block itself lowers between its rounds: plain loads.
struct ReadOnlyV {
  template <typename U>
  __device__ __forceinline__ static U scan(const U* p) { return __ldg(p); }
  template <typename U>
  __device__ __forceinline__ static U at(const U* p) { return *p; }
};
struct LocalV {
  template <typename U>
  __device__ __forceinline__ static U scan(const U* p) { return *p; }
  template <typename U>
  __device__ __forceinline__ static U at(const U* p) { return *p; }
};

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
  template <typename V>
  __device__ __forceinline__ void result(const float* crow, const float* vb, float& m1,
                                         float& m2, int& arg) const {
    m1 = crow[j1] - V::at(vb + j1);
    m2 = j2 == kNoIndex ? INFINITY : crow[j2] - V::at(vb + j2);
    arg = j1;
  }
};

// Lexicographic (value, index) order with NaN smallest (torch.argmin).
template <typename T>
__device__ __forceinline__ bool lex_less(T a, int ia, T b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

// Minimum that propagates NaN (amin).
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (isnan(a) || a < b) ? a : b;
}

// The same two minima kept as floats (float or double): (m1, i1) the first
// argmin, m2 the minimum of the rest.
template <typename T>
struct FloatState {
  T m1;
  int i1;
  T m2;

  __device__ __forceinline__ void init() {
    m1 = m2 = INFINITY;
    i1 = kNoIndex;
  }

  // Column j comes after every column seen so far by this lane.
  __device__ __forceinline__ void push(T c, T w, int j) {
    const T x = c - w;
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
  __device__ __forceinline__ void merge(T om1, int oi1, T om2) {
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
      const T om1 = __shfl_xor_sync(kAllLanes, m1, off);
      const int oi1 = __shfl_xor_sync(kAllLanes, i1, off);
      const T om2 = __shfl_xor_sync(kAllLanes, m2, off);
      merge(om1, oi1, om2);
    }
  }

  template <typename V>
  __device__ __forceinline__ void result(const T*, const T*, T& a, T& b, int& arg) const {
    a = m1;
    b = m2;
    arg = i1;
  }
};

// The four columns 4q .. 4q+3 of one 16-byte vector.
template <typename State>
__device__ __forceinline__ void push4(State& s, const float4& c, const float4& w, int q) {
  const int j = q << 2;
  s.push(c.x, w.x, j);
  s.push(c.y, w.y, j + 1);
  s.push(c.z, w.z, j + 2);
  s.push(c.w, w.w, j + 3);
}

// One warp's scan of one row of m columns into the lane's state: kUnroll
// loads of C and of v are requested before the first compare; a lane's
// columns still come in increasing order.  16-byte loads (kVec4) are float
// only.  The lanes' states are merged afterwards (merge_lanes).
template <typename T, typename State, bool kVec4, int kUnroll, typename V>
__device__ __forceinline__ void scan_row(State& s, const T* __restrict__ crow,
                                         const T* __restrict__ vb, int m, int lane) {
  static_assert(!kVec4 || sizeof(T) == 4, "16-byte loads are float only");
  if constexpr (kVec4) {
    const float4* c4 = reinterpret_cast<const float4*>(crow);
    const float4* v4 = reinterpret_cast<const float4*>(vb);
    const int m4 = m >> 2;
    int q = lane;
    for (; q + 32 * (kUnroll - 1) < m4; q += 32 * kUnroll) {
      float4 c[kUnroll], w[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        c[i] = __ldg(c4 + q + 32 * i);
        w[i] = V::scan(v4 + q + 32 * i);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) push4(s, c[i], w[i], q + 32 * i);
    }
    for (; q < m4; q += 32) push4(s, __ldg(c4 + q), V::scan(v4 + q), q);
  } else {
    int j = lane;
    for (; j + 32 * (kUnroll - 1) < m; j += 32 * kUnroll) {
      T c[kUnroll], w[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        c[i] = __ldg(crow + j + 32 * i);
        w[i] = V::scan(vb + j + 32 * i);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) s.push(c[i], w[i], j + 32 * i);
    }
    for (; j < m; j += 32) s.push(__ldg(crow + j), V::scan(vb + j), j);
  }
}

}  // namespace lapgnn
