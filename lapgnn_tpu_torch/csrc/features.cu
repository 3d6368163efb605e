// Row-feature statistics (K3) for Hopper: the 13 statistic channels of the
// 21-D OneGNN row features in one read of C.
//
// Replaces the Pallas kernel lapgnn_tpu/ops/pallas/features.py:
// pallas_row_features_stats (body _feature_kernel).  Channels, in order:
//   min, max, mean, std, MAD, entropy, second-best gap, competition,
//   k-smallest mean, k-smallest std, difficulty, near-best density,
//   is-col-best.
// Exact median, MAD and k-th smallest come from a 32-step bisection on the
// order-isomorphic uint32 image of f32 (no sort), with the same key map and
// the same selection identities as the JAX kernel (_to_key, _kth_key,
// _next_distinct_or_same, _median_from_keys).
//
// Bound: arithmetic, not bytes.  C is read from device memory once, but each
// element is then visited ~100 times (three 32-step bisections plus the
// moment, entropy and k-sum passes), each visit a key map, a compare and an
// add.  Design:
//   * one block per row (grid = B * n), the row staged once in dynamic shared
//     memory (4 * m bytes: 8 KB at m = 2048, 32 KB at m = 8192), so every
//     later pass reads shared memory only;
//   * keys, and for the MAD the keys of |x - med|, are recomputed from the
//     staged floats on every pass instead of being stored, which keeps the
//     shared footprint at one row;
//   * every bisection step ends in one block-wide count (warp shuffles, then
//     one partial per warp combined in a fixed order).
// Mean, std and entropy are two-pass, as in the TPU kernel.  Float sums run in
// another order than the plain PyTorch version, hence its tolerance (rtol 2e-5,
// atol 2e-6); selections, counts, min and max agree exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 13;
constexpr float kEps = 1e-9f;
constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t to_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & kSign) ? (kFull - u) : (u | kSign);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & kSign) ? (k ^ kSign) : (kFull - k));
}

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fminf(a, b);
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a < b ? a : b;
  }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

// Block-wide reduction; every thread gets the result.  scratch holds one
// value per warp.  The warp partials are combined in warp order, so the
// result does not depend on scheduling.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w) r = op(r, scratch[w]);
  __syncthreads();  // all reads of scratch finish before it is reused
  return r;
}

struct Scratch {
  float f[kThreads / 32];
  int i[kThreads / 32];
  uint32_t u[kThreads / 32];
};

// Key of element x: of x itself, or of |x - med| for the MAD.
template <bool kDev>
__device__ __forceinline__ uint32_t key_of(float x, float med) {
  return kDev ? to_key(fabsf(x - med)) : to_key(x);
}

// Exact rank-kk (1-indexed) smallest key of the row (_kth_key).
// Invariant: prefix <= answer < prefix + 2^(bit+1).
template <bool kDev>
__device__ uint32_t kth_key(const float* row, int m, int kk, float med,
                            Scratch& s) {
  uint32_t prefix = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = prefix | (1u << bit);
    int c = 0;
    for (int j = threadIdx.x; j < m; j += kThreads)
      c += key_of<kDev>(row[j], med) < cand;
    c = block_reduce(c, SumOp(), s.i);
    prefix = (c >= kk) ? prefix : cand;
  }
  return prefix;
}

// Median of the row's keys, as _median_from_keys: the rank-(mid+1) key for
// odd m; for even m the rank-mid key lo and hi = lo when lo repeats past rank
// mid (_next_distinct_or_same), else the smallest key above lo.
template <bool kDev>
__device__ float median_of(const float* row, int m, float med, Scratch& s) {
  const int mid = m / 2;
  if (m % 2 == 1) return from_key(kth_key<kDev>(row, m, mid + 1, med, s));
  const uint32_t lo = kth_key<kDev>(row, m, mid, med, s);
  int le = 0;
  uint32_t bigger = kFull;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const uint32_t k = key_of<kDev>(row[j], med);
    le += k <= lo;
    if (k > lo) bigger = k < bigger ? k : bigger;
  }
  le = block_reduce(le, SumOp(), s.i);
  bigger = block_reduce(bigger, MinOp(), s.u);
  const uint32_t hi = (le >= mid + 1) ? lo : bigger;
  return 0.5f * (from_key(lo) + from_key(hi));
}

__global__ void __launch_bounds__(kThreads)
    row_features_kernel(const float* __restrict__ C,
                        const float* __restrict__ colmin,
                        float* __restrict__ out, int n, int m, int k) {
  extern __shared__ float row[];
  __shared__ Scratch s;
  const long long r = blockIdx.x;  // b * n + i
  const long long b = r / n;
  const float* src = C + r * m;
  const float* cm = colmin + b * m;
  const float inv_m = 1.0f / (float)m;

  // Pass 1: stage the row; min, max, sum, is-col-best count.
  float lmin = INFINITY, lmax = -INFINITY, lsum = 0.0f;
  int lcb = 0;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float x = src[j];
    row[j] = x;
    lmin = fminf(lmin, x);
    lmax = fmaxf(lmax, x);
    lsum += x;
    lcb += x == cm[j];
  }
  const float r_min = block_reduce(lmin, MinOp(), s.f);
  const float r_max = block_reduce(lmax, MaxOp(), s.f);
  const float mean = block_reduce(lsum, SumOp(), s.f) * inv_m;
  const int col_best = block_reduce(lcb, SumOp(), s.i);

  // Pass 2: squared deviations, softmax mass, near-best, second smallest.
  const float near_thr = r_min * 1.1f;
  float lsq = 0.0f, lexp = 0.0f, labove = INFINITY;
  int lnear = 0, lmincnt = 0;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float x = row[j];
    const float d = x - mean;
    lsq += d * d;
    lexp += expf(-(x - r_min));
    lnear += x <= near_thr;
    lmincnt += x == r_min;
    if (x > r_min) labove = fminf(labove, x);
  }
  const float sq = block_reduce(lsq, SumOp(), s.f);
  const float denom = block_reduce(lexp, SumOp(), s.f) + kEps;
  const float above = block_reduce(labove, MinOp(), s.f);
  const int near_cnt = block_reduce(lnear, SumOp(), s.i);
  const int min_cnt = block_reduce(lmincnt, SumOp(), s.i);
  const float stdev = sqrtf(fmaxf(sq * inv_m, 0.0f));

  // Pass 3: entropy in its literal form -sum p log(p + EPS).
  float lh = 0.0f;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float p = expf(-(row[j] - r_min)) / denom;
    lh += p * logf(p + kEps);
  }
  const float entropy = -block_reduce(lh, SumOp(), s.f);

  // Exact selections.
  const float med = median_of<false>(row, m, 0.0f, s);
  const float mad = fmaxf(median_of<true>(row, m, med, s), kEps);

  // k smallest, tie-exact: T = rank-k value, sum_{x<T} x + (k - #{x<T}) T.
  const uint32_t t_key = kth_key<false>(row, m, k, 0.0f, s);
  const float T = from_key(t_key);
  float lks = 0.0f;
  int llt = 0;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float x = row[j];
    if (to_key(x) < t_key) {
      lks += x;
      ++llt;
    }
  }
  const float ks = block_reduce(lks, SumOp(), s.f);
  const int c_lt = block_reduce(llt, SumOp(), s.i);
  const float take = (float)(k - c_lt);
  const float k_mean = (ks + take * T) / (float)k;
  float lksd = 0.0f;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float x = row[j];
    if (to_key(x) < t_key) {
      const float d = x - k_mean;
      lksd += d * d;
    }
  }
  const float ksd = block_reduce(lksd, SumOp(), s.f);
  const float dT = T - k_mean;
  const float k_std = sqrtf(fmaxf((ksd + take * dT * dT) / (float)k, 0.0f));

  if (threadIdx.x == 0) {
    const float second = min_cnt > 1 ? r_min : above;
    const float span = r_max - r_min;
    float gap = second - r_min;
    float competition = gap / (span + kEps);
    float difficulty = 0.0f;
    if (m >= 2) {
      // the mean consecutive sorted difference telescopes to span / (m - 1)
      difficulty = 1.0f / (span / (float)(m - 1) + kEps);
    } else {
      gap = 0.0f;
      competition = 0.0f;
    }
    float* o = out + r * kChannels;
    o[0] = r_min;
    o[1] = r_max;
    o[2] = mean;
    o[3] = stdev;
    o[4] = mad;
    o[5] = entropy;
    o[6] = gap;
    o[7] = competition;
    o[8] = k_mean;
    o[9] = k_std;
    o[10] = difficulty;
    o[11] = (float)near_cnt * inv_m;
    o[12] = (float)col_best * inv_m;
  }
}

}  // namespace

extern "C" {

// C: (B, n, m) f32 contiguous; colmin: (B, m) column minima of C;
// out: (B, n, 13).  k = min(10, m).  Returns cudaGetLastError().
int lapgnn_row_features_stats(const float* C, const float* colmin, float* out,
                              int B, int n, int m, int k, void* stream) {
  const size_t smem = sizeof(float) * (size_t)m;
  cudaError_t err = cudaFuncSetAttribute(
      row_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = (long long)B * n;
  row_features_kernel<<<(unsigned)rows, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(C, colmin, out, n,
                                                             m, k);
  return static_cast<int>(cudaGetLastError());
}

// Largest m whose row fits this device's opt-in shared memory per block,
// after the kernel's static shared memory.  Negative: a CUDA error code.
int lapgnn_row_features_max_m(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, row_features_kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (optin - (int)attr.sharedSizeBytes) / (int)sizeof(float);
}

}  // extern "C"
