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
// Bound: the kernel is held to its bytes bound (C read once, 13 floats a row
// written); in practice the selection's compare passes and the moment
// passes bound it.  Every element is compared against a candidate 96 times
// (three 32-step bisections) and goes through expf twice, logf and a
// division, all on a row that is long since in registers: several times the
// time the card needs to stream C.  What is scarce is the SM's operation
// rate (the integer pipe is half as wide as the float pipe) and, with a row
// spread over a block, barrier and shared-memory latency.  Design:
//   * the row lives in registers: a lane holds kItems = 64 slots, loaded as
//     16-byte vectors when m % 4 == 0 and the bases are aligned, all loads
//     requested before any use.  One warp owns a row of m <= 2048, so its
//     counts and sums combine by warp shuffles and `redux` with no barrier at
//     all; eight such rows make a block, and 128 registers a thread keep all
//     2048 rows of the main size resident in one wave.  Longer rows take
//     W = 2, 4 or 8 warps (m <= 2048 * W, one row a block) and join the W
//     partials through one small shared-memory exchange per step, in warp
//     order;
//   * the slots hold floats through the moment passes and become keys, in
//     place, for the selections;
//   * the median's and the rank-k selection run in the same 32 steps (two
//     candidates, two counts per pass over the registers); the MAD's
//     selection follows on keys of |x - med| computed once, in place.  A
//     count is the carry of key + (2^32 - candidate) fed into an add with
//     carry: one and a half integer operations a compare;
//   * a lane's slots past the row's end hold the key 0xFFFFFFFF, which is
//     never below a candidate, so the bisection needs no mask; every other
//     count, minimum and sum masks by index (a lane's valid items are a
//     prefix of its slots), never by value;
//   * the result is written channel by channel as it becomes known, so few
//     values stay live beside the 64 slots and no kernel spills;
//   * rows beyond 16384 keep the earlier design (row_features_smem_kernel):
//     one block of 256 threads per row, the row staged in dynamic shared
//     memory, keys recomputed on every pass.
// Mean, std and entropy are two-pass, as in the TPU kernel.  Float sums run
// in a fixed order (two accumulators a lane, a shuffle butterfly, then the
// warps in order), so the result is deterministic; that order differs from
// the plain PyTorch version's, hence its tolerance (rtol 2e-5, atol 2e-6).
// Selections, counts, min and max agree exactly.  A row holding NaN gets
// what the key order gives (a NaN sorts by its bit pattern), and fminf /
// fmaxf drop a NaN operand where torch propagates it, as before.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kChannels = 13;
constexpr float kEps = 1e-9f;
constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

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

// Output channels by name.
enum Channel {
  kMin = 0, kMax, kMean, kStd, kMad, kEntropy, kGap, kCompetition, kKMean,
  kKStd, kDifficulty, kNearBest, kIsColBest
};

// The nine channels that follow from the first two passes; one thread per
// row writes them as soon as they are known, so that the selections run
// with few values live.
__device__ __forceinline__ void write_moments(float* o, float r_min, float r_max,
                                              float mean, float stdev, float above,
                                              int min_cnt, int near_cnt,
                                              int col_best, int m) {
  const float inv_m = 1.0f / (float)m;
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
  o[kMin] = r_min;
  o[kMax] = r_max;
  o[kMean] = mean;
  o[kStd] = stdev;
  o[kGap] = gap;
  o[kCompetition] = competition;
  o[kDifficulty] = difficulty;
  o[kNearBest] = (float)near_cnt * inv_m;
  o[kIsColBest] = (float)col_best * inv_m;
}

// ---------------------------------------------------------------------------
// Register path: W warps hold a row of m <= kItems * 32 * W.

constexpr int kItems = 64;         // keys a lane holds
constexpr int kVecs = kItems / 4;  // as 16-byte vectors
constexpr int kRowsPerBlock = 8;   // one-warp rows in a block (W == 1)

template <typename T>
__device__ __forceinline__ uint32_t as_bits(T v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t u) {
  T v;
  memcpy(&v, &u, sizeof(v));
  return v;
}

// The W warps that share a row.  A reduction combines a warp by shuffles,
// then, for W > 1, the warps' partials in warp order through `slot`
// ([2][W][2] words of static shared memory).  The two halves of `slot` alternate,
// so one barrier per reduction is enough: a warp can only overwrite a half
// after every warp has passed the barrier of the reduction in between,
// hence after every read of that half.
template <int W>
struct Team {
  int parity;

  __device__ __forceinline__ uint32_t& at(int w, int c) {
    __shared__ uint32_t slot[2 * W * 2];
    return slot[(parity * W + w) * 2 + c];
  }
  __device__ __forceinline__ bool leads() const { return (threadIdx.x & 31) == 0; }
  __device__ __forceinline__ int warp() const { return threadIdx.x >> 5; }

  template <typename T, typename Op>
  __device__ __forceinline__ T reduce(T v, Op op) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kAllLanes, v, o));
    if (W > 1) {
      if (leads()) at(warp(), 0) = as_bits(v);
      __syncthreads();
      T r = from_bits<T>(at(0, 0));
#pragma unroll
      for (int w = 1; w < W; ++w) r = op(r, from_bits<T>(at(w, 0)));
      v = r;
      parity ^= 1;
    }
    return v;
  }

  // Two counts at once: the bisection's step.
  __device__ __forceinline__ void sum2(int& a, int& b) {
    a = __reduce_add_sync(kAllLanes, a);
    b = __reduce_add_sync(kAllLanes, b);
    if (W > 1) {
      if (leads()) {
        at(warp(), 0) = (uint32_t)a;
        at(warp(), 1) = (uint32_t)b;
      }
      __syncthreads();
      int ta = 0, tb = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        ta += (int)at(w, 0);
        tb += (int)at(w, 1);
      }
      a = ta;
      b = tb;
      parity ^= 1;
    }
  }

  __device__ __forceinline__ int sum1(int a) {
    int b = 0;
    sum2(a, b);
    return a;
  }
};

// c += key >= cand, as the carry of key + (2^32 - cand) fed into an add
// with carry (cand != 0).  The compiler folds two such carries into one
// add, so a compare costs one and a half integer operations; its own form
// of `c += key < cand` is a compare, an add and a predicated move.
__device__ __forceinline__ void count_not_below(int& c, uint32_t key,
                                                uint32_t neg_cand) {
  uint32_t sum;
  asm("add.cc.u32 %0, %2, %3;\n\taddc.s32 %1, %1, 0;"
      : "=r"(sum), "+r"(c)
      : "r"(key), "r"(neg_cand));
}

// Median from the rank-(mid+1) key (odd m) or the rank-mid key lo (even m),
// as _median_from_keys: hi = lo when lo repeats past rank mid
// (_next_distinct_or_same), else the smallest key above lo.  Slots past the
// row's end (i >= nv) hold kFull: they cannot lower `bigger`, but they
// would count as <= lo when lo is kFull itself, so `le` masks by index.
template <int W>
__device__ __forceinline__ float median_from(const uint32_t (&key)[kItems],
                                             int nv, int m, uint32_t sel,
                                             Team<W>& team) {
  if (m % 2 == 1) return from_key(sel);
  const uint32_t lo = sel;
  const int mid = m / 2;
  int le = 0;
  uint32_t bigger = kFull;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t k = key[i];
    le += (i < nv) && (k <= lo);
    if (k > lo) bigger = k < bigger ? k : bigger;
  }
  le = team.sum1(le);
  bigger = team.reduce(bigger, MinOp());
  const uint32_t hi = (le >= mid + 1) ? lo : bigger;
  return 0.5f * (from_key(lo) + from_key(hi));
}

// Threads of a block, and the blocks an SM must hold: 512 threads an SM, so
// at most 128 registers a thread, and the 2048 rows of the main size (16
// one-warp rows an SM) are resident in one wave.
constexpr int block_threads(int W) { return W == 1 ? 32 * kRowsPerBlock : 32 * W; }
constexpr int min_blocks(int W) { return 512 / block_threads(W); }

template <int W, bool kVec>
__global__ void __launch_bounds__(block_threads(W), min_blocks(W))
    row_features_reg_kernel(const float* __restrict__ C,
                            const float* __restrict__ colmin,
                            float* __restrict__ out, long long rows, int n,
                            int m, int k) {
  constexpr int T = 32 * W;  // threads that share the row
  Team<W> team;
  team.parity = 0;
  const int t = W == 1 ? (int)(threadIdx.x & 31) : (int)threadIdx.x;
  // b * n + i; the caller keeps rows below 2^31
  const int r = W == 1 ? (int)(blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5))
                       : (int)blockIdx.x;
  if (r >= rows) return;  // W == 1 only: a whole warp, and no barrier follows
  const float* src = C + (long long)r * m;
  const float* cm = colmin + (long long)(r / n) * m;
  const float inv_m = 1.0f / (float)m;

  // Pass 0: the row into registers, nothing else, so that all of a lane's
  // loads are in flight together.  Slot i of thread t is element
  // (q*T + t)*4 + c with i = 4q + c (vector layout) or element i*T + t
  // (scalar layout); either way the valid slots are the first nv.  The
  // slots hold the floats' bits through the moment passes and become keys
  // for the selections.
  uint32_t key[kItems];
  const int m4 = m >> 2;
  int nv;
  if (kVec) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    nv = t < m4 ? 4 * ((m4 - t + T - 1) / T) : 0;
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const int vi = q * T + t;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vi < m4) x = __ldg(src4 + vi);
      key[4 * q] = __float_as_uint(x.x);
      key[4 * q + 1] = __float_as_uint(x.y);
      key[4 * q + 2] = __float_as_uint(x.z);
      key[4 * q + 3] = __float_as_uint(x.w);
    }
  } else {
    nv = t < m ? (m - t + T - 1) / T : 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * T + t;
      key[i] = j < m ? __float_as_uint(__ldg(src + j)) : 0u;
    }
  }

  // Pass 1: min, max, sum, is-col-best.  Slots are visited in groups of
  // four (one vector); in the vector layout a group is valid or not as a
  // whole.
  float lmin = INFINITY, lmax = -INFINITY;
  float acc[2] = {0.0f, 0.0f};
  int lcb = 0;
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    if (4 * q < nv) {
      float ws[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kVec) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(cm) + q * T + t);
        ws[0] = w.x, ws[1] = w.y, ws[2] = w.z, ws[3] = w.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * q + c;
        if (kVec || i < nv) {
          const float x = __uint_as_float(key[i]);
          const float w = kVec ? ws[c] : __ldg(cm + i * T + t);
          lmin = fminf(lmin, x);
          lmax = fmaxf(lmax, x);
          acc[c & 1] += x;
          lcb += x == w;
        }
      }
    }
  }
  // the row's output, recomputed at each write rather than kept live
  const auto o = [=]() { return out + (long long)r * kChannels; };
  const float r_min = team.reduce(lmin, MinOp());
  const float r_max = team.reduce(lmax, MaxOp());
  const float mean =
      team.reduce(acc[0] + acc[1], SumOp()) * inv_m;
  const int col_best = team.sum1(lcb);

  // Pass 2: squared deviations, softmax mass, near-best, second smallest.
  const float near_thr = r_min * 1.1f;
  float sq[2] = {0.0f, 0.0f};
  float se[2] = {0.0f, 0.0f};
  float labove = INFINITY;
  int lnear = 0, lmincnt = 0;
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    if (4 * q < nv) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * q + c;
        if (kVec || i < nv) {
          const float x = __uint_as_float(key[i]);
          const float d = x - mean;
          sq[c & 1] += d * d;
          const float ex = expf(-(x - r_min));
          se[c & 1] += ex;
          lnear += x <= near_thr;
          lmincnt += x == r_min;
          if (x > r_min) labove = fminf(labove, x);
        }
      }
    }
  }
  const float sqs = team.reduce(sq[0] + sq[1], SumOp());
  const float denom =
      team.reduce(se[0] + se[1], SumOp()) + kEps;
  const float above = team.reduce(labove, MinOp());
  team.sum2(lnear, lmincnt);
  if (t == 0)
    write_moments(o(), r_min, r_max, mean, sqrtf(fmaxf(sqs * inv_m, 0.0f)), above,
                  lmincnt, lnear, col_best, m);

  // Pass 3: entropy in its literal form -sum p log(p + EPS).
  float lh[2] = {0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    if (4 * q < nv) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * q + c;
        if (kVec || i < nv) {
          const float ex = expf(-(__uint_as_float(key[i]) - r_min));
          const float p = ex / denom;
          lh[c & 1] += p * logf(p + kEps);
        }
      }
    }
  }
  const float entropy =
      -team.reduce(lh[0] + lh[1], SumOp());
  if (t == 0) o()[kEntropy] = entropy;

  // The slots become keys; those past the row's end the largest key.
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    key[i] = (i < nv) ? to_key(__uint_as_float(key[i])) : kFull;

  // The median's rank and rank k in the same 32 steps (_kth_key twice).
  // Invariant per selection: prefix <= answer < prefix + 2^(bit+1).
  const int mid = m / 2;
  const int rank_a = (m % 2 == 1) ? mid + 1 : mid;
  uint32_t pa = 0, pb = 0;
  int c_lt = 0;  // keys below pb: the count at the step that last raised it
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t ca = pa | (1u << bit);
    const uint32_t cb = pb | (1u << bit);
    // count the keys not below each candidate; the rest of the lane's
    // kItems slots are below it (a slot past the row's end never is)
    const uint32_t nca = 0u - ca, ncb = 0u - cb;
    int ga0 = 0, ga1 = 0, gb0 = 0, gb1 = 0;
#pragma unroll
    for (int i = 0; i < kItems; i += 2) {
      count_not_below(ga0, key[i], nca);
      count_not_below(gb0, key[i], ncb);
      count_not_below(ga1, key[i + 1], nca);
      count_not_below(gb1, key[i + 1], ncb);
    }
    int na = kItems - (ga0 + ga1), nb = kItems - (gb0 + gb1);
    team.sum2(na, nb);
    pa = (na >= rank_a) ? pa : ca;
    if (nb < k) {
      pb = cb;
      c_lt = nb;
    }
  }
  const float med = median_from<W>(key, nv, m, pa, team);

  // k smallest, tie-exact: T = rank-k value, sum_{x<T} x + (k - #{x<T}) T.
  // A slot past the row's end is never below t_key.
  const uint32_t t_key = pb;
  const float Tk = from_key(t_key);
  // At most k - 1 keys of the row lie below t_key.  The slots are taken
  // sixteen at a time behind a warp vote: a group without such a key is
  // skipped, and the compiler cannot hoist the conversions of all slots
  // ahead of the sum's chain, which costs registers it does not have.
  float lks = 0.0f;
#pragma unroll
  for (int g = 0; g < kItems; g += 16) {
    bool any = false;
#pragma unroll
    for (int i = g; i < g + 16; ++i) any = any || key[i] < t_key;
    if (__any_sync(kAllLanes, any)) {
#pragma unroll
      for (int i = g; i < g + 16; ++i)
        if (key[i] < t_key) lks += from_key(key[i]);
    }
  }
  const float ks = team.reduce(lks, SumOp());
  const float take = (float)(k - c_lt);
  const float k_mean = (ks + take * Tk) / (float)k;
  float lksd = 0.0f;
#pragma unroll
  for (int g = 0; g < kItems; g += 16) {
    bool any = false;
#pragma unroll
    for (int i = g; i < g + 16; ++i) any = any || key[i] < t_key;
    if (__any_sync(kAllLanes, any)) {
#pragma unroll
      for (int i = g; i < g + 16; ++i) {
        if (key[i] < t_key) {
          const float d = from_key(key[i]) - k_mean;
          lksd += d * d;
        }
      }
    }
  }
  const float ksd = team.reduce(lksd, SumOp());
  const float dT = Tk - k_mean;
  if (t == 0) {
    o()[kKMean] = k_mean;
    o()[kKStd] = sqrtf(fmaxf((ksd + take * dT * dT) / (float)k, 0.0f));
  }

  // MAD: the keys of |x - med| replace the row's keys, then one selection.
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    key[i] = (i < nv) ? to_key(fabsf(from_key(key[i]) - med)) : kFull;
  uint32_t pd = 0;
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cd = pd | (1u << bit);
    const uint32_t ncd = 0u - cd;
    int g0 = 0, g1 = 0, g2 = 0, g3 = 0;
#pragma unroll
    for (int i = 0; i < kItems; i += 4) {
      count_not_below(g0, key[i], ncd);
      count_not_below(g1, key[i + 1], ncd);
      count_not_below(g2, key[i + 2], ncd);
      count_not_below(g3, key[i + 3], ncd);
    }
    const int nd = team.sum1(kItems - ((g0 + g1) + (g2 + g3)));
    pd = (nd >= rank_a) ? pd : cd;
  }
  const float mad = fmaxf(median_from<W>(key, nv, m, pd, team), kEps);
  if (t == 0) o()[kMad] = mad;
}

// ---------------------------------------------------------------------------
// Shared-memory path: any m whose row fits the block's dynamic shared memory.

constexpr int kThreads = 256;

// Block-wide reduction; every thread gets the result.  scratch holds one
// value per warp.  The warp partials are combined in warp order, so the
// result does not depend on scheduling.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kAllLanes, v, o));
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

// Median of the row's keys, as _median_from_keys (see median_from above).
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
    row_features_smem_kernel(const float* __restrict__ C,
                             const float* __restrict__ colmin,
                             float* __restrict__ out, int n, int m, int k) {
  extern __shared__ float row[];
  __shared__ Scratch s;
  const long long r = blockIdx.x;  // b * n + i
  const long long b = r / n;
  const float* src = C + r * m;
  const float* cm = colmin + b * m;
  const float inv_m = 1.0f / (float)m;
  float* o = out + r * kChannels;

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
  if (threadIdx.x == 0)
    write_moments(o, r_min, r_max, mean, sqrtf(fmaxf(sq * inv_m, 0.0f)), above,
                  min_cnt, near_cnt, col_best, m);

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
  if (threadIdx.x == 0) {
    o[kMad] = mad;
    o[kEntropy] = entropy;
    o[kKMean] = k_mean;
    o[kKStd] = sqrtf(fmaxf((ksd + take * dT * dT) / (float)k, 0.0f));
  }
}

template <int W, bool kVec>
cudaError_t launch_reg(const float* C, const float* colmin, float* out,
                       long long rows, int n, int m, int k, cudaStream_t s) {
  const long long blocks =
      W == 1 ? (rows + kRowsPerBlock - 1) / kRowsPerBlock : rows;
  row_features_reg_kernel<W, kVec>
      <<<(unsigned)blocks, block_threads(W), 0, s>>>(C, colmin, out, rows, n, m, k);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_reg_w(const float* C, const float* colmin, float* out,
                         long long rows, int n, int m, int k, int vec,
                         cudaStream_t s) {
  return vec ? launch_reg<W, true>(C, colmin, out, rows, n, m, k, s)
             : launch_reg<W, false>(C, colmin, out, rows, n, m, k, s);
}

}  // namespace

extern "C" {

// C: (B, n, m) f32 contiguous; colmin: (B, m) column minima of C;
// out: (B, n, 13).  k = min(10, m).  warps_per_row selects the path: 1, 2, 4
// or 8 for the register path (m <= 2048 * warps_per_row), 0 for the
// shared-memory path.  vec != 0 selects 16-byte loads on the register path
// (m % 4 == 0, C and colmin 16-byte aligned).  Returns a cudaError_t.
int lapgnn_row_features_stats(const float* C, const float* colmin, float* out,
                              int B, int n, int m, int k, int warps_per_row,
                              int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * n;
  if (warps_per_row == 0) {
    const size_t smem = sizeof(float) * (size_t)m;
    cudaError_t err = cudaFuncSetAttribute(
        row_features_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    row_features_smem_kernel<<<(unsigned)rows, kThreads, smem, s>>>(
        C, colmin, out, n, m, k);
    return static_cast<int>(cudaGetLastError());
  }
  if (m > kItems * 32 * warps_per_row)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (m % 4 != 0 || reinterpret_cast<uintptr_t>(C) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(colmin) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (warps_per_row) {
    case 1: err = launch_reg_w<1>(C, colmin, out, rows, n, m, k, vec, s); break;
    case 2: err = launch_reg_w<2>(C, colmin, out, rows, n, m, k, vec, s); break;
    case 4: err = launch_reg_w<4>(C, colmin, out, rows, n, m, k, vec, s); break;
    case 8: err = launch_reg_w<8>(C, colmin, out, rows, n, m, k, vec, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

// Largest m whose row fits this device's opt-in shared memory per block on
// the shared-memory path, after the kernel's static shared memory.
// Negative: a CUDA error code.
int lapgnn_row_features_max_m(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, row_features_smem_kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (optin - (int)attr.sharedSizeBytes) / (int)sizeof(float);
}

}  // extern "C"
