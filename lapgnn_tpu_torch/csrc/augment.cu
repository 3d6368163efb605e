// Min-plus sweep augmentation of the device solver (S1) for Hopper: the whole
// of augment_all_sweep in one cooperative launch.
//
// Replaces lapgnn_tpu/solver/jv.py:augment_all_sweep (:533), which is a
// lax.while_loop of rounds (:223, at most n + 1), each with a
// lax.while_loop of Bellman-Ford sweeps (:346, at most n + 1) and the
// disjoint-path flip (:437, a while_loop over the candidates, each path a
// bounded walk; the uncapped single flip :410 when nothing flipped).  No
// Pallas kernel stands behind it: XLA runs the loops on the device.  Each
// round, in the JAX order:
//   u_i   = the row minimum of C - v for a free row, C[i, x_i] - v[x_i] else;
//   red   = max((C - v) - u, 0), +0.0 for both zeros, NaN kept;
//   d0, pred0 = the column minimum over the free rows of red, first row;
//   sweeps: d_k <- min(d_k, min_i (e_i + red_ik)), e_i = d[x_i] (+inf for a
//     free row), first row; until nothing at or below the best free
//     column's distance (within 8 eps) changed, or n + 1 sweeps;
//   delta = the least distance of a free column; v <- (v + min(d, delta)) -
//     delta; the candidates are the free columns within 8 eps (1 + |delta|)
//     of delta;
//   the flip: candidates lowest first, each path walked at most 64 hops
//     and skipped if it touches a row used this round; when nothing
//     flipped, the first candidate's path uncapped, at most n + 1 steps.
//
// What bounds it.  A round's C, u and v do not change during its sweeps, so
// a sweep needs one grid barrier, the exchange of the n new distances and a
// pass over red.  At uniform n = 2048 that is about 1,300 sweeps over a
// 16.8 MB matrix, which the grid's shared memory holds whole; one read of C
// from device memory is far below the sweeps' floor, which is their
// barriers (timed alone by lapgnn_augment_barrier_bench: about 1.8 us with
// the stop test's words on an H100) plus a shared-memory pass a sweep.
//
// Design.  The grid is cooperative (every block resident).  Columns are cut
// into tiles, each reduced by one block over every row, so a column's
// minimum and first row need no combine across blocks; the minimum is under
// lex_less (value, then row; NaN first), a total order, so a tile's row
// groups merge pairwise in any order to the same bits, and float64 takes
// the same code.  Data that other blocks write during the launch (x, y, v,
// u, d, pred, the candidates) is read through L2 (__ldcg): an SM's L1 is not
// coherent.  The flip is a serial pointer walk and runs on one warp of block
// 0 (its lane 0 walks; the lanes find the candidates in order by ballots),
// between two grid barriers.  The thresholds round twice, as the eager
// kernels do (__fmul_rn / __fadd_rn, and the library is built with
// --fmad=false).
//
// One grid barrier a sweep carries the stop test (csrc/grid_barrier.cuh), in
// every layout.  Warp 0 of each block holds the block's columns; it folds
// them into three words of the sweep's parity with order-preserving
// integer-key atomics: the free columns' least new d (NaN first: every NaN
// has key 0, one class), the improved columns' least new d (never NaN:
// `best < old` is false for NaN) and whether any column improved.  The block
// that arrives last resets the other parity's words; after the barrier every
// block reads the three words, so every block decides alike.  d is never
// -0.0 (red is clamped to +0.0 and e is +0.0 or more), so the keys' order of
// the two zeros does not matter.  The rounds' other barriers are the same
// barrier without the words.
//
// Layouts, chosen on the host by n, the type and the SM count
// (ops/cuda/augment.py):
//  - resident (where it fits: n up to 2,508 in float32 and 1,729 in float64
//    on 132 SMs).  Each block owns one tile of max(8, ceil(n / SMs)) columns
//    (up to 32, any count; the last tile may be narrower) and keeps it in
//    shared memory, all n rows, row-major [row][column] w wide.  Thread
//    t < w G (G = min(256 / w, n) row groups) takes column t % w and rows
//    t / w, t / w + G, ...: a warp reads consecutive words of the tile, so no
//    two lanes share a bank (float64: two wavefronts, the least for 8-byte
//    words).  Each round the block loads its tile of C by TMA
//    (cp.async.bulk.tensor completing on an mbarrier, where the rows are
//    16-byte aligned and 16-byte multiples wide; coalesced loads else),
//    issued before the round's row potentials so that the copy overlaps
//    them, and then writes red in place of C (red is what every sweep
//    reads; C is reloaded once a round, 41 rounds against 1,286 sweeps at
//    uniform 2048 from min-trick seeds).  Each sweep copies the new d into
//    shared memory with 16-byte loads through L2 and gathers e_i = d[x_i]
//    there, in place of n scattered L2 reads a block, and lists the rows
//    whose e changed: only they can improve a column (e only falls, and a
//    row whose e did not change was taken when it last did, so
//    d_k <= e_i + red_ik already), about a fifth of the rows a sweep at
//    uniform 2048.  NaN is the least value under lex_less and never improves
//    a distance, so a column with a NaN in red (flagged once a round), or a
//    sweep with a NaN in e, improves nothing, and the pass compares the
//    listed rows with a plain `<` in row order.  A column's d and pred stay
//    in its owner thread's registers.  The round's u lies in the space of e
//    until the sweeps start, and the list in the space of d once e is
//    gathered.
//  - staged: the round's u and x and the sweep's e in shared memory
//    ((2 sizeof(T) + 4) n bytes, n up to 19,370 in float32, 11,622 in
//    float64), C read through L2 in every pass; a block reduces tiles of 8,
//    16 or 32 columns.
//  - unstaged (above): the row pass also writes x as int to device memory,
//    the grid writes e there at the start of each sweep (one more grid
//    barrier a sweep), and the passes read u, x and e through L2.
// All three give the same x, y, v and loop counts, bit for bit.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "grid_barrier.cuh"
#include "twomin.cuh"

namespace cg = cooperative_groups;

namespace {

using lapgnn::kAllLanes;
using lapgnn::kNoIndex;
using lapgnn::lex_less;
using lapgnn::nan_min;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPathCap = 64;   // jv.py's _PATH_CAP
constexpr int kAhead = 8;      // loads requested ahead a thread
constexpr int kMaxWidth = 32;  // a resident tile's widest: its owners are warp 0
constexpr int kMaxBox = 256;   // rows of a TMA box at most

enum Layout { kUnstaged = 0, kStaged = 1, kResident = 2 };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename U>
__device__ __forceinline__ U ld(const U* p) {
  return __ldcg(p);
}

// The stop test's order key of a distance, widened to double (exact for a
// float): 0 for NaN, below every other key; else the bits with the sign bit
// set when positive and every bit inverted when negative.
constexpr unsigned long long kTop = 1ull << 63;
constexpr unsigned long long kInfKey = 0xFFF0000000000000ull;  // stop_key(+inf)

__device__ __forceinline__ unsigned long long stop_key(double x) {
  if (isnan(x)) return 0;
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  return (b & kTop) ? ~b : (b | kTop);
}

__device__ __forceinline__ double stop_value(unsigned long long k) {
  if (k == 0) return __longlong_as_double(0x7FF8000000000000ll);
  return __longlong_as_double((long long)((k & kTop) ? (k ^ kTop) : ~k));
}

// One sweep's words: the free columns' least key, the improved columns'
// least key, any improvement; two sets, by the parity of the launch's sweep.
constexpr int kStopWords = 4;

__device__ __forceinline__ void reset_stop(unsigned long long* w) {
  lapgnn::st_relaxed_gpu(w + 0, kInfKey);
  lapgnn::st_relaxed_gpu(w + 1, kInfKey);
  lapgnn::st_relaxed_gpu(w + 2, 0ull);
}

template <typename T>
struct Aug {
  CUtensorMap tmap;    // C as a 2-D tensor for TMA (resident layout, tma_rows > 0)
  const T* C;          // (n, n) row-major
  long long* x;        // (n,) column of each row, -1 free; updated in place
  long long* y;        // (n,) row of each column, -1 free; updated in place
  T* v;                // (n,) column duals; updated in place
  T* u;                // (n,) the round's row potentials
  T* d[2];             // (n,) distances, the sweep's old and new
  int* pred[2];        // (n,) the row each distance came through
  unsigned char* cand; // (n,) the round's candidate sinks
  unsigned char* used; // (n,) rows used by the round's flips
  T* e;                // (n,) the sweep's e (unstaged layout)
  int* xr;             // (n,) the round's x as int (unstaged layout)
  unsigned* bar;       // the grid barrier's words
  unsigned long long* stop;  // 2 x kStopWords: the stop test's words
  int* go;             // another round
  long long* counts;   // += rounds, sweeps, flip steps
  int n;
  int tile;            // columns a tile
  int tma_rows;        // rows of a TMA box (resident layout; 0: coalesced loads)
  T tol;               // 8 eps: the sweep's stop test and the candidates
};

// A per-row vector of the round: from shared memory (staged), or from the
// device memory other blocks wrote, through L2.
template <bool kShared, typename U>
__device__ __forceinline__ U row_ld(const U* p) {
  return kShared ? *p : __ldcg(p);
}

// Reduced cost of (i, k): ((C_ik - v_k) - u_i), +0.0 where it is <= 0.
template <typename T>
__device__ __forceinline__ T reduced(T c, T vk, T ui) {
  const T r = (c - vk) - ui;
  return r <= T(0) ? T(0) : r;
}

// lex_less(val, i, best, brow) for a row i after brow: NaN first, the
// earlier row on a tie.
template <typename T>
__device__ __forceinline__ bool later_takes(T val, T best) {
  return !isnan(best) && !(val >= best);
}

// Merges a tile's row groups: thread t < w G wrote its (best, row) to
// red_v / red_i [t]; they merge pairwise, halving the groups each step
// (lex_less is a total order, so any order gives the same bits), and thread
// col < w ends with its column's.
template <typename T>
__device__ __forceinline__ void merge_groups(int w, int groups, T* red_v, int* red_i, T& best,
                                             int& brow) {
  __syncthreads();
  for (int span = groups; span > 1;) {
    const int half = (span + 1) >> 1;
    if (threadIdx.x < (span - half) * w) {
      const T ov = red_v[threadIdx.x + half * w];
      const int oi = red_i[threadIdx.x + half * w];
      if (lex_less(ov, oi, best, brow)) {
        best = ov;
        brow = oi;
        red_v[threadIdx.x] = ov;
        red_i[threadIdx.x] = oi;
      }
    }
    span = half;
    __syncthreads();
  }
  if (groups == 1) __syncthreads();
}

// The column minimum over every row, first row on ties, NaN smallest, of
// one tile's columns (staged and unstaged layouts): kSweep, e_i + red_ik;
// else (d0) red_ik for a free row and +inf for a matched one.  Threads
// (col, rg) stride the rows; thread col < tile of the block ends with its
// column's (best, row).  u_r, e_r and x_r are the round's rows (shared or
// device memory, by kShared).
template <typename T, bool kSweep, bool kShared>
__device__ __forceinline__ void tile_min(const Aug<T>& a, int k0, const T* u_r, const T* e_r,
                                         const int* x_r, T* red_v, int* red_i, T& best,
                                         int& brow) {
  const int n = a.n, tw = a.tile, rgs = kThreads / tw;
  const int col = threadIdx.x % tw, rg = threadIdx.x / tw;
  const int k = k0 + col;
  best = INFINITY;
  brow = kNoIndex;
  if (k < n) {
    const T vk = ld(a.v + k);
    const T* ck = a.C + k;
    auto push = [&](T c, int i) {
      const T r = reduced(c, vk, row_ld<kShared>(u_r + i));
      const T val = kSweep ? row_ld<kShared>(e_r + i) + r
                           : (row_ld<kShared>(x_r + i) < 0 ? r : T(INFINITY));
      if (lex_less(val, i, best, brow)) {
        best = val;
        brow = i;
      }
    };
    int i = rg;
    for (; i + (kAhead - 1) * rgs < n; i += kAhead * rgs) {
      T c[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) c[q] = __ldg(ck + (long long)(i + q * rgs) * n);
#pragma unroll
      for (int q = 0; q < kAhead; ++q) push(c[q], i + q * rgs);
    }
    for (; i < n; i += rgs) push(__ldg(ck + (long long)i * n), i);
  }
  red_v[threadIdx.x] = best;
  red_i[threadIdx.x] = brow;
  merge_groups(tw, rgs, red_v, red_i, best, brow);
}

// Whether a row is free, over the warp: any(x < 0), kAhead loads in flight
// a lane.
__device__ __forceinline__ bool any_free(const long long* x, int n, int lane) {
  bool f = false;
  for (int i0 = 0; i0 < n; i0 += 32 * kAhead) {
    long long xi[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int i = i0 + 32 * q + lane;
      xi[q] = i < n ? ld(x + i) : 0;
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) f |= xi[q] < 0;
  }
  return __any_sync(kAllLanes, f);
}

// The flips of one round (jv.py:437, :410), on one warp: the candidates
// lowest first, each path from pred walked by lane 0 into rows / cols
// (shared memory, kPathCap each).  Returns the steps.
template <typename T>
__device__ __forceinline__ long long flip_paths(const Aug<T>& a, const int* pred, int lane,
                                                int* rows, int* cols) {
  const int n = a.n;
  for (int i = lane; i < n; i += 32) a.used[i] = 0;
  __syncwarp();
  long long steps = 0;
  int first = -1;
  bool flipped = false;
  for (int base0 = 0; base0 < n; base0 += 32 * kAhead) {
    // the candidates of kAhead ballots, loaded before the first walk
    unsigned masks[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int jl = base0 + 32 * q + lane;
      masks[q] = jl < n ? ld(a.cand + jl) : 0;
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) masks[q] = __ballot_sync(kAllLanes, masks[q] != 0);
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      unsigned mask = masks[q];
      while (mask) {
        const int j0 = base0 + 32 * q + __ffs(mask) - 1;
        mask &= mask - 1;
        if (first < 0) first = j0;
        if (lane == 0) {
          int j = j0, len = 0;
          bool ok = true, done = false;
          while (!done && ok && len < kPathCap) {
            const int i = ld(pred + j);
            ok = a.used[i] == 0;
            rows[len] = i;
            cols[len] = j;
            ++len;
            const long long nj = ld(a.x + i);
            done = nj < 0;
            j = (int)nj;
          }
          steps += len;
          if (ok && done) {
            for (int l = 0; l < len; ++l) {
              a.x[rows[l]] = cols[l];
              a.y[cols[l]] = rows[l];
              a.used[rows[l]] = 1;
            }
            flipped = true;
          }
        }
        __syncwarp();
      }
    }
  }
  if (lane == 0 && first >= 0 && !flipped) {
    // nothing flipped, so x and y are still the round's: the first sink's
    // path, uncapped
    int j = first;
    long long k = 0;
    bool done = false;
    while (!done && k <= n) {
      const int i = ld(pred + j);
      const long long nj = ld(a.x + i);
      a.y[j] = i;
      a.x[i] = j;
      done = nj < 0;
      ++k;
      j = (int)nj;
    }
    steps += k;
  }
  __syncwarp();
  return steps;
}

// The sweep's stop test, the same in every layout: warp 0 holds the block's
// column partials (f, m, any), folds them into the words of parity `set`
// and the grid barrier follows.  Every thread returns the decision
// (another sweep) and the free columns' least d.
template <typename T>
__device__ __forceinline__ bool stop_test(const Aug<T>& a, lapgnn::GridBarrier& bar, int set,
                                          T f, T m, int any, unsigned long long* words_s,
                                          T& dmin_free) {
  if (threadIdx.x < 32) {
    unsigned long long kf = stop_key((double)f), km = stop_key((double)m);
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long of = __shfl_xor_sync(kAllLanes, kf, off);
      const unsigned long long om = __shfl_xor_sync(kAllLanes, km, off);
      kf = of < kf ? of : kf;
      km = om < km ? om : km;
    }
    any = __any_sync(kAllLanes, any != 0);
    if (threadIdx.x == 0) {
      unsigned long long* w = a.stop + set * kStopWords;
      if (kf != kInfKey) atomicMin(w + 0, kf);
      if (km != kInfKey) atomicMin(w + 1, km);
      if (any) atomicOr(w + 2, 1ull);
    }
  }
  bar.sync([&] { reset_stop(a.stop + (set ^ 1) * kStopWords); },
           [&] {
             const unsigned long long* w = a.stop + set * kStopWords;
             words_s[0] = lapgnn::ld_relaxed_gpu(w + 0);
             words_s[1] = lapgnn::ld_relaxed_gpu(w + 1);
             words_s[2] = lapgnn::ld_relaxed_gpu(w + 2);
           });
  dmin_free = (T)stop_value(words_s[0]);
  const T least_imp = (T)stop_value(words_s[1]);
  const T thresh = add_rn(dmin_free, mul_rn(a.tol, add_rn(T(1), fabs(dmin_free))));
  return words_s[2] != 0 && least_imp <= thresh;
}

// --- TMA (resident layout)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// One thread: the block's tile of C, rows [0, n) x columns [k0, k0 + w), as
// n / tma_rows boxes into dst ([row][column], w wide), completing on bar.
template <typename T>
__device__ __forceinline__ void tma_load_tile(const Aug<T>& a, T* dst, uint64_t* bar, int k0) {
  const int n = a.n, rows = a.tma_rows, w = a.tile;
  const unsigned bytes = (unsigned)((size_t)n * w * sizeof(T));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  for (int r0 = 0; r0 < n; r0 += rows) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst + (size_t)r0 * w)),
        "l"((unsigned long long)&a.tmap), "r"(k0), "r"(r0), "r"(smem_u32(bar))
        : "memory");
  }
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }
constexpr size_t kTileAlign = 128;  // a TMA destination's alignment

// A block's dynamic shared memory.  Resident: [pad to 128 B | tile | d (the
// changed rows' list once e is gathered) | e (u before the sweeps) | x | a
// bit a row, changed]; staged: [u | e | x]; unstaged: none.
template <typename T>
size_t smem_bytes(int n, int tile, int layout) {
  if (layout == kResident)
    return kTileAlign + align16(sizeof(T) * (size_t)n * tile) + 2 * align16(sizeof(T) * n) +
           align16(sizeof(int) * (size_t)n) + align16(sizeof(unsigned) * ((n + 31) / 32));
  return layout == kStaged ? (2 * sizeof(T) + sizeof(int)) * (size_t)n : 0;
}

template <typename T, int kLayout>
__global__ void __launch_bounds__(kThreads, 1) augment_kernel(const __grid_constant__ Aug<T> a) {
  constexpr bool kRes = kLayout == kResident;
  constexpr bool kShared = kLayout != kUnstaged;  // u, x, e in shared memory
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ T red_v[kThreads];
  __shared__ int red_i[kThreads];
  __shared__ int path_rows[kPathCap], path_cols[kPathCap];
  __shared__ unsigned long long words_s[kStopWords];
  __shared__ __align__(8) uint64_t tile_bar;
  __shared__ int nan_s[kMaxWidth];  // resident: the tile's columns with a NaN in red
  __shared__ int count_s[kWarps];   // resident: the rows each warp listed

  const int n = a.n, w = a.tile;
  // an offset from smem_raw, so that the compiler keeps every access below
  // to shared memory
  unsigned char* base = smem_raw;
  if (kRes) base += (kTileAlign - (smem_u32(smem_raw) & (kTileAlign - 1))) & (kTileAlign - 1);
  T* tile_s = reinterpret_cast<T*>(base);
  T* d_s = reinterpret_cast<T*>(base + (kRes ? align16(sizeof(T) * (size_t)n * w) : 0));
  T* u_s = kRes ? reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(d_s) +
                                       align16(sizeof(T) * n))
                : reinterpret_cast<T*>(base);
  T* e_s = kRes ? u_s : u_s + n;
  int* x_s = kRes ? reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(e_s) +
                                           align16(sizeof(T) * n))
                  : reinterpret_cast<int*>(e_s + n);
  unsigned* mask_s = reinterpret_cast<unsigned*>(x_s) + (kRes ? align16(sizeof(int) * (size_t)n) / 4 : 0);
  const T* u_r = kShared ? u_s : a.u;
  const T* e_r = kShared ? e_s : a.e;
  const int* x_r = kShared ? x_s : a.xr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blocks = gridDim.x, b = blockIdx.x;
  const int gwarp = b * kWarps + warp, nwarps = blocks * kWarps;
  const int ntiles = (n + w - 1) / w;
  const T inf = INFINITY;
  lapgnn::GridBarrier bar(a.bar, (unsigned)blocks);

  // resident: thread (col, rg) of the block's one tile; warp 0 owns its columns
  const int groups = kRes ? min(kThreads / w, n) : 1;
  const int col = tid % w, rg = tid / w;
  const int k_own = b * w + col;
  const bool real = kRes && tid < w * groups && k_own < n;
  const bool owns = kRes && tid < w && k_own < n;
  const bool tma = kRes && a.tma_rows > 0;

  long long rounds = 0, sweeps = 0, steps = 0;
  if (tma && tid == 0) mbar_init(&tile_bar);
  // block 0 zeroes the barrier's words and the stop test's, and the one
  // cooperative_groups grid sync of the launch publishes them
  if (b == 0 && warp == 0) {
    const bool f = any_free(a.x, n, lane);
    if (lane == 0) {
      *a.go = f ? 1 : 0;
      lapgnn::st_relaxed_gpu(a.bar, 0u);
      lapgnn::st_relaxed_gpu(a.bar + lapgnn::kBarrierLine, 0u);
      reset_stop(a.stop);
      reset_stop(a.stop + kStopWords);
    }
  }
  grid.sync();
  while (ld(a.go)) {
    if (tma) {
      // every thread's last access to the tile comes before the copy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (tid == 0) tma_load_tile(a, tile_s, &tile_bar, b * w);
    }
    // row potentials: a warp a row
    for (int i = gwarp; i < n; i += nwarps) {
      const long long xi = ld(a.x + i);
      const T* crow = a.C + (long long)i * n;
      T ui;
      if (xi >= 0) {
        ui = __ldg(crow + xi) - ld(a.v + xi);
      } else {
        ui = inf;
        int j = lane;
        for (; j + 32 * (kAhead - 1) < n; j += 32 * kAhead) {
          T c[kAhead], vj[kAhead];
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            c[q] = __ldg(crow + j + 32 * q);
            vj[q] = ld(a.v + j + 32 * q);
          }
#pragma unroll
          for (int q = 0; q < kAhead; ++q) ui = nan_min(ui, c[q] - vj[q]);
        }
        for (; j < n; j += 32) ui = nan_min(ui, __ldg(crow + j) - ld(a.v + j));
        for (int off = 16; off > 0; off >>= 1)
          ui = nan_min(ui, __shfl_xor_sync(kAllLanes, ui, off));
      }
      if (lane == 0) {
        a.u[i] = ui;
        if (!kShared) a.xr[i] = (int)xi;
      }
    }
    bar.sync();
    if (kShared) {
      for (int i = tid; i < n; i += kThreads) {
        u_s[i] = ld(a.u + i);
        x_s[i] = (int)ld(a.x + i);
      }
      if (kRes && tid < kMaxWidth) nan_s[tid] = 0;
      __syncthreads();
    }

    int s = 0;
    bool more;
    T dmin_free;
    if constexpr (kRes) {
      // red in place of C; d0, pred0: the free rows' column minima
      if (tma) {
        const long long start = clock64();
        while (!mbar_try_wait(&tile_bar, (unsigned)(rounds & 1))) lapgnn::check_spin(start);
      }
      T best = inf;
      int brow = kNoIndex;
      bool nan_r = false;
      if (real) {
        // the thread's rows in order: the first taken as it is, a later one
        // by later_takes (lex_less for a later row); kAhead loads at a time
        const T vk = ld(a.v + k_own);
        const T* ck = a.C + k_own;
        T* tc = tile_s + col;
        auto red_of = [&](T c, int i) {
          const T r = reduced(c, vk, u_s[i]);
          tc[(size_t)i * w] = r;
          nan_r |= isnan(r);
          return x_s[i] < 0 ? r : inf;
        };
        int i = rg;
        best = red_of(tma ? tc[(size_t)i * w] : __ldg(ck + (long long)i * n), i);
        brow = i;
        for (i += groups; i + (kAhead - 1) * groups < n; i += kAhead * groups) {
          T c[kAhead];
#pragma unroll
          for (int q = 0; q < kAhead; ++q)
            c[q] = tma ? tc[(size_t)(i + q * groups) * w]
                       : __ldg(ck + (long long)(i + q * groups) * n);
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            const T val = red_of(c[q], i + q * groups);
            if (later_takes(val, best)) {
              best = val;
              brow = i + q * groups;
            }
          }
        }
        for (; i < n; i += groups) {
          const T val = red_of(tma ? tc[(size_t)i * w] : __ldg(ck + (long long)i * n), i);
          if (later_takes(val, best)) {
            best = val;
            brow = i;
          }
        }
      }
      if (nan_r) nan_s[col] = 1;
      red_v[tid] = best;
      red_i[tid] = brow;
      merge_groups(w, groups, red_v, red_i, best, brow);
      T d_own = best;
      int pred_own = brow;
      bool free_own = false;
      const bool nan_own = owns && nan_s[tid] != 0;
      if (owns) {
        a.d[0][k_own] = best;
        a.pred[0][k_own] = brow;
        free_own = ld(a.y + k_own) < 0;
      }
      // e before the first sweep: +inf, so that every row with a finite e
      // counts as changed (u, in the same space, is no longer read)
      for (int i = tid; i < n; i += kThreads) e_s[i] = inf;
      bar.sync();

      // the sweeps: e gathered from a shared copy of d; the pass over red
      // takes only the rows whose e changed in the last sweep (e only
      // falls): a row whose e did not change was taken when it last did,
      // so d_k <= e_i + red_ik already and it cannot improve column k, nor
      // tie with a value below d_k.  The changed rows are listed in row
      // order, so each thread still meets its rows in order.
      constexpr int kVec = 16 / sizeof(T);
      const T* t = tile_s + col;
      int* list_s = reinterpret_cast<int*>(d_s);  // once e is gathered
      const int per_warp = (n + 32 * kWarps - 1) / (32 * kWarps) * 32;  // rows a warp lists
      const int r_lo = warp * per_warp, r_hi = min(n, r_lo + per_warp);
      do {
        const T* dc = a.d[s & 1];
        const int nv = n / kVec;
        for (int q = tid; q < nv; q += kThreads)
          reinterpret_cast<float4*>(d_s)[q] = __ldcg(reinterpret_cast<const float4*>(dc) + q);
        for (int i = nv * kVec + tid; i < n; i += kThreads) d_s[i] = ld(dc + i);
        __syncthreads();
        // e_i = d[x_i]; a warp marks its rows whose e changed, 32 a word,
        // kAhead words at a time with their loads issued first
        int changed = 0;
        bool e_nan = false;
        for (int r0 = r_lo; r0 < r_hi; r0 += 32 * kAhead) {
          int xi[kAhead];
          T e_old[kAhead], e_new[kAhead];
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            const int i = r0 + 32 * q + lane;
            xi[q] = i < r_hi ? x_s[i] : -1;
            e_old[q] = i < r_hi ? e_s[i] : inf;
          }
#pragma unroll
          for (int q = 0; q < kAhead; ++q) e_new[q] = xi[q] < 0 ? inf : d_s[xi[q]];
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            const int i = r0 + 32 * q + lane;
            const bool ch = !(e_new[q] == e_old[q]);
            e_nan |= isnan(e_new[q]);
            if (ch) e_s[i] = e_new[q];  // a row past r_hi has e_new == e_old == inf
            const unsigned mask = __ballot_sync(kAllLanes, ch);
            if (r0 + 32 * q < r_hi) {
              if (lane == 0) mask_s[(r0 + 32 * q) / 32] = mask;
              changed += __popc(mask);
            }
          }
        }
        if (lane == 0) count_s[warp] = changed;
        // a NaN in e is the least value of every column: nothing improves
        e_nan = __syncthreads_or(e_nan);
        int listed = 0, at = 0;
        for (int q = 0; q < kWarps; ++q) {
          at += q < warp ? count_s[q] : 0;
          listed += count_s[q];
        }
        for (int r0 = r_lo; r0 < r_hi; r0 += 32 * kAhead) {
          unsigned mask[kAhead];
#pragma unroll
          for (int q = 0; q < kAhead; ++q)
            mask[q] = r0 + 32 * q < r_hi ? mask_s[(r0 + 32 * q) / 32] : 0u;
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            if ((mask[q] >> lane) & 1u)
              list_s[at + __popc(mask[q] & ((1u << lane) - 1u))] = r0 + 32 * q + lane;
            at += __popc(mask[q]);
          }
        }
        __syncthreads();
        // the least e_i + red_ik over the listed rows and its first row, NaN
        // left out: a column with a NaN in red never improves this round
        // (NaN + e is NaN, the least value under lex_less, and `NaN < d` is
        // false)
        best = inf;
        brow = kNoIndex;
        if (real && !e_nan) {
          int j = rg;
          for (; j + (kAhead - 1) * groups < listed; j += kAhead * groups) {
            int i[kAhead];
            T val[kAhead];
#pragma unroll
            for (int q = 0; q < kAhead; ++q) i[q] = list_s[j + q * groups];
#pragma unroll
            for (int q = 0; q < kAhead; ++q) val[q] = e_s[i[q]] + t[(size_t)i[q] * w];
#pragma unroll
            for (int q = 0; q < kAhead; ++q) {
              if (val[q] < best) {
                best = val[q];
                brow = i[q];
              }
            }
          }
          for (; j < listed; j += groups) {
            const int i = list_s[j];
            const T val = e_s[i] + t[(size_t)i * w];
            if (val < best) {
              best = val;
              brow = i;
            }
          }
        }
        red_v[tid] = best;
        red_i[tid] = brow;
        merge_groups(w, groups, red_v, red_i, best, brow);
        T f = inf, m = inf;
        int any = 0;
        if (owns) {
          if (!nan_own && best < d_own) {
            d_own = best;
            pred_own = brow;
            m = best;
            any = 1;
          }
          a.d[(s + 1) & 1][k_own] = d_own;
          a.pred[(s + 1) & 1][k_own] = pred_own;
          if (free_own) f = d_own;
        }
        more = stop_test(a, bar, (int)((sweeps + s) & 1), f, m, any, words_s, dmin_free);
        ++s;
      } while (more && s <= n);
    } else {
      // d0, pred0: the free rows' column minima
      for (int t = b; t < ntiles; t += blocks) {
        T best;
        int brow;
        tile_min<T, false, kShared>(a, t * w, u_r, e_r, x_r, red_v, red_i, best, brow);
        const int k = t * w + tid;
        if (tid < w && k < n) {
          a.d[0][k] = best;
          a.pred[0][k] = brow;
        }
      }
      bar.sync();

      // the sweeps
      do {
        const T* dc = a.d[s & 1];
        T* dn = a.d[(s + 1) & 1];
        const int* pc = a.pred[s & 1];
        int* pn = a.pred[(s + 1) & 1];
        if (kShared) {
          for (int i = tid; i < n; i += kThreads) e_s[i] = x_s[i] < 0 ? inf : ld(dc + x_s[i]);
          __syncthreads();
        } else {
          for (int i = b * kThreads + tid; i < n; i += blocks * kThreads) {
            const int xi = ld(a.xr + i);
            a.e[i] = xi < 0 ? inf : ld(dc + xi);
          }
          bar.sync();
        }
        T f = inf, m = inf;
        int any = 0;
        for (int t = b; t < ntiles; t += blocks) {
          T best;
          int brow;
          tile_min<T, true, kShared>(a, t * w, u_r, e_r, x_r, red_v, red_i, best, brow);
          const int k = t * w + tid;
          if (tid < w && k < n) {
            const T old = ld(dc + k);
            const bool improve = best < old;
            const T d = improve ? best : old;
            dn[k] = d;
            pn[k] = improve ? brow : ld(pc + k);
            if (ld(a.y + k) < 0) f = nan_min(f, d);
            if (improve) {
              m = fmin(m, d);
              any = 1;
            }
          }
        }
        more = stop_test(a, bar, (int)((sweeps + s) & 1), f, m, any, words_s, dmin_free);
        ++s;
      } while (more && s <= n);
    }
    sweeps += s;

    // the dual update and the candidates, a column a thread
    const T* dfin = a.d[s & 1];
    const T delta = dmin_free;
    const T cut = add_rn(delta, mul_rn(a.tol, add_rn(T(1), fabs(delta))));
    for (int k = b * kThreads + tid; k < n; k += blocks * kThreads) {
      const T dk = ld(dfin + k);
      const T lo = isnan(dk) ? dk : (isnan(delta) ? delta : (dk < delta ? dk : delta));
      a.v[k] = sub_rn(add_rn(ld(a.v + k), lo), delta);
      a.cand[k] = (ld(a.y + k) < 0 && dk <= cut) ? 1 : 0;
    }
    bar.sync();

    ++rounds;
    if (b == 0 && warp == 0) {
      steps += flip_paths(a, a.pred[s & 1], lane, path_rows, path_cols);
      const bool f = any_free(a.x, n, lane);
      if (lane == 0) *a.go = (f && rounds <= n) ? 1 : 0;
    }
    bar.sync();
  }
  if (b == 0 && tid == 0) {
    a.counts[0] += rounds;
    a.counts[1] += sweeps;
    a.counts[2] += steps;
  }
}

// The sync floor: `iters` barriers of the sweep's kind on a grid, with
// (payload) or without the stop test's atomics, reset and read.
__global__ void __launch_bounds__(kThreads, 1)
    barrier_bench_kernel(unsigned* words, unsigned long long* stop, int iters, int payload) {
  __shared__ unsigned long long words_s[kStopWords];
  lapgnn::GridBarrier bar(words, gridDim.x);
  for (int it = 0; it < iters; ++it) {
    const int set = it & 1;
    if (!payload) {
      bar.sync();
      continue;
    }
    if (threadIdx.x == 0) {
      unsigned long long* w = stop + set * kStopWords;
      atomicMin(w + 0, (unsigned long long)blockIdx.x + 1);
      atomicMin(w + 1, (unsigned long long)blockIdx.x + 1);
      atomicOr(w + 2, 1ull);
    }
    bar.sync([&] { reset_stop(stop + (set ^ 1) * kStopWords); },
             [&] {
               const unsigned long long* w = stop + set * kStopWords;
               words_s[0] = lapgnn::ld_relaxed_gpu(w + 0);
               words_s[1] = lapgnn::ld_relaxed_gpu(w + 1);
               words_s[2] = lapgnn::ld_relaxed_gpu(w + 2);
             });
  }
  if (payload && threadIdx.x == 0 && blockIdx.x == 0) stop[2 * kStopWords] = words_s[0];
}

template <typename T>
void* kernel_of(int layout) {
  if (layout == kResident) return (void*)augment_kernel<T, kResident>;
  return layout == kStaged ? (void*)augment_kernel<T, kStaged>
                           : (void*)augment_kernel<T, kUnstaged>;
}

// Scratch of one launch, carved from one buffer.
template <typename T>
size_t work_bytes(int n) {
  const size_t vn = align16(sizeof(T) * n), in = align16(sizeof(int) * n), bn = align16(n);
  return 4 * vn + 3 * in + 2 * bn + lapgnn::kBarrierBytes + 2 * kStopWords * 8 + 16;
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// C as a 2-D tensor of n x n for boxes of `rows` rows x `tile` columns.
// Returns a cudaError_t.
template <typename T>
int encode_tile_map(CUtensorMap* map, const T* C, int n, int tile, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)tile, (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
      const_cast<T*>(C), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const T* C, long long* x, long long* y, T* v, unsigned char* work,
           long long* counts, int n, int blocks, int tile, int layout, int tma_rows, T tol,
           cudaStream_t s) {
  Aug<T> a;
  memset(&a, 0, sizeof(a));
  if (layout == kResident) {
    if (tile > kMaxWidth || (long long)blocks * tile < n) return (int)cudaErrorInvalidValue;
    if (tma_rows > 0) {
      if (tma_rows > kMaxBox || n % tma_rows != 0 || (sizeof(T) * tile) % 16 != 0 ||
          (sizeof(T) * n) % 16 != 0 || (sizeof(T) * tile * tma_rows) % kTileAlign != 0 ||
          reinterpret_cast<uintptr_t>(C) % 16 != 0)
        return (int)cudaErrorInvalidValue;
      const int err = encode_tile_map(&a.tmap, C, n, tile, tma_rows);
      if (err != 0) return err;
    }
  }
  const size_t vn = align16(sizeof(T) * n), in = align16(sizeof(int) * n), bn = align16(n);
  unsigned char* p = work;
  auto take = [&](size_t bytes) {
    unsigned char* q = p;
    p += bytes;
    return q;
  };
  a.C = C;
  a.x = x;
  a.y = y;
  a.v = v;
  a.u = reinterpret_cast<T*>(take(vn));
  a.d[0] = reinterpret_cast<T*>(take(vn));
  a.d[1] = reinterpret_cast<T*>(take(vn));
  a.pred[0] = reinterpret_cast<int*>(take(in));
  a.pred[1] = reinterpret_cast<int*>(take(in));
  a.cand = take(bn);
  a.used = take(bn);
  a.e = reinterpret_cast<T*>(take(vn));
  a.xr = reinterpret_cast<int*>(take(in));
  a.bar = reinterpret_cast<unsigned*>(take(lapgnn::kBarrierBytes));
  a.stop = reinterpret_cast<unsigned long long*>(take(2 * kStopWords * 8));
  a.go = reinterpret_cast<int*>(take(16));
  a.counts = counts;
  a.n = n;
  a.tile = tile;
  a.tma_rows = layout == kResident ? tma_rows : 0;
  a.tol = tol;
  const size_t smem = smem_bytes<T>(n, tile, layout);
  void* kernel = kernel_of<T>(layout);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int n, int tile, int layout) {
  const size_t smem = smem_bytes<T>(n, tile, layout);
  void* kernel = kernel_of<T>(layout);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  return err == cudaSuccess ? occ : -(int)err;
}

}  // namespace

extern "C" {

// Blocks of the kernel one SM holds at once for rows of n columns (f64 != 0:
// float64; layout 0 unstaged, 1 staged, 2 resident with tiles of `tile`
// columns), or minus a cudaError_t.
int lapgnn_augment_occupancy(int n, int f64, int layout, int tile) {
  return f64 ? occupancy<double>(n, tile, layout) : occupancy<float>(n, tile, layout);
}

// The kernel's static shared memory in bytes, or minus a cudaError_t.
int lapgnn_augment_static_smem(int f64, int layout) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, f64 ? kernel_of<double>(layout) : kernel_of<float>(layout));
  return err == cudaSuccess ? (int)attr.sharedSizeBytes : -(int)err;
}

// Bytes of the scratch buffer a launch of `blocks` blocks takes.
long long lapgnn_augment_work_bytes(int n, int blocks, int f64) {
  (void)blocks;
  return (long long)(f64 ? work_bytes<double>(n) : work_bytes<float>(n));
}

// C: (n, n) contiguous; x, y: (n,) int64 and v: (n,) updated in place;
// work: lapgnn_augment_work_bytes bytes; counts: 3 int64 that the launch adds
// its rounds, sweeps and flip steps to.  One cooperative launch of `blocks`
// blocks (at most what the card holds at once), tiles of `tile` columns, in
// layout 0 (unstaged), 1 (staged) or 2 (resident: one tile a block, at most
// 32 wide, loaded by TMA in boxes of `tma_rows` rows where tma_rows > 0).
// `tol` is 8 eps of the type.  Returns a cudaError_t.
int lapgnn_augment(const float* C, long long* x, long long* y, float* v, void* work,
                   long long* counts, int n, int blocks, int tile, int layout, int tma_rows,
                   float tol, void* stream) {
  return launch<float>(C, x, y, v, static_cast<unsigned char*>(work), counts, n, blocks, tile,
                       layout, tma_rows, tol, static_cast<cudaStream_t>(stream));
}

int lapgnn_augment_f64(const double* C, long long* x, long long* y, double* v, void* work,
                       long long* counts, int n, int blocks, int tile, int layout, int tma_rows,
                       double tol, void* stream) {
  return launch<double>(C, x, y, v, static_cast<unsigned char*>(work), counts, n, blocks, tile,
                        layout, tma_rows, tol, static_cast<cudaStream_t>(stream));
}

// Bytes of zeroed device memory lapgnn_augment_barrier_bench takes.
long long lapgnn_augment_barrier_work_bytes(void) {
  return (long long)(lapgnn::kBarrierBytes + (2 * kStopWords + 1) * 8);
}

// `iters` grid barriers of the sweep's kind, alone: one cooperative launch
// of `blocks` blocks of the kernel's threads, `smem` bytes of dynamic shared
// memory each (so that the blocks sit as the kernel's do); payload != 0 adds
// the stop test's atomics, reset and read.  `work`: zeroed,
// lapgnn_augment_barrier_work_bytes bytes.  Returns a cudaError_t.
int lapgnn_augment_barrier_bench(int blocks, int smem, int iters, int payload, void* work,
                                 void* stream) {
  void* kernel = (void*)barrier_bench_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  unsigned* words = static_cast<unsigned*>(work);
  unsigned long long* stop = reinterpret_cast<unsigned long long*>(
      static_cast<unsigned char*>(work) + lapgnn::kBarrierBytes);
  void* args[] = {&words, &stop, &iters, &payload};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
