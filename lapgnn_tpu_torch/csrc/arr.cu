// Jacobi augmenting row reduction of the device solver (S2) for Hopper: every
// round of jacobi_arr in one cooperative launch.
//
// Replaces lapgnn_tpu/solver/seeded.py:jacobi_arr (:163), a lax.while_loop
// of auction rounds with no Pallas kernel behind it but the bid (K4,
// twomin.py).  Each round, in the JAX order:
//   the bid: every free row takes min1, its first argmin j1 and min2 of its
//     row of C - v (K4's arithmetic: lapgnn::scan_row and the compare
//     states of csrc/twomin.cuh, the same bits as K4), and bids the gap
//     min2 - min1 for j1 when the gap exceeds min_delta and min2 is finite;
//   the winner of a column is its largest gap, the lowest row on a tie
//     (RowPartition.best_bid's rule);
//   v_j is lowered by the winning gap where it is positive, the column's
//     previous owner is kicked, the winner takes the column;
// until a round wins nothing or max_rounds rounds.
//
// Design.  A warp per free row for the bid (the matched rows are skipped,
// as their bids are masked in the JAX version); the column's largest gap by
// a 64-bit atomicMax of the gap's order key (as a double: exact for float32,
// and the same code for float64); then the lowest row among the bids that
// reach it by an atomicMin; then a thread per column applies the result and
// clears its slots.  Three grid syncs a round.  v, x and y change during the
// launch and are read from L2 (__ldcg).
//
// Bound: each round reads C once from L2 for the free rows (at most
// rounds x n^2 x 4 B); at the solver's size the rounds are a few grid syncs
// and the free rows' scans.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "twomin.cuh"

namespace cg = cooperative_groups;

namespace {

using lapgnn::CoherentV;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kTop = 0x8000000000000000ull;

template <typename U>
__device__ __forceinline__ U ld(const U* p) {
  return __ldcg(p);
}

// Order key of a gap (never NaN): the order of the doubles, -0.0 as +0.0.
// No gap's key is 0 (that would be a negative NaN), so 0 is "no bid".
__device__ __forceinline__ unsigned long long gap_key(double g) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(g + 0.0);
  return (u & kTop) ? ~u : (u | kTop);
}
__device__ __forceinline__ double key_gap(unsigned long long k) {
  return __longlong_as_double((long long)((k & kTop) ? (k ^ kTop) : ~k));
}

template <typename T>
struct Arr {
  const T* C;               // (n, n) row-major
  long long* x;             // (n,) updated in place
  long long* y;             // (n,) updated in place
  T* v;                     // (n,) updated in place
  unsigned long long* best; // (n,) a column's largest gap's key, 0 for none
  int* win;                 // (n,) a column's lowest row at that gap, n for none
  int* bid_col;             // (n,) the column a row bid for this round, -1 for none
  T* bid_gap;               // (n,) its gap
  int* won;                 // (max_rounds,) a column was won in that round
  long long* counts;        // += rounds
  int n, max_rounds;
  T min_delta;
};

template <typename T, typename State, bool kVec4>
__global__ void __launch_bounds__(kThreads) arr_kernel(Arr<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gthread = blockIdx.x * kThreads + tid, nthreads = gridDim.x * kThreads;
  const int gwarp = gthread >> 5, nwarps = nthreads >> 5;

  for (int j = gthread; j < n; j += nthreads) {
    a.best[j] = 0;
    a.win[j] = n;
  }
  for (int r = gthread; r < a.max_rounds; r += nthreads) a.won[r] = 0;
  grid.sync();

  int rnd = 0;
  bool progressed = true;
  while (rnd < a.max_rounds && progressed) {
    // the bids, a warp a free row
    for (int i = gwarp; i < n; i += nwarps) {
      if (ld(a.x + i) >= 0) {
        if (lane == 0) a.bid_col[i] = -1;
        continue;
      }
      const T* crow = a.C + (long long)i * n;
      State s;
      s.init();
      lapgnn::scan_row<T, State, kVec4, 4, CoherentV>(s, crow, a.v, n, lane);
      s.merge_lanes();
      if (lane == 0) {
        T m1, m2;
        int j1;
        s.template result<CoherentV>(crow, a.v, m1, m2, j1);
        const T gap = m2 - m1;
        const bool bid = gap > a.min_delta && isfinite(m2);
        a.bid_col[i] = bid ? j1 : -1;
        a.bid_gap[i] = gap;
        if (bid) atomicMax(a.best + j1, gap_key((double)gap));
      }
    }
    grid.sync();
    // the lowest row among a column's largest gaps
    for (int i = gthread; i < n; i += nthreads) {
      const int c = ld(a.bid_col + i);
      if (c >= 0 && gap_key((double)ld(a.bid_gap + i)) >= ld(a.best + c)) atomicMin(a.win + c, i);
    }
    grid.sync();
    // the winners, a thread a column
    for (int j = gthread; j < n; j += nthreads) {
      const int w = ld(a.win + j);
      const bool got = w < n;
      const T gap = got ? (T)key_gap(ld(a.best + j)) : T(-INFINITY);
      a.v[j] = ld(a.v + j) - ((got && gap > T(0)) ? gap : T(0));
      if (got) {
        const long long kicked = ld(a.y + j);
        if (kicked >= 0) a.x[kicked] = -1;
        a.x[w] = j;
        a.y[j] = w;
        a.won[rnd] = 1;
      }
      a.best[j] = 0;
      a.win[j] = n;
    }
    grid.sync();
    progressed = ld(a.won + rnd) != 0;
    ++rnd;
  }
  if (blockIdx.x == 0 && tid == 0) a.counts[0] += rnd;
}

template <typename T>
size_t work_bytes(int n, int max_rounds) {
  return 16 * (size_t)n + 4 * (size_t)max_rounds + 8 + sizeof(T) * (size_t)n;
}

template <typename K>
int occupancy_of(K kernel) {
  int occ = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
  return err == cudaSuccess ? occ : -(int)err;
}

template <typename T, typename K>
int launch(K kernel, const T* C, long long* x, long long* y, T* v, unsigned char* work,
           long long* counts, int n, int max_rounds, T min_delta, int blocks, cudaStream_t s) {
  Arr<T> a;
  unsigned char* p = work;
  a.best = reinterpret_cast<unsigned long long*>(p);
  p += 8 * (size_t)n;
  a.win = reinterpret_cast<int*>(p);
  p += 4 * (size_t)n;
  a.bid_col = reinterpret_cast<int*>(p);
  p += 4 * (size_t)n;
  a.won = reinterpret_cast<int*>(p);
  p += 4 * (size_t)max_rounds;
  p += (8 - ((uintptr_t)p & 7)) & 7;  // bid_gap 8-byte aligned
  a.bid_gap = reinterpret_cast<T*>(p);
  a.C = C;
  a.x = x;
  a.y = y;
  a.v = v;
  a.counts = counts;
  a.n = n;
  a.max_rounds = max_rounds;
  a.min_delta = min_delta;
  void* args[] = {&a};
  const cudaError_t err =
      cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the kernel one SM holds at once: f64 != 0 for float64, vec != 0
// for the float32 form with 16-byte loads; or minus a cudaError_t.
int lapgnn_arr_occupancy(int f64, int vec) {
  if (f64) return occupancy_of(arr_kernel<double, lapgnn::FloatState<double>, false>);
  return vec ? occupancy_of(arr_kernel<float, lapgnn::KeyState, true>)
             : occupancy_of(arr_kernel<float, lapgnn::KeyState, false>);
}

long long lapgnn_arr_work_bytes(int n, int max_rounds, int f64) {
  return (long long)(f64 ? work_bytes<double>(n, max_rounds) : work_bytes<float>(n, max_rounds));
}

// C: (n, n) contiguous float32; x, y (n,) int64 and v (n,) float32 updated in
// place; work: lapgnn_arr_work_bytes bytes; counts: 1 int64 that the launch
// adds its rounds to.  `vec` != 0 for 16-byte loads (n % 4 == 0, C and v
// 16-byte aligned).  One cooperative launch of `blocks` blocks.  Returns a
// cudaError_t.
int lapgnn_arr(const float* C, long long* x, long long* y, float* v, void* work,
               long long* counts, int n, int max_rounds, float min_delta, int vec, int blocks,
               void* stream) {
  auto* w = static_cast<unsigned char*>(work);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec && (n % 4 != 0 || reinterpret_cast<uintptr_t>(C) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(v) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  return vec ? launch<float>(arr_kernel<float, lapgnn::KeyState, true>, C, x, y, v, w, counts, n,
                             max_rounds, min_delta, blocks, s)
             : launch<float>(arr_kernel<float, lapgnn::KeyState, false>, C, x, y, v, w, counts, n,
                             max_rounds, min_delta, blocks, s);
}

// The same for float64 (the float compare state over doubles).
int lapgnn_arr_f64(const double* C, long long* x, long long* y, double* v, void* work,
                   long long* counts, int n, int max_rounds, double min_delta, int blocks,
                   void* stream) {
  return launch<double>(arr_kernel<double, lapgnn::FloatState<double>, false>, C, x, y, v,
                        static_cast<unsigned char*>(work), counts, n, max_rounds, min_delta,
                        blocks, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
