// Jacobi augmenting row reduction of the device solver (S2) for Hopper: every
// round of jacobi_arr in one cooperative launch, one grid barrier a round.
//
// Replaces lapgnn_tpu/solver/seeded.py:jacobi_arr (:163), a lax.while_loop
// of auction rounds with no Pallas kernel behind it but the bid (K4,
// twomin.py).  Each round, in the JAX order:
//   the bid: every free row takes min1, its first argmin j1 and min2 of its
//     row of C - v (K4's arithmetic: the compare states of csrc/twomin.cuh,
//     the same bits as K4), and bids the gap min2 - min1 for j1 when the gap
//     exceeds min_delta and min2 is finite;
//   the winner of a column is its largest gap, the lowest row on a tie
//     (RowPartition.best_bid's rule);
//   v_j is lowered by the winning gap where it is positive, the column's
//     previous owner is kicked, the winner takes the column;
// until a round wins nothing or max_rounds rounds.
//
// Design (the round structure is csrc/free_rows.cuh's).  Every block keeps
// its own copy of the matching's state: v, y (as int) and a bit a free row.
// A round:
//  - one warp of the block ranks the free rows from its bits, and the block
//    takes every G-th (free_rows.cuh) and scans each with a group of its
//    warps (one warp a row once it has a row for each warp, all eight for a
//    lone row), v read from its own copy (LocalV), C by 16-byte loads (four
//    columns a load where n % 4 == 0 and C is aligned), kUnroll loads a
//    thread in flight; the warps' compare states merge in shared memory (a
//    lexicographic minimum over distinct (key, column) pairs, so the order
//    of the merges does not change the bits), and min1 and min2 come back
//    from their keys (key_value);
//  - float32: the bid is one 64-bit atomicMax of (the gap's 32-bit order
//    key, the row inverted) on the column's slot, which gives the largest
//    gap and the lowest row on a tie at once.  float64 (a 64-bit key and a
//    row do not fit one word): an atomicMax of the gap's key, a grid
//    barrier, then an atomicMax of the inverted row by the bids that reach
//    the largest key.  Either way no bidder waits for an atomic's answer:
//    the free row of rank k stores its bid (column and row, or none) in
//    entry k and adds one to the round's count;
//  - one grid barrier (csrc/grid_barrier.cuh), whose payload is the count:
//    a round wins something exactly when some row bid (every column bid for
//    gets a winner), so a count of 0 is the stop test, and every block reads
//    the same count;
//  - every block reads the round's entries and their columns' slots and
//    applies the bids that won to its own copy, and the block that rank k
//    falls to writes its winner to the output x, y and v in device memory.
//    Nothing else writes the outputs after the blocks' first copies of the
//    inputs, so no write-back follows the last round.
// Layouts, chosen on the host by n, the type and the SM count
// (ops/cuda/arr.py): resident, v and y in shared memory (about 8.16 B a
// column in float32, n up to 28,436 on 132 SMs; 12.28 B and 18,938 in
// float64); global, v and y in a region of device memory that only the
// block reads and writes (plain loads: an SM's L1 is coherent with its own
// writes), the bits and the rows in shared memory still.  Both give the
// same bits.
//
// Bound: the free rows' rows of C, read once a round; at the solver's size
// C stays in L2, and a round is one grid barrier and the free rows' scans.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "free_rows.cuh"
#include "grid_barrier.cuh"
#include "twomin.cuh"

namespace {

using lapgnn::kAllLanes;
using lapgnn::LocalV;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // loads of C a thread has in flight
constexpr int kApply = 4;   // bids a thread reads at once in the apply
constexpr int kBuffers = lapgnn::kRoundBuffers;
constexpr int kGlobal = 0, kResident = 1;  // ops/cuda/arr.py LAYOUTS
constexpr unsigned long long kTop = 0x8000000000000000ull;
constexpr uint32_t kTop32 = 0x80000000u;

// Order key of a float64 gap (never NaN): the order of the doubles, -0.0 as
// +0.0.  No gap's key is 0 (that would be a negative NaN), so 0 is "no bid".
__device__ __forceinline__ unsigned long long gap_key(double g) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(g + 0.0);
  return (u & kTop) ? ~u : (u | kTop);
}
__device__ __forceinline__ double key_gap(unsigned long long k) {
  return __longlong_as_double((long long)((k & kTop) ? (k ^ kTop) : ~k));
}

// The same for a float32 gap, in 32 bits: the high word of the winner's slot.
__device__ __forceinline__ uint32_t gap_key32(float g) {
  const uint32_t u = __float_as_uint(g + 0.0f);
  return (u & kTop32) ? ~u : (u | kTop32);
}
__device__ __forceinline__ float key_gap32(uint32_t k) {
  return __uint_as_float((k & kTop32) ? (k ^ kTop32) : ~k);
}

// A bid: the column above the row; kNoBid for a free row that does not bid.
constexpr unsigned long long kNoBid = ~0ull;

// The reduced cost of an order key (twomin.cuh order_key), -0.0 as +0.0 and
// NaN as one class: a gap taken from these differs from one taken from the
// elements at most in the sign of a zero or a NaN's payload, which neither
// the bid's test nor the gap's key nor the price drop can see.
__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == 0) return __uint_as_float(0x7FFFFFFFu);
  const uint32_t u = k - 1u;
  return __uint_as_float((u & kTop32) ? (u ^ kTop32) : ~u);
}

// A row's min1, first argmin and min2 from its merged compare state.
__device__ __forceinline__ void two_min_of(const lapgnn::KeyState& s, float& m1, float& m2,
                                           int& j1) {
  m1 = key_value(s.k1);
  m2 = s.j2 == lapgnn::kNoIndex ? INFINITY : key_value(s.k2);
  j1 = s.j1;
}
template <typename T>
__device__ __forceinline__ void two_min_of(const lapgnn::FloatState<T>& s, T& m1, T& m2,
                                           int& j1) {
  m1 = s.m1;
  m2 = s.m2;
  j1 = s.i1;
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// A block's state, in shared memory (resident) or device memory (global).
template <typename T>
__host__ __device__ constexpr size_t state_bytes(int n) {
  return align16(sizeof(T) * (size_t)n) + align16(4 * (size_t)n);
}

// A block's dynamic shared memory: the free rows' bits, its rows of the
// round, float64 its bids' keys and columns, and the resident state.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int n, int own_cap, int layout) {
  return align16(4 * (size_t)((n + 31) / 32)) + align16(4 * (size_t)own_cap) +
         (sizeof(T) == 8 ? align16(8 * (size_t)own_cap) + align16(4 * (size_t)own_cap) : 0) +
         (layout == kResident ? state_bytes<T>(n) : 0);
}

template <typename T>
struct Arr {
  const T* C;                  // (n, n) row-major
  const long long* x_in;       // (n,) the matching in
  const long long* y_in;
  const T* v_in;
  long long* x;                // (n,) the matching out
  long long* y;
  T* v;
  unsigned long long* slot;    // (kBuffers, n) a column's winner word (0: none)
  unsigned* row_slot;          // (kBuffers, n) float64: a column's lowest row, inverted
  unsigned long long* bids;    // (kBuffers, n) the bid of the free row of each rank
  unsigned* count;             // (kBuffers,) the rounds' numbers of bids
  unsigned* bar;               // the grid barrier's words
  unsigned char* state;        // global layout: state_stride bytes a block
  long long* counts;           // += rounds
  long long state_stride;
  int n, max_rounds, own_cap;
  T min_delta;
};

// A warp's compare state, parked in shared memory for its group's leader.
__device__ __forceinline__ void park(const lapgnn::KeyState& s, unsigned long long& a,
                                     unsigned long long& b, int&) {
  a = lapgnn::pack(s.k1, s.j1);
  b = lapgnn::pack(s.k2, s.j2);
}
__device__ __forceinline__ void unpark(lapgnn::KeyState& s, unsigned long long a,
                                       unsigned long long b, int) {
  s.merge(a, b);
}
template <typename T>
__device__ __forceinline__ void park(const lapgnn::FloatState<T>& s, unsigned long long& a,
                                     unsigned long long& b, int& i) {
  a = (unsigned long long)__double_as_longlong((double)s.m1);
  b = (unsigned long long)__double_as_longlong((double)s.m2);
  i = s.i1;
}
template <typename T>
__device__ __forceinline__ void unpark(lapgnn::FloatState<T>& s, unsigned long long a,
                                       unsigned long long b, int i) {
  s.merge((T)__longlong_as_double((long long)a), i, (T)__longlong_as_double((long long)b));
}

// One thread's share of a row scan: columns gl, gl + g, ... of the group of
// g threads (16-byte vectors of four columns for kVec4), kUnroll loads
// requested before the first compare, a thread's columns in increasing
// order.
template <typename T, typename State, bool kVec4>
__device__ __forceinline__ void scan_share(State& s, const T* __restrict__ crow,
                                           const T* vb, int m, int gl, int g) {
  if constexpr (kVec4) {
    const float4* c4 = reinterpret_cast<const float4*>(crow);
    const float4* v4 = reinterpret_cast<const float4*>(vb);
    const int m4 = m >> 2;
    for (int q0 = gl; q0 < m4; q0 += g * kUnroll) {
      float4 c[kUnroll], w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + g * u;
        if (q < m4) {
          c[u] = __ldg(c4 + q);
          w[u] = LocalV::scan(v4 + q);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (q0 + g * u < m4) lapgnn::push4(s, c[u], w[u], q0 + g * u);
    }
  } else {
    for (int j0 = gl; j0 < m; j0 += g * kUnroll) {
      T c[kUnroll], w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + g * u;
        if (j < m) {
          c[u] = __ldg(crow + j);
          w[u] = LocalV::scan(vb + j);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j0 + g * u < m) s.push(c[u], w[u], j0 + g * u);
    }
  }
}

template <typename T, typename State, bool kVec4, int kLayout>
__global__ void __launch_bounds__(kThreads, 1) arr_kernel(Arr<T> a) {
  constexpr bool kF64 = sizeof(T) == 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long part_a[2][kWarps], part_b[2][kWarps];
  __shared__ int part_i[2][kWarps];
  __shared__ int total_s;
  __shared__ unsigned count_s;

  const int n = a.n, words = (n + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, blocks = gridDim.x;
  const int gthread = b * kThreads + tid, nthreads = blocks * kThreads;

  // shared memory: the bits, the round's rows, float64 their bids, then
  // (resident) the state
  unsigned char* p = smem_raw;
  unsigned* free_l = reinterpret_cast<unsigned*>(p);
  p += align16(4 * (size_t)words);
  int* own = reinterpret_cast<int*>(p);
  p += align16(4 * (size_t)a.own_cap);
  unsigned long long* own_key = reinterpret_cast<unsigned long long*>(p);
  int* own_col = reinterpret_cast<int*>(p + align16(8 * (size_t)a.own_cap));
  if (kF64) p += align16(8 * (size_t)a.own_cap) + align16(4 * (size_t)a.own_cap);
  unsigned char* st = kLayout == kResident ? p : a.state + (size_t)b * a.state_stride;
  T* v_l = reinterpret_cast<T*>(st);
  int* y_l = reinterpret_cast<int*>(st + align16(sizeof(T) * (size_t)n));
  lapgnn::GridBarrier bar(a.bar, (unsigned)blocks);

  // the block's copy of the state, and its share of the outputs
  for (int j = tid; j < n; j += kThreads) {
    v_l[j] = a.v_in[j];
    y_l[j] = (int)a.y_in[j];
  }
  for (int i = tid; i < 32 * words; i += kThreads) {
    const unsigned m = __ballot_sync(kAllLanes, i < n && a.x_in[i] < 0);
    if (lane == 0) free_l[i >> 5] = m;
  }
  for (int i = gthread; i < n; i += nthreads) {
    a.x[i] = a.x_in[i];
    a.y[i] = a.y_in[i];
    a.v[i] = a.v_in[i];
  }
  __syncthreads();

  int rnd = 0, par = 0;
  int free1 = 0, free2 = 0;  // the free rows of the last round and the one before
  unsigned count = 1;
  while (rnd < a.max_rounds && count != 0) {
    const int buf = rnd % kBuffers, old = (rnd + 1) % kBuffers;
    unsigned long long* slot = a.slot + (size_t)buf * n;
    unsigned* row_slot = a.row_slot + (size_t)buf * n;
    unsigned long long* bids = a.bids + (size_t)buf * n;

    // round rnd - 2's slots: every block applied that round before barrier rnd - 1
    for (int k = gthread; k < free2; k += nthreads) {
      const unsigned long long e = __ldcg(a.bids + (size_t)old * n + k);
      if (e == kNoBid) continue;
      __stcg(a.slot + (size_t)old * n + (int)(e >> 32), 0ull);
      if (kF64) __stcg(a.row_slot + (size_t)old * n + (int)(e >> 32), 0u);
    }

    // the bids: this block's free rows, a group of warps a row
    int total;
    const int rows = lapgnn::own_free_rows(free_l, words, own, &total_s, b, blocks, total);
    const int gw = lapgnn::warps_a_row<kWarps>(rows);
    const int groups = kWarps / gw, grp = warp / gw, gl = tid - grp * gw * 32;
    for (int t0 = 0; t0 < rows; t0 += groups) {
      const int t = t0 + grp;
      const int i = t < rows ? own[t] : 0;
      State s;
      s.init();
      if (t < rows) scan_share<T, State, kVec4>(s, a.C + (size_t)i * n, v_l, n, gl, gw * 32);
      s.merge_lanes();
      if (lane == 0) park(s, part_a[par][warp], part_b[par][warp], part_i[par][warp]);
      __syncthreads();
      if (gl == 0 && t < rows) {
        for (int w = warp + 1; w < warp + gw; ++w)
          unpark(s, part_a[par][w], part_b[par][w], part_i[par][w]);
        T m1, m2;
        int j1;
        two_min_of(s, m1, m2, j1);
        const T gap = m2 - m1;
        const bool bid = gap > a.min_delta && isfinite(m2);
        if (bid) {
          if constexpr (kF64) {
            own_key[t] = gap_key(gap);
            atomicMax(slot + j1, own_key[t]);
          } else {
            atomicMax(slot + j1,
                      ((unsigned long long)gap_key32(gap) << 32) | (uint32_t)~(uint32_t)i);
          }
          atomicAdd(a.count + buf, 1u);
        }
        if (kF64) own_col[t] = bid ? j1 : -1;
        __stcg(bids + b + (size_t)t * blocks,
               bid ? ((unsigned long long)j1 << 32) | (uint32_t)i : kNoBid);
      }
      par ^= 1;
    }
    if constexpr (kF64) {
      // the lowest row among the bids that reach the column's largest key
      bar.sync();
      for (int t = tid; t < rows; t += kThreads) {
        const int j = own_col[t];
        if (j >= 0 && own_key[t] == __ldcg(slot + j)) atomicMax(row_slot + j, ~(unsigned)own[t]);
      }
    }
    bar.sync([&] { lapgnn::st_relaxed_gpu(a.count + old, 0u); },
             [&] { count_s = lapgnn::ld_acquire_gpu(a.count + buf); });
    count = count_s;

    // the bids that won, applied to the block's copy; rank k's block writes
    // the outputs
    for (int k0 = tid; count != 0 && k0 < total; k0 += kThreads * kApply) {
      unsigned long long e[kApply], w[kApply];
      unsigned r[kApply];
#pragma unroll
      for (int u = 0; u < kApply; ++u)
        e[u] = k0 + u * kThreads < total ? __ldcg(bids + k0 + u * kThreads) : kNoBid;
#pragma unroll
      for (int u = 0; u < kApply; ++u) {
        if (e[u] == kNoBid) continue;
        w[u] = __ldcg(slot + (int)(e[u] >> 32));
        if (kF64) r[u] = __ldcg(row_slot + (int)(e[u] >> 32));
      }
#pragma unroll
      for (int u = 0; u < kApply; ++u) {
        if (e[u] == kNoBid) continue;
        const int j = (int)(e[u] >> 32), i = (int)(uint32_t)e[u];
        const int row = kF64 ? (int)~r[u] : (int)~(uint32_t)w[u];
        if (row != i) continue;
        const T gap = kF64 ? (T)key_gap(w[u]) : (T)key_gap32((uint32_t)(w[u] >> 32));
        const int kicked = y_l[j];
        if (kicked >= 0) atomicOr(free_l + (kicked >> 5), 1u << (kicked & 31));
        atomicAnd(free_l + (i >> 5), ~(1u << (i & 31)));
        const T nv = v_l[j] - (gap > T(0) ? gap : T(0));
        v_l[j] = nv;
        y_l[j] = i;
        if ((k0 + u * kThreads) % blocks == b) {
          if (kicked >= 0) a.x[kicked] = -1;
          a.x[i] = j;
          a.y[j] = i;
          a.v[j] = nv;
        }
      }
    }
    __syncthreads();
    free2 = free1;
    free1 = total;
    ++rnd;
  }
  if (b == 0 && tid == 0) a.counts[0] += rnd;
}

template <typename T>
void* kernel_of(int vec, int layout) {
  using S = typename std::conditional<sizeof(T) == 8, lapgnn::FloatState<double>,
                                      lapgnn::KeyState>::type;
  if constexpr (sizeof(T) == 8) {
    return layout == kResident ? (void*)arr_kernel<T, S, false, kResident>
                               : (void*)arr_kernel<T, S, false, kGlobal>;
  } else {
    if (vec)
      return layout == kResident ? (void*)arr_kernel<T, S, true, kResident>
                                 : (void*)arr_kernel<T, S, true, kGlobal>;
    return layout == kResident ? (void*)arr_kernel<T, S, false, kResident>
                               : (void*)arr_kernel<T, S, false, kGlobal>;
  }
}

template <typename T>
size_t work_bytes(int n) {
  return lapgnn::kBarrierBytes + 128 + kBuffers * (size_t)n * (8 + 8 + (sizeof(T) == 8 ? 4 : 0));
}

template <typename T>
int launch(const T* C, const long long* x_in, const long long* y_in, const T* v_in,
           long long* x, long long* y, T* v, void* work, void* state, long long* counts,
           int n, int max_rounds, T min_delta, int vec, int layout, int blocks, int own_cap,
           cudaStream_t s) {
  Arr<T> a;
  unsigned char* w = static_cast<unsigned char*>(work);
  a.bar = reinterpret_cast<unsigned*>(w);
  w += lapgnn::kBarrierBytes;
  a.count = reinterpret_cast<unsigned*>(w);
  w += 128;
  a.slot = reinterpret_cast<unsigned long long*>(w);
  w += 8 * kBuffers * (size_t)n;
  a.bids = reinterpret_cast<unsigned long long*>(w);
  w += 8 * kBuffers * (size_t)n;
  a.row_slot = reinterpret_cast<unsigned*>(w);
  a.C = C;
  a.x_in = x_in;
  a.y_in = y_in;
  a.v_in = v_in;
  a.x = x;
  a.y = y;
  a.v = v;
  a.state = static_cast<unsigned char*>(state);
  a.state_stride = (long long)((state_bytes<T>(n) + 255) & ~(size_t)255);
  a.counts = counts;
  a.n = n;
  a.max_rounds = max_rounds;
  a.own_cap = own_cap;
  a.min_delta = min_delta;
  void* kernel = kernel_of<T>(vec, layout);
  const size_t smem = smem_bytes<T>(n, own_cap, layout);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the kernel one SM holds at once with `smem` bytes of dynamic
// shared memory: f64 != 0 for float64, vec != 0 for the float32 form with
// 16-byte loads, layout 0 global, 1 resident; or minus a cudaError_t.
int lapgnn_arr_occupancy(int f64, int vec, int layout, int smem) {
  void* kernel = f64 ? kernel_of<double>(0, layout) : kernel_of<float>(vec, layout);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  return err == cudaSuccess ? occ : -(int)err;
}

// The kernel's static shared memory a block, or minus a cudaError_t.
int lapgnn_arr_static_smem(int f64, int layout) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, f64 ? kernel_of<double>(0, layout) : kernel_of<float>(1, layout));
  return err == cudaSuccess ? (int)attr.sharedSizeBytes : -(int)err;
}

// Bytes of zeroed device memory a launch takes (the barrier's words, the
// rounds' counts of bids, the slots and the bids).
long long lapgnn_arr_work_bytes(int n, int f64) {
  return (long long)(f64 ? work_bytes<double>(n) : work_bytes<float>(n));
}

// C: (n, n) contiguous float32; x_in, y_in (n,) int64 and v_in (n,) float32,
// the matching in, not changed; x, y, v: the matching out; work:
// lapgnn_arr_work_bytes zeroed bytes; state (global layout only): blocks x
// a block's state rounded up to 256 bytes (ops/cuda/arr.py
// arr_state_stride); counts: 1 int64 that the launch adds its rounds to.
// `vec` != 0 for 16-byte loads (n % 4 == 0, C 16-byte aligned); layout 0
// global, 1 resident; `own_cap` >= ceil(n / blocks).  One cooperative launch
// of `blocks` blocks.  Returns a cudaError_t.
int lapgnn_arr(const float* C, const long long* x_in, const long long* y_in, const float* v_in,
               long long* x, long long* y, float* v, void* work, void* state, long long* counts,
               int n, int max_rounds, float min_delta, int vec, int layout, int blocks,
               int own_cap, void* stream) {
  if (vec && (n % 4 != 0 || reinterpret_cast<uintptr_t>(C) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  return launch<float>(C, x_in, y_in, v_in, x, y, v, work, state, counts, n, max_rounds,
                       min_delta, vec, layout, blocks, own_cap, static_cast<cudaStream_t>(stream));
}

// The same for float64 (the float compare state over doubles, two grid
// barriers a round).
int lapgnn_arr_f64(const double* C, const long long* x_in, const long long* y_in,
                   const double* v_in, long long* x, long long* y, double* v, void* work,
                   void* state, long long* counts, int n, int max_rounds, double min_delta,
                   int layout, int blocks, int own_cap, void* stream) {
  return launch<double>(C, x_in, y_in, v_in, x, y, v, work, state, counts, n, max_rounds,
                        min_delta, 0, layout, blocks, own_cap, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
