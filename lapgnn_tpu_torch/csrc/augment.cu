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
// Design.  The grid is cooperative (every block resident, grid.sync()
// between phases).  Columns are cut into tiles of 8, 16 or 32; each tile
// belongs to one block, which reduces it over every row in row order, so
// the column minimum and its first row need no combine across blocks and
// float64 takes the same code.  The sweep's stop test needs the least
// distance over the free columns and over the improved columns: each block
// publishes its partials, and after the one grid sync of the sweep every
// block reduces all of them, so every block decides alike.  red is never
// stored: each pass recomputes it from C, v and u (C stays in L2 at the
// solver's size), so the kernel allocates O(n) scratch where the plain
// version allocates n^2 a pass.  Data that other blocks write during the
// launch (x, y, v, u, d, pred, the candidates, the partials) is read from L2
// (__ldcg): an SM's L1 is not coherent.  The flip is a serial pointer walk
// and runs on one warp of block 0 (its lane 0 walks; the lanes find the
// candidates in order by ballots), between two grid syncs.
//
// Layout.  Each block stages the round's u and x and the sweep's e in its
// shared memory ((2 sizeof(T) + 4) n bytes) where they fit, and every pass
// reads them from there.  Above that (n > 19,370 in float32, 11,622 in
// float64) the kernel is instantiated unstaged: the row pass also writes x
// as int to device memory, the grid writes e there at the start of each
// sweep (one more grid sync a sweep), and the passes read u, x and e
// through L2.  Both layouts do the same arithmetic in the same order.
//
// Bound: while C fits in L2 (n = 2048 in float32), one read of C from
// device memory and the sweeps' float operations (about five an element a
// sweep); above, C read once a sweep (sweeps x n^2 x sizeof(T)).  In
// practice a sweep is one grid sync plus one pass, and the flips and the
// row passes of a few tens of rounds add little.  The thresholds round twice, as
// the eager kernels do (__fmul_rn / __fadd_rn, and the library is built
// with --fmad=false).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "twomin.cuh"

namespace cg = cooperative_groups;

namespace {

using lapgnn::kAllLanes;
using lapgnn::lex_less;
using lapgnn::nan_min;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPathCap = 64;  // jv.py's _PATH_CAP
constexpr int kAhead = 8;     // loads of C requested ahead a thread

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

template <typename T>
struct Aug {
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
  T* part_free[2];     // (blocks,) a block's least new d over the free columns
  T* part_imp[2];      // (blocks,) a block's least new d over the improved columns
  int* part_any[2];    // (blocks,) a block improved a column
  int* go;             // another round
  long long* counts;   // += rounds, sweeps, flip steps
  int n;
  int tile;            // columns a tile: 8, 16 or 32
  T tol;               // 8 eps: the sweep's stop test and the candidates
};

// A per-row vector of the round: from shared memory (staged), or from the
// device memory other blocks wrote, through L2.
template <bool kStaged, typename U>
__device__ __forceinline__ U row_ld(const U* p) {
  return kStaged ? *p : __ldcg(p);
}

// Reduced cost of (i, k): ((C_ik - v_k) - u_i), +0.0 where it is <= 0.
template <typename T>
__device__ __forceinline__ T reduced(T c, T vk, T ui) {
  const T r = (c - vk) - ui;
  return r <= T(0) ? T(0) : r;
}

// The column minimum over every row, first row on ties, NaN smallest, of
// one tile's columns: kSweep, e_i + red_ik; else (d0) red_ik for a free row
// and +inf for a matched one.  Threads (col, rg) stride the rows; thread
// col < tile of the block ends with its column's (best, row).  u_r, e_r
// and x_r are the round's rows (shared or device memory, by kStaged).
template <typename T, bool kSweep, bool kStaged>
__device__ __forceinline__ void tile_min(const Aug<T>& a, int k0, const T* u_r, const T* e_r,
                                         const int* x_r, T* red_v, int* red_i, T& best,
                                         int& brow) {
  const int n = a.n, tw = a.tile, rgs = kThreads / tw;
  const int col = threadIdx.x % tw, rg = threadIdx.x / tw;
  const int k = k0 + col;
  best = INFINITY;
  brow = lapgnn::kNoIndex;
  if (k < n) {
    const T vk = ld(a.v + k);
    const T* ck = a.C + k;
    auto push = [&](T c, int i) {
      const T r = reduced(c, vk, row_ld<kStaged>(u_r + i));
      const T val = kSweep ? row_ld<kStaged>(e_r + i) + r
                           : (row_ld<kStaged>(x_r + i) < 0 ? r : T(INFINITY));
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
  __syncthreads();
  if (threadIdx.x < tw) {
    for (int g = 1; g < rgs; ++g) {
      const T ov = red_v[g * tw + col];
      const int oi = red_i[g * tw + col];
      if (lex_less(ov, oi, best, brow)) {
        best = ov;
        brow = oi;
      }
    }
  }
  __syncthreads();
}

// Block-wide reduction of (NaN-propagating min, min, or); every thread
// gets the result.
template <typename T>
__device__ __forceinline__ void block_reduce(T& f, T& m, int& any, T* sf, T* sm, int* sa) {
  for (int off = 16; off > 0; off >>= 1) {
    f = nan_min(f, __shfl_xor_sync(kAllLanes, f, off));
    m = fmin(m, __shfl_xor_sync(kAllLanes, m, off));
    any |= __shfl_xor_sync(kAllLanes, any, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sf[warp] = f;
    sm[warp] = m;
    sa[warp] = any;
  }
  __syncthreads();
  f = sf[0];
  m = sm[0];
  any = sa[0];
  for (int w = 1; w < kWarps; ++w) {
    f = nan_min(f, sf[w]);
    m = fmin(m, sm[w]);
    any |= sa[w];
  }
  __syncthreads();
}

// Whether a row is free, over the warp: any(x < 0).
__device__ __forceinline__ bool any_free(const long long* x, int n, int lane) {
  bool f = false;
  for (int i = lane; i < n; i += 32) f |= ld(x + i) < 0;
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
  for (int base = 0; base < n; base += 32) {
    const int jl = base + lane;
    unsigned mask = __ballot_sync(kAllLanes, jl < n && ld(a.cand + jl) != 0);
    while (mask) {
      const int j0 = base + __ffs(mask) - 1;
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

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1) augment_kernel(Aug<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_v[kThreads];
  __shared__ int red_i[kThreads];
  __shared__ T sf[kWarps], sm[kWarps];
  __shared__ int sa[kWarps];
  __shared__ int path_rows[kPathCap], path_cols[kPathCap];

  const int n = a.n;
  T* u_s = reinterpret_cast<T*>(smem_raw);    // the round's u
  T* e_s = u_s + n;                            // the sweep's e
  int* x_s = reinterpret_cast<int*>(e_s + n);  // the round's x
  const T* u_r = kStaged ? u_s : a.u;
  const T* e_r = kStaged ? e_s : a.e;
  const int* x_r = kStaged ? x_s : a.xr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blocks = gridDim.x, b = blockIdx.x;
  const int gwarp = b * kWarps + warp, nwarps = blocks * kWarps;
  const int ntiles = (n + a.tile - 1) / a.tile;
  const T inf = INFINITY;

  long long rounds = 0, sweeps = 0, steps = 0;
  if (b == 0 && warp == 0) {
    const bool f = any_free(a.x, n, lane);
    if (lane == 0) *a.go = f ? 1 : 0;
  }
  grid.sync();
  while (ld(a.go)) {
    // row potentials: a warp a row
    for (int i = gwarp; i < n; i += nwarps) {
      const long long xi = ld(a.x + i);
      const T* crow = a.C + (long long)i * n;
      T ui;
      if (xi >= 0) {
        ui = __ldg(crow + xi) - ld(a.v + xi);
      } else {
        ui = inf;
        for (int j = lane; j < n; j += 32) ui = nan_min(ui, __ldg(crow + j) - ld(a.v + j));
        for (int off = 16; off > 0; off >>= 1)
          ui = nan_min(ui, __shfl_xor_sync(kAllLanes, ui, off));
      }
      if (lane == 0) {
        a.u[i] = ui;
        if (!kStaged) a.xr[i] = (int)xi;
      }
    }
    grid.sync();
    if (kStaged) {
      for (int i = tid; i < n; i += kThreads) {
        u_s[i] = ld(a.u + i);
        x_s[i] = (int)ld(a.x + i);
      }
      __syncthreads();
    }

    // d0, pred0: the free rows' column minima
    for (int t = b; t < ntiles; t += blocks) {
      T best;
      int brow;
      tile_min<T, false, kStaged>(a, t * a.tile, u_r, e_r, x_r, red_v, red_i, best, brow);
      const int k = t * a.tile + tid;
      if (tid < a.tile && k < n) {
        a.d[0][k] = best;
        a.pred[0][k] = brow;
      }
    }
    grid.sync();

    // the sweeps
    int s = 0;
    bool more;
    T dmin_free;
    do {
      const T* dc = a.d[s & 1];
      T* dn = a.d[(s + 1) & 1];
      const int* pc = a.pred[s & 1];
      int* pn = a.pred[(s + 1) & 1];
      if (kStaged) {
        for (int i = tid; i < n; i += kThreads) e_s[i] = x_s[i] < 0 ? inf : ld(dc + x_s[i]);
        __syncthreads();
      } else {
        for (int i = b * kThreads + tid; i < n; i += blocks * kThreads) {
          const int xi = ld(a.xr + i);
          a.e[i] = xi < 0 ? inf : ld(dc + xi);
        }
        grid.sync();
      }
      T f = inf, m = inf;
      int any = 0;
      for (int t = b; t < ntiles; t += blocks) {
        T best;
        int brow;
        tile_min<T, true, kStaged>(a, t * a.tile, u_r, e_r, x_r, red_v, red_i, best, brow);
        const int k = t * a.tile + tid;
        if (tid < a.tile && k < n) {
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
      block_reduce(f, m, any, sf, sm, sa);
      if (tid == 0) {
        a.part_free[s & 1][b] = f;
        a.part_imp[s & 1][b] = m;
        a.part_any[s & 1][b] = any;
      }
      grid.sync();
      // every block reduces every block's partials: the same decision
      f = inf;
      m = inf;
      any = 0;
      for (int g = tid; g < blocks; g += kThreads) {
        f = nan_min(f, ld(a.part_free[s & 1] + g));
        m = fmin(m, ld(a.part_imp[s & 1] + g));
        any |= ld(a.part_any[s & 1] + g);
      }
      block_reduce(f, m, any, sf, sm, sa);
      dmin_free = f;
      const T thresh = add_rn(f, mul_rn(a.tol, add_rn(T(1), fabs(f))));
      more = any && m <= thresh;
      ++s;
    } while (more && s <= n);
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
    grid.sync();

    ++rounds;
    if (b == 0 && warp == 0) {
      steps += flip_paths(a, a.pred[s & 1], lane, path_rows, path_cols);
      const bool f = any_free(a.x, n, lane);
      if (lane == 0) *a.go = (f && rounds <= n) ? 1 : 0;
    }
    grid.sync();
  }
  if (b == 0 && tid == 0) {
    a.counts[0] += rounds;
    a.counts[1] += sweeps;
    a.counts[2] += steps;
  }
}

// A block's dynamic shared memory: the round's u and x and the sweep's e
// when staged, none else.
template <typename T>
size_t smem_bytes(int n, bool staged) {
  return staged ? (2 * sizeof(T) + sizeof(int)) * (size_t)n : 0;
}

template <typename T>
void* kernel_of(bool staged) {
  return staged ? (void*)augment_kernel<T, true> : (void*)augment_kernel<T, false>;
}

size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// Scratch of one launch, carved from one buffer.
template <typename T>
size_t work_bytes(int n, int blocks) {
  const size_t vn = align16(sizeof(T) * n), in = align16(sizeof(int) * n), bn = align16(n);
  const size_t vb = align16(sizeof(T) * blocks), ib = align16(sizeof(int) * blocks);
  return 4 * vn + 3 * in + 2 * bn + 4 * vb + 2 * ib + 16;
}

template <typename T>
int launch(const T* C, long long* x, long long* y, T* v, unsigned char* work,
           long long* counts, int n, int blocks, int tile, bool staged, T tol,
           cudaStream_t s) {
  Aug<T> a;
  const size_t vn = align16(sizeof(T) * n), in = align16(sizeof(int) * n), bn = align16(n);
  const size_t vb = align16(sizeof(T) * blocks), ib = align16(sizeof(int) * blocks);
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
  a.part_free[0] = reinterpret_cast<T*>(take(vb));
  a.part_free[1] = reinterpret_cast<T*>(take(vb));
  a.part_imp[0] = reinterpret_cast<T*>(take(vb));
  a.part_imp[1] = reinterpret_cast<T*>(take(vb));
  a.part_any[0] = reinterpret_cast<int*>(take(ib));
  a.part_any[1] = reinterpret_cast<int*>(take(ib));
  a.go = reinterpret_cast<int*>(take(16));
  a.counts = counts;
  a.n = n;
  a.tile = tile;
  a.tol = tol;
  const size_t smem = smem_bytes<T>(n, staged);
  void* kernel = kernel_of<T>(staged);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int n, bool staged) {
  const size_t smem = smem_bytes<T>(n, staged);
  void* kernel = kernel_of<T>(staged);
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
// float64; staged != 0: the rows' vectors in shared memory), or minus a
// cudaError_t.
int lapgnn_augment_occupancy(int n, int f64, int staged) {
  return f64 ? occupancy<double>(n, staged != 0) : occupancy<float>(n, staged != 0);
}

// Bytes of the scratch buffer a launch of `blocks` blocks takes.
long long lapgnn_augment_work_bytes(int n, int blocks, int f64) {
  return (long long)(f64 ? work_bytes<double>(n, blocks) : work_bytes<float>(n, blocks));
}

// C: (n, n) contiguous; x, y: (n,) int64 and v: (n,) updated in place;
// work: lapgnn_augment_work_bytes bytes; counts: 3 int64 that the launch adds
// its rounds, sweeps and flip steps to.  One cooperative launch of `blocks`
// blocks (at most what the card holds at once), tiles of `tile` columns,
// the rows' vectors staged in shared memory when `staged` != 0.  `tol` is
// 8 eps of the type.  Returns a cudaError_t.
int lapgnn_augment(const float* C, long long* x, long long* y, float* v, void* work,
                   long long* counts, int n, int blocks, int tile, int staged, float tol,
                   void* stream) {
  return launch<float>(C, x, y, v, static_cast<unsigned char*>(work), counts, n, blocks, tile,
                       staged != 0, tol, static_cast<cudaStream_t>(stream));
}

int lapgnn_augment_f64(const double* C, long long* x, long long* y, double* v, void* work,
                       long long* counts, int n, int blocks, int tile, int staged, double tol,
                       void* stream) {
  return launch<double>(C, x, y, v, static_cast<unsigned char*>(work), counts, n, blocks, tile,
                        staged != 0, tol, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
