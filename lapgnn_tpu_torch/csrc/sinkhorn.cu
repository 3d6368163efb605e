// The seed policy's Sinkhorn ladder for Hopper: every sweep of the
// log-domain Sinkhorn refinement and the two exact min-trick projections
// that end it, in one cooperative launch.
//
// Replaces the loop of lapgnn_tpu/ops/sinkhorn.py:sinkhorn_refine (:91),
// jnp.logsumexp passes with no Pallas kernel behind them.  Per instance of a
// (B, n, n) float32 batch, with eps = eps_rel[r] * scale the temperature of
// rung r (made here, on the card):
//   v = amin_i(C_r - u0)
//   each rung, each of its sweeps:
//     u_i = -eps * logsumexp_j((v_j - C_r[i, j]) / eps)   (row half-pass)
//     v_j = -eps * logsumexp_i((u_i - C_r[i, j]) / eps)   (column half-pass)
//   u = amin_j(C - v), then v = amin_i(C - u)             (on the true C)
//
// Design.  Each block (one an SM) owns `rows` consecutive rows for both
// half-passes:
//  - row half-pass: a warp a row, each lane every 32nd group of four
//    columns (16-byte loads), v from shared memory; a lane keeps an online
//    logsumexp (running maximum, sum of exponentials scaled to it), the
//    warp merges its lanes by shuffles; u of the block's rows stays in
//    shared memory;
//  - column half-pass: it needs only the block's own u, so no barrier
//    separates it from the row half-pass: a thread a group of four columns
//    folds the block's rows four at a time into a partial (maximum, sum) a
//    column, written to a (blocks, n) scratch;
//  - one grid barrier (grid_barrier.cuh); each block merges the partials of
//    its own ceil(n / blocks) columns (slices of threads a column, then a
//    tree over the slices in shared memory) and writes v; a second barrier
//    hands v to the next row half-pass.
// v's start and the projections are minima over the same structure.
// Layouts: resident (the block's rows of C_r in shared memory for the whole
// launch, read once from device memory; to n of about 2,700 on 132 SMs) or
// streamed (the rows read through L2 every half-pass, 16 bytes a load where
// the rows are 16-byte aligned, 4 otherwise).
//
// Arithmetic as the eager loop's: subtract, divide by eps (IEEE division,
// no fast math), expf / logf in full precision, the scaling by -eps.  A
// logsumexp's NaN and infinities come out as torch.logsumexp's: a NaN wins,
// then +inf; all -inf gives -inf.  The sums run in another order, so u and v
// agree with the loop to a tolerance (ops/cuda/sinkhorn.py); the
// projections are minima of the same differences, bit-equal to the eager
// amins on the same v.
//
// Bound: one read of C_r a half-pass and two of C in the projections,
// (2 * rungs * sweeps + 2) * n^2 * 4 bytes an instance, against an IEEE
// divide, an expf and a few float operations an element a half-pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRungs = 16;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

struct Args {
  const float* cost_r;  // (B, n, n): the matrix the ladder reads
  const float* cost;    // (B, n, n): the true matrix of the projections
  const float* u0;      // (B, n)
  const float* scale;   // (B,)
  float* u;             // (B, n) out
  float* v;             // (B, n) out
  float* ladder;        // (B, n): v between half-passes; the ladder's last v
  float2* part;         // (blocks, n): a block's partial result a column
  unsigned* bar;        // lapgnn::kBarrierBytes, zeroed
  int B, n, n4, rows, rungs, iters;
  float eps_rel[kMaxRungs];
};

// Maximum and minimum that keep a NaN, as torch's amax, amin and logsumexp.
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }

// An online logsumexp: the running maximum m and the sum of exp(z - m).
// While m is not finite (no value yet, or a NaN or +inf seen) s is 0 and
// the result is m itself.
struct Lse {
  float m, s;
};

__device__ __forceinline__ Lse lse_empty() { return {-INFINITY, 0.f}; }

__device__ __forceinline__ void lse_add4(Lse& a, float z0, float z1, float z2, float z3) {
  const float M = nan_max(nan_max(a.m, nan_max(z0, z1)), nan_max(z2, z3));
  a.s = isfinite(M) ? a.s * expf(a.m - M) + (expf(z0 - M) + expf(z1 - M)) +
                          (expf(z2 - M) + expf(z3 - M))
                    : 0.f;
  a.m = M;
}

__device__ __forceinline__ void lse_merge(Lse& a, float m, float s) {
  const float M = nan_max(a.m, m);
  a.s = isfinite(M) ? a.s * expf(a.m - M) + s * expf(m - M) : 0.f;
  a.m = M;
}

__device__ __forceinline__ float lse_value(Lse a) {
  return isfinite(a.m) ? logf(a.s) + a.m : a.m;
}

// Columns 4k .. 4k + 3 of a row of n floats at p; 0 past n.
template <bool kVec>
__device__ __forceinline__ float4 load_row4(const float* __restrict__ p, int k, int n) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p) + k);
  const int c = 4 * k;
  float4 r;
  r.x = __ldg(p + c);
  r.y = c + 1 < n ? __ldg(p + c + 1) : 0.f;
  r.z = c + 2 < n ? __ldg(p + c + 2) : 0.f;
  r.w = c + 3 < n ? __ldg(p + c + 3) : 0.f;
  return r;
}

// Where a pass reads row r of the block (of n4 / 4 groups): the resident
// tile in shared memory, or the rows at p in device memory.
template <bool kTile, bool kVec>
struct Rows {
  const float* p;
  int n, n4;
  __device__ __forceinline__ float4 operator()(int r, int k) const {
    if (kTile) return reinterpret_cast<const float4*>(p + (size_t)r * n4)[k];
    return load_row4<kVec>(p + (size_t)r * n, k, n);
  }
};

// -inf for columns past n: they take no part in a logsumexp.
__device__ __forceinline__ float4 mask_tail(float4 z, int c, int n) {
  if (c + 3 >= n) {
    z.y = c + 1 < n ? z.y : -INFINITY;
    z.z = c + 2 < n ? z.z : -INFINITY;
    z.w = c + 3 < n ? z.w : -INFINITY;
  }
  return z;
}

// Row half-pass: us[r] = -eps * logsumexp_j((vs[j] - C[r, j]) / eps).
template <class R>
__device__ __forceinline__ void row_lse(const R& rows, const float* vs, float* us, int nrows,
                                        int n, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, groups = (n + 3) >> 2;
  for (int r = warp; r < nrows; r += kWarps) {
    Lse acc = lse_empty();
    for (int k = lane; k < groups; k += 32) {
      const float4 c = rows(r, k);
      const float4 w = reinterpret_cast<const float4*>(vs)[k];
      float4 z;
      z.x = (w.x - c.x) / eps;
      z.y = (w.y - c.y) / eps;
      z.z = (w.z - c.z) / eps;
      z.w = (w.w - c.w) / eps;
      z = mask_tail(z, 4 * k, n);
      lse_add4(acc, z.x, z.y, z.z, z.w);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float m = __shfl_xor_sync(kAllLanes, acc.m, off);
      const float s = __shfl_xor_sync(kAllLanes, acc.s, off);
      lse_merge(acc, m, s);
    }
    if (lane == 0) us[r] = -eps * lse_value(acc);
  }
}

// Row minimum of the projection: us[r] = u_out[r] = amin_j(C[r, j] - vs[j]).
template <class R>
__device__ __forceinline__ void row_min(const R& rows, const float* vs, float* us, float* u_out,
                                        int nrows, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, groups = (n + 3) >> 2;
  for (int r = warp; r < nrows; r += kWarps) {
    float acc = INFINITY;
    for (int k = lane; k < groups; k += 32) {
      const float4 c = rows(r, k);
      const float4 w = reinterpret_cast<const float4*>(vs)[k];
      const int j = 4 * k;
      acc = nan_min(acc, c.x - w.x);
      if (j + 1 < n) acc = nan_min(acc, c.y - w.y);
      if (j + 2 < n) acc = nan_min(acc, c.z - w.z);
      if (j + 3 < n) acc = nan_min(acc, c.w - w.w);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) acc = nan_min(acc, __shfl_xor_sync(kAllLanes, acc, off));
    if (lane == 0) {
      us[r] = acc;
      u_out[r] = acc;
    }
  }
}

// Column half-pass, the block's partials: part[j] = (m, s) of
// (us[r] - C[r, j]) / eps over its rows, four rows at a time.
template <class R>
__device__ __forceinline__ void col_lse(const R& rows, const float* us, float2* part, int nrows,
                                        int n, float eps) {
  const int groups = (n + 3) >> 2;
  for (int k = threadIdx.x; k < groups; k += kThreads) {
    Lse acc[4] = {lse_empty(), lse_empty(), lse_empty(), lse_empty()};
    for (int r = 0; r < nrows; r += 4) {
      float z[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r + q < nrows) {
          const float4 c = rows(r + q, k);
          const float ui = us[r + q];
          z[q][0] = (ui - c.x) / eps;
          z[q][1] = (ui - c.y) / eps;
          z[q][2] = (ui - c.z) / eps;
          z[q][3] = (ui - c.w) / eps;
        } else {
          z[q][0] = z[q][1] = z[q][2] = z[q][3] = -INFINITY;
        }
      }
#pragma unroll
      for (int col = 0; col < 4; ++col)
        lse_add4(acc[col], z[0][col], z[1][col], z[2][col], z[3][col]);
    }
    const int j = 4 * k;
#pragma unroll
    for (int col = 0; col < 4; ++col)
      if (j + col < n) part[j + col] = make_float2(acc[col].m, acc[col].s);
  }
}

// The block's partial column minima of C[r, j] - us[r] (in .x).
template <class R>
__device__ __forceinline__ void col_min(const R& rows, const float* us, float2* part, int nrows,
                                        int n) {
  const int groups = (n + 3) >> 2;
  for (int k = threadIdx.x; k < groups; k += kThreads) {
    float4 acc = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    for (int r = 0; r < nrows; ++r) {
      const float4 c = rows(r, k);
      const float ui = us[r];
      acc.x = nan_min(acc.x, c.x - ui);
      acc.y = nan_min(acc.y, c.y - ui);
      acc.z = nan_min(acc.z, c.z - ui);
      acc.w = nan_min(acc.w, c.w - ui);
    }
    const int j = 4 * k;
    if (j < n) part[j] = make_float2(acc.x, 0.f);
    if (j + 1 < n) part[j + 1] = make_float2(acc.y, 0.f);
    if (j + 2 < n) part[j + 2] = make_float2(acc.z, 0.f);
    if (j + 3 < n) part[j + 3] = make_float2(acc.w, 0.f);
  }
}

// After the barrier: block b merges every block's partials of its columns
// c0 .. c0 + cols - 1 and writes out[c] (-eps * logsumexp, or the minimum
// where `lse` is false).  `width` (cols rounded up to a power of two)
// threads a slice; slice p merges partials p, p + slices, ... in turn, then
// the slices merge as a tree in shared memory, slice p taking slice
// p + half for half = slices / 2, ..., 1.
__device__ __forceinline__ void merge_cols(const float2* part, float2* red, float* out, int G,
                                           int n, bool lse, float eps) {
  const int cols = (n + G - 1) / G;
  int width = 1;
  while (width < cols) width <<= 1;
  const int slices = kThreads / width;
  const int lane = threadIdx.x % width, slice = threadIdx.x / width;
  const int c = blockIdx.x * cols + lane;
  const bool live = lane < cols && c < n;
  Lse acc = lse_empty();
  float mn = INFINITY;
  if (live) {
#pragma unroll 4
    for (int b = slice; b < G; b += slices) {
      const float2 p = __ldcg(part + (size_t)b * n + c);
      if (lse) {
        lse_merge(acc, p.x, p.y);
      } else {
        mn = nan_min(mn, p.x);
      }
    }
  }
  red[threadIdx.x] = lse ? make_float2(acc.m, acc.s) : make_float2(mn, 0.f);
  for (int half = slices >> 1; half; half >>= 1) {
    __syncthreads();
    if (slice < half) {
      const float2 q = red[threadIdx.x + half * width];
      if (lse) {
        lse_merge(acc, q.x, q.y);
        red[threadIdx.x] = make_float2(acc.m, acc.s);
      } else {
        mn = nan_min(mn, q.x);
        red[threadIdx.x] = make_float2(mn, 0.f);
      }
    }
  }
  if (live && slice == 0) out[c] = lse ? -eps * lse_value(acc) : mn;
}

template <bool kResident, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) sinkhorn_ladder_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float eps_rel[kMaxRungs];
  float* vs = smem;                                                    // n4
  float* us = vs + a.n4;                                               // rows, padded to 4
  float2* red = reinterpret_cast<float2*>(us + ((a.rows + 3) & ~3));  // kThreads
  float* tile = reinterpret_cast<float*>(red + kThreads);             // rows x n4 (resident)
  const int G = gridDim.x, n = a.n, n4 = a.n4;
  const int r0 = blockIdx.x * a.rows;
  const int nrows = max(0, min(a.rows, n - r0));
  float2* part = a.part + (size_t)blockIdx.x * n;
  lapgnn::GridBarrier bar(a.bar, G);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kMaxRungs; ++q) eps_rel[q] = a.eps_rel[q];
  }
  for (int j = threadIdx.x; j < n4; j += kThreads) vs[j] = 0.f;

  for (int b = 0; b < a.B; ++b) {
    const size_t at = (size_t)b * n * n + (size_t)r0 * n;
    const float* cr = a.cost_r + at;
    float* ladder = a.ladder + (size_t)b * n;
    if (kResident) {
      const int groups = n4 >> 2;
      for (int idx = threadIdx.x; idx < nrows * groups; idx += kThreads) {
        const int r = idx / groups, k = idx - r * groups;
        reinterpret_cast<float4*>(tile + (size_t)r * n4)[k] =
            load_row4<kVec>(cr + (size_t)r * n, k, n);
      }
    }
    for (int r = threadIdx.x; r < nrows; r += kThreads)
      us[r] = __ldg(a.u0 + (size_t)b * n + r0 + r);
    __syncthreads();
    const Rows<kResident, kVec> lad{kResident ? tile : cr, n, n4};
    const float scale = __ldg(a.scale + b);

    col_min(lad, us, part, nrows, n);
    bar.sync();
    merge_cols(a.part, red, ladder, G, n, false, 0.f);
    bar.sync();
    for (int rung = 0; rung < a.rungs; ++rung) {
      const float eps = eps_rel[rung] * scale;
      for (int it = 0; it < a.iters; ++it) {
        for (int j = threadIdx.x; j < n; j += kThreads) vs[j] = __ldcg(ladder + j);
        __syncthreads();
        row_lse(lad, vs, us, nrows, n, eps);
        __syncthreads();
        col_lse(lad, us, part, nrows, n, eps);
        bar.sync();
        merge_cols(a.part, red, ladder, G, n, true, eps);
        bar.sync();
      }
    }
    // The projections, on the true matrix in device memory.
    const Rows<false, kVec> tru{a.cost + at, n, n4};
    for (int j = threadIdx.x; j < n; j += kThreads) vs[j] = __ldcg(ladder + j);
    __syncthreads();
    row_min(tru, vs, us, a.u + (size_t)b * n + r0, nrows, n);
    __syncthreads();
    col_min(tru, us, part, nrows, n);
    bar.sync();
    merge_cols(a.part, red, a.v + (size_t)b * n, G, n, false, 0.f);
    if (b + 1 < a.B) bar.sync();  // the partials, the tile and v are rewritten next
  }
}

using Kernel = void (*)(const Args);

Kernel pick(int resident, int vec) {
  if (resident) {
    return vec ? sinkhorn_ladder_kernel<true, true> : sinkhorn_ladder_kernel<true, false>;
  }
  return vec ? sinkhorn_ladder_kernel<false, true> : sinkhorn_ladder_kernel<false, false>;
}

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

}  // namespace

extern "C" {

// Blocks of the kernel one SM holds at once with `smem` bytes of dynamic
// shared memory, or minus a cudaError_t.
int lapgnn_sinkhorn_occupancy(int smem, int resident, int vec) {
  const Kernel k = pick(resident, vec);
  cudaError_t err =
      cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kThreads, smem);
  return err == cudaSuccess ? occ : -(int)err;
}

// The kernel's static shared memory a block (the largest of its forms), or
// minus a cudaError_t.
int lapgnn_sinkhorn_static_smem(void) {
  int most = 0;
  for (int form = 0; form < 4; ++form) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)pick(form >> 1, form & 1));
    if (err != cudaSuccess) return -(int)err;
    most = (int)attr.sharedSizeBytes > most ? (int)attr.sharedSizeBytes : most;
  }
  return most;
}

// Where the ladder's v (B x n floats) lies in the work bytes.
long long lapgnn_sinkhorn_ladder_offset(void) { return (long long)align256(lapgnn::kBarrierBytes); }

// Bytes of device memory a launch takes: the barrier's words (zeroed by the
// launch), the ladder's v and the blocks' partials.
long long lapgnn_sinkhorn_work_bytes(int B, int n, int blocks) {
  return (long long)(align256(lapgnn::kBarrierBytes) + align256((size_t)B * n * sizeof(float)) +
                     (size_t)blocks * n * sizeof(float2));
}

// cost_r, cost: (B, n, n) float32 contiguous; u0: (B, n); scale: (B,); u, v:
// (B, n) written; work: lapgnn_sinkhorn_work_bytes; eps_rel: `rungs` host
// floats; `iters` sweeps a rung; `blocks` x `rows` >= n, every block holding
// a row; `resident` keeps the rows of cost_r in shared memory; `vec`: n % 4
// == 0 and cost_r, cost 16-byte aligned.  One memset and one cooperative
// launch on `stream`.  Returns a cudaError_t.
int lapgnn_sinkhorn(const float* cost_r, const float* cost, const float* u0, const float* scale,
                    float* u, float* v, void* work, const float* eps_rel, int rungs, int iters,
                    int B, int n, int blocks, int rows, int resident, int vec, void* stream) {
  if (rungs < 0 || rungs > kMaxRungs) return (int)cudaErrorInvalidValue;
  Args a;
  unsigned char* w = static_cast<unsigned char*>(work);
  a.bar = reinterpret_cast<unsigned*>(w);
  a.ladder = reinterpret_cast<float*>(w + align256(lapgnn::kBarrierBytes));
  a.part = reinterpret_cast<float2*>(w + align256(lapgnn::kBarrierBytes) +
                                     align256((size_t)B * n * sizeof(float)));
  a.cost_r = cost_r;
  a.cost = cost;
  a.u0 = u0;
  a.scale = scale;
  a.u = u;
  a.v = v;
  a.B = B;
  a.n = n;
  a.n4 = (n + 3) & ~3;
  a.rows = rows;
  a.rungs = rungs;
  a.iters = iters;
  for (int q = 0; q < kMaxRungs; ++q) a.eps_rel[q] = q < rungs ? eps_rel[q] : 0.f;
  const size_t smem = 4 * ((size_t)a.n4 + ((rows + 3) & ~3)) + sizeof(float2) * kThreads +
                      (resident ? 4 * (size_t)rows * a.n4 : 0);
  const Kernel k = pick(resident, vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(a.bar, 0, lapgnn::kBarrierBytes, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)k, dim3(blocks), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
