// Column minimum (K1) and fused min-trick (K2) for Hopper.
//
// Replaces the Pallas kernels of lapgnn_tpu/ops/pallas/colmin.py:
//   pallas_col_min   (_colmin_kernel):   out_j = min_i C_ij
//   pallas_min_trick (_mintrick_kernel): v_j   = min_i (C_ij - u_i)
//
// Bound: device-memory bytes.  Each call reads C once (B*n*m*4 bytes) and
// does one subtraction and one comparison per element, far below the card's
// arithmetic rate.  That bound (5 us at n = m = 2048) leaves out what a read
// of 16 MB mostly consists of on this card: a launch, the ramp until every SM
// has loads in flight, and the tail.  Measured on an H100, no single-pass
// read of 16 MB, the framework's own reductions included, comes under three
// times the bound from a flushed L2 or under twice with the matrix in L2,
// and keeping more bytes in flight (more rows ahead, more warps, larger
// clusters) moves that by a microsecond at most.  What a design can remove
// is what is not the read: the second launch, the scratch and its
// allocation were 3 us of the earlier kernel's 20.
//
// The TPU kernel carries a running minimum across a sequential grid.
// Hopper's blocks run in no order, so the rows are split across blocks and
// the partial minima must meet somewhere.  Two paths:
//
//   * cluster (colmin_cluster): one launch, no scratch.  A tile of 128
//     columns belongs to one thread block cluster whose blocks split the
//     rows.  In a block each warp strides over the block's rows, reading
//     512 contiguous bytes of a row (one 16-byte load a lane when m % 4 == 0
//     and the bases are 16-byte aligned, four 4-byte loads otherwise), with
//     kAhead rows requested before the first compare (eight for a batch
//     within L2, four beyond, as measured; one was slower everywhere).  u is
//     read one float a lane for 32 rows of the stripe and handed round by
//     shuffles, so C - u never leaves registers.  The warps of a block merge through shared
//     memory, the blocks of a cluster through distributed shared memory:
//     rank 0 reads the other ranks' partials and writes the tile of the
//     output.  The second cluster.sync() keeps every block's shared memory
//     alive until rank 0 has read it.  The caller keeps the grid within
//     two blocks an SM, with smaller clusters for larger matrices, so that
//     every cluster is resident at once: a cluster left to a second wave
//     cost 10% at n = 8192.
//   * two_launch (colmin_partial + colmin_finish): one thread a column, the
//     rows cut into chunks across grid.y, partial minima written to a
//     (B, chunks, m) scratch that a second small launch reduces.  Kept for
//     tall, narrow matrices, whose few clusters would leave each warp
//     hundreds of rows to walk on a card mostly empty; the caller chooses
//     (col_min_geometry).
//
// A minimum is exact in any order, so both paths equal the plain PyTorch
// version (C - u[:, None]).amin(0) bit for bit, with one exception, and are
// deterministic: no atomics, a fixed merge order.  Every merge level uses
// nan_min, which propagates a NaN as amin does (a NaN in u makes every
// column NaN).  The exception is the sign of a zero: where a column's
// minimum is zero and the column holds both -0.0 and +0.0, nan_min keeps the
// zero it met first in its own order (lowest rank, then lowest warp, then
// earliest row of the stripe), and amin keeps the one its own order meets;
// the two compare equal and may differ in the sign bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // two_launch: one thread a column
constexpr int kTile = 128;     // cluster: columns a cluster owns, 4 a lane
constexpr int kMaxWarps = 16;  // cluster: 512 threads leave 128 registers each
constexpr int kMaxCluster = 8;  // the portable limit; 16 was measured no faster
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

__device__ __forceinline__ float nan_min(float acc, float x) {
  // amin semantics: a NaN anywhere makes the minimum NaN.  Of two equal
  // values the first seen stays.
  return (x < acc || isnan(x)) ? x : acc;
}

// ---------------------------------------------------------------- cluster

// A lane's four columns of one row, from p = the row's element at the lane's
// first column: p[0..3] (one 16-byte load) or p[0], p[32], p[64], p[96] (four
// 4-byte loads).  Columns beyond m (`in` false) read as +inf and are never
// written.
template <bool kVec>
__device__ __forceinline__ void load4(float (&x)[4], const float* __restrict__ p,
                                      const bool (&in)[4]) {
  if (kVec) {
    if (in[0]) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = INFINITY;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = in[q] ? __ldg(p + 32 * q) : INFINITY;
  }
}

// grid (tiles * cluster, 1, B), cluster (cluster, 1, 1), block of `warps`
// warps, dynamic shared memory (warps + 1) * kTile floats.  Block `rank` of
// a cluster owns rows [rank * rows_per_block, (rank + 1) * rows_per_block),
// warp w of it the rows first + w, first + w + warps, ...  A block beyond the
// last row has nothing to read and still takes part in both cluster.sync()s
// with +inf partials.
template <bool kHasU, bool kVec, int kAhead>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    colmin_cluster(const float* __restrict__ C, const float* __restrict__ u,
                   float* __restrict__ out, int n, int m, int rows_per_block) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cluster_size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / cluster_size;
  const int b = blockIdx.z;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* block_part = smem + warps * kTile;

  const long long first = (long long)rank * rows_per_block + warp;
  const long long end = min((long long)n, (long long)(rank + 1) * rows_per_block);
  const int count = first < end ? (int)((end - first + warps - 1) / warps) : 0;
  const int c0 = tile * kTile + (kVec ? 4 * lane : lane);
  bool in[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) in[q] = c0 + (kVec ? 0 : 32 * q) < m;
  const long long step = (long long)warps * m;
  // the stripe's next row at the lane's first column, and its u
  const float* p = C + ((long long)b * n + first) * m + c0;
  const float* up = kHasU ? u + (long long)b * n + first : nullptr;

  float acc[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  for (int left = count; left > 0; left -= 32) {
    const int lim = min(32, left);
    // u of the next 32 rows of the stripe, one a lane
    float mine = 0.0f;
    if (kHasU && lane < lim) mine = __ldg(up + (long long)lane * warps);
    int k = 0;
    for (; k + kAhead <= lim; k += kAhead) {
      float x[kAhead][4];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) load4<kVec>(x[a], p + a * step, in);
      p += kAhead * step;
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const float ui = kHasU ? __shfl_sync(kAllLanes, mine, k + a) : 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = nan_min(acc[q], kHasU ? x[a][q] - ui : x[a][q]);
      }
    }
    for (; k < lim; ++k) {
      float x[4];
      load4<kVec>(x, p, in);
      p += step;
      const float ui = kHasU ? __shfl_sync(kAllLanes, mine, k) : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = nan_min(acc[q], kHasU ? x[q] - ui : x[q]);
    }
    if (kHasU) up += 32 * warps;
  }

  // Warps merge through shared memory; slot t of a row of kTile floats is
  // column tile * kTile + t in either load form.
  float* mine_part = smem + warp * kTile;
  if (kVec) {
    *reinterpret_cast<float4*>(mine_part + 4 * lane) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) mine_part[lane + 32 * q] = acc[q];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kTile) {
    float a = smem[t];
    for (int w = 1; w < warps; ++w) a = nan_min(a, smem[w * kTile + t]);
    block_part[t] = a;
  }
  // Blocks merge through distributed shared memory.
  cluster.sync();
  if (rank == 0 && t < kTile) {
    float a = block_part[t];
    for (int r = 1; r < cluster_size; ++r)
      a = nan_min(a, cluster.map_shared_rank(block_part, r)[t]);
    const int col = tile * kTile + t;
    if (col < m) out[(long long)b * m + col] = a;
  }
  // No block may exit while rank 0 still reads its shared memory.
  cluster.sync();
}

using ClusterKernel = void (*)(const float*, const float*, float*, int, int, int);

template <bool kHasU, bool kVec>
ClusterKernel pick_ahead(int ahead) {
  switch (ahead) {
    case 4: return colmin_cluster<kHasU, kVec, 4>;
    case 8: return colmin_cluster<kHasU, kVec, 8>;
    default: return nullptr;
  }
}

ClusterKernel pick(bool has_u, bool vec, int ahead) {
  if (has_u) return vec ? pick_ahead<true, true>(ahead) : pick_ahead<true, false>(ahead);
  return vec ? pick_ahead<false, true>(ahead) : pick_ahead<false, false>(ahead);
}

bool cluster_shape_ok(int cluster, int warps) {
  const bool pow2 = cluster > 0 && (cluster & (cluster - 1)) == 0;
  return pow2 && cluster <= kMaxCluster && warps >= kTile / 32 && warps <= kMaxWarps;
}

// The launch configuration of `tiles` column tiles; `attr` must outlive it.
cudaLaunchConfig_t cluster_config(long long tiles, int B, int cluster, int warps,
                                  cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * cluster), 1, (unsigned)B);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = (size_t)(warps + 1) * kTile * sizeof(float);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// ---------------------------------------------------------------- two_launch

template <bool kHasU>
__global__ void __launch_bounds__(kThreads)
    colmin_partial(const float* __restrict__ C, const float* __restrict__ u,
                   float* __restrict__ part, int n, int m, int rows_per_chunk) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= m) return;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  const float* col = C + ((long long)b * n) * m + j;
  const float* ub = kHasU ? u + (long long)b * n : nullptr;
  float acc = INFINITY;
  for (int i = r0; i < r1; ++i) {
    float x = col[(long long)i * m];
    if (kHasU) x = x - ub[i];
    acc = nan_min(acc, x);
  }
  part[((long long)b * gridDim.y + chunk) * m + j] = acc;
}

__global__ void __launch_bounds__(kThreads)
    colmin_finish(const float* __restrict__ part, float* __restrict__ out,
                  int chunks, int m) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= m) return;
  const float* p = part + (long long)b * chunks * m + j;
  float acc = INFINITY;
  for (int c = 0; c < chunks; ++c) acc = nan_min(acc, p[(long long)c * m]);
  out[(long long)b * m + j] = acc;
}

}  // namespace

extern "C" {

// The cluster path.  C: (B, n, m) f32 contiguous; u: (B, n) f32 or null
// (plain column min); out: (B, m).  The caller chooses the geometry: `vec`
// != 0 for 16-byte loads (m % 4 == 0, C 16-byte aligned), `ahead` 4 or 8
// rows requested before the compares, `cluster` blocks (a power of two up to
// 8) of `warps` warps (4 to 16) a column tile, `rows_per_block` rows each,
// cluster * rows_per_block >= n.  Returns a cudaError_t; a refused cluster
// launch is an error like any other.
int lapgnn_colmin_cluster(const float* C, const float* u, float* out, int B, int n,
                          int m, int vec, int ahead, int cluster, int warps,
                          int rows_per_block, void* stream) {
  ClusterKernel kernel = pick(u != nullptr, vec != 0, ahead);
  if (kernel == nullptr || !cluster_shape_ok(cluster, warps) || rows_per_block < 1 ||
      (long long)cluster * rows_per_block < n ||
      (vec && (m % 4 != 0 || reinterpret_cast<uintptr_t>(C) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const long long tiles = ((long long)m + kTile - 1) / kTile;
  const cudaLaunchConfig_t cfg = cluster_config(
      tiles, B, cluster, warps, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, C, u, out, n, m, rows_per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of this shape the card can hold at once
// (cudaOccupancyMaxActiveClusters); minus the cudaError_t on failure.  0
// means the launch would be refused at run time.
int lapgnn_colmin_max_active_clusters(int has_u, int vec, int ahead, int cluster,
                                      int warps) {
  ClusterKernel kernel = pick(has_u != 0, vec != 0, ahead);
  if (kernel == nullptr || !cluster_shape_ok(cluster, warps))
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, 1, cluster, warps, nullptr, &attr);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// The two_launch path.  part: (B, chunks, m) scratch.  Returns
// cudaGetLastError().
int lapgnn_colmin(const float* C, const float* u, float* part, float* out,
                  int B, int n, int m, int chunks, int rows_per_chunk,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kThreads - 1) / kThreads, chunks, B);
  if (u != nullptr) {
    colmin_partial<true><<<grid, kThreads, 0, s>>>(C, u, part, n, m,
                                                   rows_per_chunk);
  } else {
    colmin_partial<false><<<grid, kThreads, 0, s>>>(C, u, part, n, m,
                                                    rows_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((m + kThreads - 1) / kThreads, B);
  colmin_finish<<<grid2, kThreads, 0, s>>>(part, out, chunks, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
