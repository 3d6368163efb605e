// DualGNN's edge MLP and its two edge terms in one pass, for Hopper.
//
// Replaces the edge MLP of lapgnn_tpu/models/dual_gnn.py (DualLayer,
// :107-112), a plain nn.Dense chain that XLA compiles and that has no Pallas
// kernel.  Eagerly the port ran it as five launches over every edge (fc1,
// GELU, fc2, GELU, fc3, then the product with the block-diagonal edge
// weight E), each writing its whole activation to device memory: at
// n = 2048 that is 2 GiB each for fc1, both GELUs and fc2 and 4 GiB for fc3,
// about 24 GiB of traffic and 440 GFLOP a layer.  The edge MLP's output e is
// read only through e·E, so fc3 folds into E: with Wf = W3ᵀ·E (128 x out)
// and bf = b3·E, made by the caller on the card, each edge's terms are
//
//   t = GELU(GELU(x·W1ᵀ + b1)·W2ᵀ + b2)·Wf + bf,   x the edge's 10 features.
//
// GELU is the exact form PyTorch's CUDA kernel takes,
// x * 0.5 * (1 + erf(x * sqrt(1/2))).
//
// Bound on this card: 2·10·128 + 2·128·128 + 2·128·out float32 operations an
// edge (37,376 at out = 8, 156.8 GFLOP a layer at n = 2048: 2.34 ms at
// 67 TFLOP/s), against 40 bytes read and 4·out written an edge (0.09 ms at
// 3.35 TB/s).  The pass is bound by the FFMA pipes, and the exact erff of
// 256 GELUs an edge adds about a quarter to the multiply-adds.  Design:
//   * a persistent grid, one block an SM, each holding W1, b1, W2 transposed
//     (64 KB), b2, Wf transposed and bf in shared memory for the whole
//     launch, walking tiles of 128 consecutive edges;
//   * warp-specialised: 4 producer warps copy the next tile's edge features
//     (5,120 contiguous bytes) into shared memory by cp.async and run fc1
//     and its GELU into one of two h1 buffers, while 8 consumer warps run
//     fc2, its GELU and the fold on the other; named barriers hand each
//     buffer over ("full", "free"), so fc1 and the loads hide under fc2;
//   * h1 is stored feature-major: a producer warp takes one feature at a
//     time (W1's row read by broadcast), a lane 4 edges, and fc2 reads h1 by
//     broadcast without bank conflicts;
//   * fc2: a register-tiled SGEMM out of shared memory, each consumer thread
//     an 8 x 8 tile (edges ty·4 + i and 64 + ty·4 + i, features tx·4 + j
//     and 64 + tx·4 + j) summed over K = 128; its GELU stays in registers;
//   * the 128 -> out fold from registers, two edges and 8 outputs at a time
//     (so that no register spills): each thread's partial sums over its 8
//     features; the 16 threads that share an edge row sit in one half-warp
//     and reduce by a butterfly that also scatters (shuffle steps of 8, 4, 2
//     and 1 values), leaving each lane one output, which it writes.
// Nothing 128-wide reaches device memory; the launch reads each edge's
// features once and writes its terms once.
//
// The sums run in another order than the eager chain's (fc3's 128-term dot
// products and E's meet in one), so the terms agree with it within float32
// rounding, not bit for bit.  NaN and infinities propagate as PyTorch's CUDA
// operations propagate them on the folded chain.
//
// C interface for ctypes: each launch returns its CUDA error code (0 when
// the launch was accepted).  No allocation, no synchronisation; it runs on
// the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kIn = 10;       // features an edge
constexpr int kHid = 128;     // the edge MLP's width
constexpr int kTile = 128;    // edges a tile
constexpr int kConsumers = 256;  // fc2, GELU, the fold: warps 0-7
constexpr int kProducers = 128;  // the loads, fc1, GELU: warps 8-11
constexpr int kThreads = kConsumers + kProducers;
constexpr int kChunk = 8;     // outputs folded at once
constexpr int kMaxOut = 32;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

__host__ __device__ constexpr int padded_out(int out) { return (out + kChunk - 1) / kChunk * kChunk; }

// Shared memory, in floats: W2ᵀ (k-major), two h1 buffers (feature-major),
// two tiles of edge features, W1, b1, b2, Wfᵀ (padded to whole chunks), bf.
__host__ __device__ constexpr int smem_floats(int out) {
  return kHid * kHid + 2 * kHid * kTile + 2 * kTile * kIn + kHid * kIn + 2 * kHid +
         padded_out(out) * kHid + padded_out(out);
}

__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ void copy_async(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void copy_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Named barriers: 1 the producers among themselves; 2 + b "h1[b] is full",
// 4 + b "h1[b] is free" between producers and consumers.
constexpr int kBarProducers = 1, kBarFull = 2, kBarFree = 4;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The features of `count` edges from `src` into `dst`: 16-byte copies and an
// 8-byte tail where `src` is 16-byte aligned (a tile's bytes are a multiple
// of 8), 4-byte copies otherwise.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int count, bool vec16,
                                          int p) {
  const int floats = count * kIn;
  if (vec16) {
    const int quads = floats / 4;
    for (int c = p; c < quads; c += kProducers) copy_async(dst + 4 * c, src + 4 * c, 16);
    if (floats % 4 && p == 0) copy_async(dst + 4 * quads, src + 4 * quads, 8);
  } else {
    for (int c = p; c < floats; c += kProducers) copy_async(dst + c, src + c, 4);
  }
}

// One step of the half-warp's reduce-scatter: the lanes whose bit M of tx is
// set keep the upper HALF values and send the lower, the others the reverse.
template <int M, int HALF>
__device__ __forceinline__ void fold_step(float (&v)[16], int tx) {
  const bool upper = (tx & M) != 0;
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float send = upper ? v[q] : v[q + HALF];
    const float keep = upper ? v[q + HALF] : v[q];
    v[q] = keep + __shfl_xor_sync(kAllLanes, send, M);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dual_edge_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ wf,
                 const float* __restrict__ bf, float* __restrict__ out, long long edges,
                 int out_dim, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const int outp = padded_out(out_dim);
  float* w2t = smem;                       // [k][j] = W2[j][k]
  float* h1 = w2t + kHid * kHid;           // two buffers of [feature][edge]
  float* xs = h1 + 2 * kHid * kTile;       // two tiles of [edge][10]
  float* w1s = xs + 2 * kTile * kIn;       // [feature][10]
  float* b1s = w1s + kHid * kIn;
  float* b2s = b1s + kHid;
  float* wft = b2s + kHid;                 // [output][feature], zero past out_dim
  float* bfs = wft + outp * kHid;

  const int tid = threadIdx.x;
  const long long tiles = (edges + kTile - 1) / kTile;

  for (int i = tid; i < kHid * kHid; i += kThreads) {
    const int k = i / kHid, j = i % kHid;
    w2t[i] = w2[j * kHid + k];
  }
  for (int i = tid; i < kHid * kIn; i += kThreads) w1s[i] = w1[i];
  for (int i = tid; i < kHid; i += kThreads) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
  }
  for (int i = tid; i < outp * kHid; i += kThreads) {
    const int o = i / kHid, f = i % kHid;
    wft[i] = o < out_dim ? wf[f * out_dim + o] : 0.0f;
  }
  for (int i = tid; i < outp; i += kThreads) bfs[i] = i < out_dim ? bf[i] : 0.0f;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  if (tid >= kConsumers) {
    // producers: each tile's features in, then fc1 and GELU into h1[it & 1]
    const int p = tid - kConsumers, pw = warp - kConsumers / 32;
    long long tile = blockIdx.x;
    if (tile < tiles)
      load_tile(xs, x + tile * kTile * kIn, (int)min((long long)kTile, edges - tile * kTile),
                vec16, p);
    copy_commit();
    for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
      const long long next = tile + gridDim.x;
      if (next < tiles)
        load_tile(xs + ((it + 1) & 1) * kTile * kIn, x + next * kTile * kIn,
                  (int)min((long long)kTile, edges - next * kTile), vec16, p);
      copy_commit();
      copy_wait_one();
      bar_sync(kBarProducers, kProducers);  // this tile's features have landed
      const int b = it & 1;
      if (it >= 2) bar_sync(kBarFree + b, kThreads);  // the consumers are done with h1[b]
      float* hb = h1 + b * kHid * kTile;
      const float* xt = xs + b * kTile * kIn;
      float xv[4][kIn];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2* row = reinterpret_cast<const float2*>(xt + (lane + 32 * r) * kIn);
#pragma unroll
        for (int m = 0; m < kIn / 2; ++m) {
          const float2 v = row[m];
          xv[r][2 * m] = v.x;
          xv[r][2 * m + 1] = v.y;
        }
      }
#pragma unroll 2
      for (int j = 0; j < kHid / 4; ++j) {
        const int f = pw + 4 * j;
        float w[kIn];
        const float2* wrow = reinterpret_cast<const float2*>(w1s + f * kIn);
#pragma unroll
        for (int m = 0; m < kIn / 2; ++m) {
          const float2 v = wrow[m];
          w[2 * m] = v.x;
          w[2 * m + 1] = v.y;
        }
        const float bias = b1s[f];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float a = bias;
#pragma unroll
          for (int k = 0; k < kIn; ++k) a = fmaf(w[k], xv[r][k], a);
          hb[f * kTile + lane + 32 * r] = gelu(a);
        }
      }
      bar_sync(kBarProducers, kProducers);  // every producer is done with xs[b]
      bar_arrive(kBarFull + b, kThreads);
    }
    return;
  }

  // consumers: fc2 and GELU on h1[it & 1], the fold, the terms out
  const int ty = 2 * warp + (lane >> 4);  // fc2's edge group: edges ty*4 + i, 64 + ty*4 + i
  const int tx = lane & 15;               // fc2's feature group: tx*4 + j, 64 + tx*4 + j
  long long tile = blockIdx.x;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int b = it & 1;
    bar_sync(kBarFull + b, kThreads);
    const float* h1b = h1 + b * kHid * kTile;
    // fc2 from shared memory, 8 x 8 a thread; then GELU in registers.
    float acc[8][8];
    {
      const float4 bA = *reinterpret_cast<const float4*>(b2s + tx * 4);
      const float4 bB = *reinterpret_cast<const float4*>(b2s + 64 + tx * 4);
      const float bias[8] = {bA.x, bA.y, bA.z, bA.w, bB.x, bB.y, bB.z, bB.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = bias[j];
    }
#pragma unroll 4
    for (int k = 0; k < kHid; ++k) {
      const float4 aA = *reinterpret_cast<const float4*>(h1b + k * kTile + ty * 4);
      const float4 aB = *reinterpret_cast<const float4*>(h1b + k * kTile + 64 + ty * 4);
      const float4 wA = *reinterpret_cast<const float4*>(w2t + k * kHid + tx * 4);
      const float4 wB = *reinterpret_cast<const float4*>(w2t + k * kHid + 64 + tx * 4);
      const float a[8] = {aA.x, aA.y, aA.z, aA.w, aB.x, aB.y, aB.z, aB.w};
      const float w[8] = {wA.x, wA.y, wA.z, wA.w, wB.x, wB.y, wB.z, wB.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    if (tile + 2LL * gridDim.x < tiles) bar_arrive(kBarFree + b, kThreads);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = gelu(acc[i][j]);

    // The fold, 8 outputs at a time: partial sums over this thread's 8
    // features, then the half-warp's reduce-scatter.
    const int tile_edges = (int)min((long long)kTile, edges - tile * kTile);
#pragma unroll 1
    for (int c = 0; c < outp; c += kChunk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float v[16];  // v[i*8 + o]: edge slot 2h + i, output c + o
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = 0.0f;
#pragma unroll
        for (int o = 0; o < kChunk; ++o) {
          const float* wo = wft + (c + o) * kHid;
          const float4 wA = *reinterpret_cast<const float4*>(wo + tx * 4);
          const float4 wB = *reinterpret_cast<const float4*>(wo + 64 + tx * 4);
          const float w[8] = {wA.x, wA.y, wA.z, wA.w, wB.x, wB.y, wB.z, wB.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) v[i * 8 + o] = fmaf(acc[2 * h + i][j], w[j], v[i * 8 + o]);
        }
        fold_step<8, 8>(v, tx);
        fold_step<4, 4>(v, tx);
        fold_step<2, 2>(v, tx);
        fold_step<1, 1>(v, tx);
        // this lane holds output c + (tx & 7) of edge slot 2h + tx/8
        const int slot = 2 * h + (tx >> 3);
        const int row = slot < 4 ? ty * 4 + slot : 64 + ty * 4 + (slot - 4);
        const int o = c + (tx & 7);
        if (row < tile_edges && o < out_dim)
          out[(tile * kTile + row) * (long long)out_dim + o] = v[0] + bfs[o];
      }
    }
  }
}

}  // namespace

extern "C" {

// x: (edges, 10) float32, contiguous, 4-byte aligned; w1 (128, 10), b1 (128),
// w2 (128, 128), b2 (128), wf (128, out_dim), bf (out_dim): float32,
// contiguous; out: (edges, out_dim) float32, 16-byte aligned.  blocks: at
// most the SMs (a block's shared memory leaves room for no second one).
int lapgnn_dual_edge(const float* x, const float* w1, const float* b1, const float* w2,
                     const float* b2, const float* wf, const float* bf, float* out,
                     long long edges, int out_dim, int blocks, cudaStream_t stream) {
  if (edges < 1 || out_dim < 1 || out_dim > kMaxOut || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * smem_floats(out_dim);
  const cudaError_t err = cudaFuncSetAttribute(
      dual_edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec16 = ((uintptr_t)x % 16) == 0;
  dual_edge_kernel<<<blocks, kThreads, smem, stream>>>(x, w1, b1, w2, b2, wf, bf, out, edges,
                                                      out_dim, vec16);
  return (int)cudaGetLastError();
}

}  // extern "C"
