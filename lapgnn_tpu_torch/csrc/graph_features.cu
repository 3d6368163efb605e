// DualGNN's dense graph features for Hopper: the 14-D row and column node
// features and the 10-channel (B, n, m) edge tensor of
// lapgnn_tpu_torch/ops/features.py:graph_features, from two launches.
//
// Replaces no Pallas kernel: the JAX package computes these features in
// plain jnp (lapgnn_tpu/ops/features.py:graph_features), two stable
// argsorts and two value sorts a call that XLA compiles.  In eager PyTorch
// the same chain is about 800 small launches and several blocking copies
// of constants a call, so the card mostly waits for the host.
//
// What the kernels compute, per line (a row of C, or a column), exactly as
// the sort-based plain version does:
//   * the line sorted by (value, index) as one 64-bit key: the float's
//     order-isomorphic image above (-0.0 mapped to +0.0, every NaN to the
//     top, as torch's sort orders them), the index below; so the position
//     of an entry in the sorted line is its rank under
//     torch.argsort(stable=True), and the sorted values are torch.sort's;
//   * min and max (the ends of the sorted line; both NaN on a line that
//     holds one, as amin and amax give them), the median (0.5f * (a + b)
//     for an even length) and the MAD, the k-th smallest of |x - med| by
//     _kth_of_merged's own bisection over the two sorted halves (med - x
//     below the middle, x - med above), clamped at EPS: the same float
//     expressions as _median_from_sorted / _mad_from_sorted, so these agree
//     bit for bit, NaNs included;
//   * the tie fraction, count((x - min) <= TAU) / length, and the rank over
//     length - 1, both as true divisions (as _exact_div keeps them);
//   * mean, population std and the entropy of softmax(-x), as block sums in
//     a fixed order: the median-shifted mean and a two-pass std, expf and
//     logf without --use_fast_math.  Torch sums in another order, so these
//     agree within a few ulps, not bit for bit;
//   * the node's positional columns sin / cos(2*pi*pos*f / max(1, N - 1)),
//     f in (1, 2, 4, 8), with the division taken as torch takes it on the
//     card (a product with the float reciprocal).
// The column pass (one block a column) writes the column node features,
// each entry's column rank into a (B, n, m) scratch and the column's min,
// tie fraction and entropy into a (B, m) scratch.  The row pass (one block
// a row) then writes the row node features and the row's whole edge row:
// scaled cost, row rank, column rank, row gap, column gap, row tie, column
// tie, row entropy, column entropy, 0.  Everything builds with
// --fmad=false, so no product and sum fuse where the plain version rounds
// twice.
//
// Bound on this card: bytes, C read once and the edge tensor written once,
// (4 + 40) B an entry: 0.055 ms at (1, 2048) at 3.35 TB/s.  This design
// moves 56 B an entry (C read by both passes, the column ranks written and
// read back).  What sets the pace is the sort: a bitonic network over the
// next power of two L of the line, L/2 * log2(L) * (log2(L) + 1) / 2
// compare-exchanges a line (67,584 at L = 2048), each two 8-byte reads and
// writes of shared memory, so shared-memory bandwidth and the block's
// barriers bound it.  The design keeps the line in shared memory for the whole block (12 bytes an
// entry, 16 in the row pass, plus a warp's 32-edge staging tile), runs
// every stage whose pairs stay inside a warp's 64-key segment under
// __syncwarp instead of a block barrier (every stage up to k = 64, and the
// last five of each later k), and writes the interleaved edge row through
// the staging tile so that each warp stores 128 contiguous bytes at a time.
// The column pass reads its column with a stride of m floats; C (16 MB at
// 2048) and the rank scratch stay in the 50 MB L2 between the passes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNodeDim = 14;   // min, max, mean, std, MAD, entropy, 8 positional
constexpr int kEdgeDim = 10;
constexpr int kFreqs = 4;      // POS_FREQS = (1, 2, 4, 8)
static_assert(kNodeDim == 6 + 2 * kFreqs, "six statistics, then sin and cos a frequency");
constexpr int kMaxThreads = 512;
constexpr int kStageFloats = 32 * kEdgeDim;  // a warp's tile of 32 edges
constexpr float kTau = 1e-3f;
constexpr float kEps = 1e-9f;
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr unsigned kAllLanes = 0xFFFFFFFFu;
constexpr unsigned long long kPad = ~0ull;  // sorts after every entry

__host__ __device__ constexpr int next_pow2(int x) {
  int L = 1;
  while (L < x) L <<= 1;
  return L;
}

// Threads of a block for a line padded to L: one compare-exchange a thread
// a stage up to 512 threads, at least one warp.
__host__ __device__ constexpr int threads_for(int L) {
  return L / 2 > kMaxThreads ? kMaxThreads : (L / 2 < 32 ? 32 : L / 2);
}

// Dynamic shared memory: the keys and values of the line; the row pass
// adds each entry's rank and a staging tile a warp.
__host__ __device__ constexpr size_t smem_bytes(int L, bool rows) {
  return (size_t)L * (sizeof(unsigned long long) + sizeof(float)) +
         (rows ? (size_t)L * sizeof(int) +
                     (size_t)(threads_for(L) / 32) * kStageFloats * sizeof(float)
               : 0);
}

__device__ __forceinline__ uint32_t order_key(float x) {
  if (x != x) return 0xFFFFFFFFu;  // NaN last, all NaNs equal
  const uint32_t u = x == 0.0f ? 0u : __float_as_uint(x);  // -0.0 as +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAllLanes, v, o);
  return v;
}

// Sums of N values over the block, the same in every thread: each warp by
// a butterfly, then every warp adds the warps' partials in the same order.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = warp_sum(v[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < N; ++c) red[c][warp] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = warp_sum(lane < warps ? red[c][lane] : 0.0f);
  __syncthreads();  // red is free again
}

// Ascending bitonic sort of L (a power of two) keys in shared memory.  A
// stage with stride j <= 32 pairs keys inside one 64-key segment, and a
// warp owns the same segments in every such stage, so two such stages in a
// row need only __syncwarp.
__device__ void bitonic_sort(unsigned long long* keys, int L) {
  const int half = L >> 1;
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));
        const unsigned long long a = keys[i], c = keys[i + j];
        if ((a > c) == ((i & k) == 0)) {
          keys[i] = c;
          keys[i + j] = a;
        }
      }
      const int next = j > 1 ? j >> 1 : k;  // the next stage's stride
      if (j <= 32 && next <= 32) {
        __syncwarp();
      } else {
        __syncthreads();
      }
    }
  }
}

// The k-th smallest (0-indexed) of the merge of A(t) = med - s[p-1-t],
// t < p, and B(t) = s[p+t] - med, t < q (p = len / 2, q = len - p), both
// ascending, s the sorted line: ops/features.py:_kth_of_merged step for
// step, so that a line holding a NaN selects as the plain version does too.
// Ap(i) = A(i-1) and Bp(i) = B(i-1), -inf below and +inf above; its fixed
// number of bisection steps over how many come from A; its NaN-propagating
// maximum at the end.
__device__ float kth_of_merged(const unsigned long long* keys, const float* vals, int len,
                               float med, int k) {
  const int p = len >> 1, q = len - p;
  auto Ap = [&](int i) {
    return i <= 0 ? -INFINITY : i > p ? INFINITY : med - vals[(uint32_t)keys[p - i]];
  };
  auto Bp = [&](int i) {
    return i <= 0 ? -INFINITY : i > q ? INFINITY : vals[(uint32_t)keys[p + i - 1]] - med;
  };
  int lo = k + 1 - q > 0 ? k + 1 - q : 0;
  int hi = k + 1 < p ? k + 1 : p;
  const int span = hi - lo + 1 > 2 ? hi - lo + 1 : 2;
  const int steps = (32 - __clz(span - 1)) + 1;  // ceil(log2(span)) + 1
  for (int s = 0; s < steps; ++s) {
    const int i = (lo + hi) >> 1;  // floor, as torch.div(..., "floor")
    const int j = k + 1 - i;
    if (Ap(i) > Bp(j + 1)) {
      hi = i - 1;
    } else if (Bp(j) > Ap(i + 1)) {
      lo = i + 1;
    } else {
      lo = hi = i;
    }
  }
  const float a = Ap(lo), b = Bp(k + 1 - lo);
  return (a != a || b != b) ? NAN : (a > b ? a : b);  // torch.maximum
}

// One block a line: blockIdx.x the row (kRows) or the column, blockIdx.y
// the instance.  C is (B, n, m) float32, contiguous.  At least three blocks
// of 512 an SM: that caps the registers at 40 (the row pass asks for 48
// unbounded, and two blocks an SM run it about 5% slower at (1, 2048)); the
// row pass's 52 KB of shared memory at L = 2048 fits three.
template <bool kRows>
__global__ void __launch_bounds__(kMaxThreads, 3)
graph_line_kernel(const float* __restrict__ C, int n, int m, int L,
                  float* __restrict__ node, float* __restrict__ col_rank,
                  float4* __restrict__ col_aux, float* __restrict__ edge) {
  extern __shared__ unsigned long long smem[];
  __shared__ float red[3][32];
  __shared__ float mad_half[2];

  const int T = blockDim.x, tid = threadIdx.x;
  const int line = blockIdx.x, b = blockIdx.y;
  const int len = kRows ? m : n;      // entries on the line
  const int nodes = kRows ? n : m;    // lines of this kind
  const size_t plane = (size_t)n * m;
  const float* Cb = C + (size_t)b * plane;

  unsigned long long* keys = smem;
  float* vals = reinterpret_cast<float*>(keys + L);

  // 1. the line into shared memory: values by index, keys padded to L
  for (int l = tid; l < L; l += T) {
    unsigned long long key = kPad;
    if (l < len) {
      const float x = kRows ? Cb[(size_t)line * m + l] : Cb[(size_t)l * m + line];
      vals[l] = x;
      key = ((unsigned long long)order_key(x) << 32) | (uint32_t)l;
    }
    keys[l] = key;
  }
  __syncthreads();
  bitonic_sort(keys, L);

  // 2. order statistics from the sorted line
  auto sorted = [&](int k) { return vals[(uint32_t)keys[k]]; };
  const int mid = len >> 1;
  const float mx = sorted(len - 1);
  const float mn = mx != mx ? mx : sorted(0);  // a NaN sorts last; amin gives it
  const float med = (len & 1) ? sorted(mid) : 0.5f * (sorted(mid - 1) + sorted(mid));
  // the MAD's one or two selections, in the first and the last thread
  if (tid == 0) mad_half[0] = kth_of_merged(keys, vals, len, med, (len & 1) ? mid : mid - 1);
  if (tid == T - 1 && !(len & 1)) mad_half[1] = kth_of_merged(keys, vals, len, med, mid);

  // 3. moments, entropy and ties in two passes over the values
  float s1[3] = {0.0f, 0.0f, 0.0f};  // sum of x - med, sum of exp(-(x - min)), ties
  for (int l = tid; l < len; l += T) {
    const float x = vals[l];
    s1[0] += x - med;
    s1[1] += expf(-(x - mn));
    s1[2] += (x - mn) <= kTau ? 1.0f : 0.0f;
  }
  block_sum(s1, red);
  const float dm = s1[0] / (float)len;
  const float denom = s1[1] + kEps;
  float s2[2] = {0.0f, 0.0f};  // sum of (x - mean)^2, sum of p * log(p + EPS)
  for (int l = tid; l < len; l += T) {
    const float x = vals[l];
    const float d = (x - med) - dm;
    s2[0] += d * d;
    const float p = expf(-(x - mn)) / denom;
    s2[1] += p * logf(p + kEps);
  }
  block_sum(s2, red);
  float mad = (len & 1) ? mad_half[0] : 0.5f * (mad_half[0] + mad_half[1]);
  mad = mad < kEps ? kEps : mad;  // NaN stays, as torch.clamp_min keeps it
  const float ent = -s2[1];
  const float tie = s1[2] / (float)len;

  // 4. the node's 14 features
  float* out = node + ((size_t)b * nodes + line) * kNodeDim;
  if (tid < 6) {
    out[tid] = tid == 0 ? mn
             : tid == 1 ? mx
             : tid == 2 ? med + dm
             : tid == 3 ? sqrtf(s2[0] / (float)len)
             : tid == 4 ? mad
                        : ent;
  } else if (tid < kNodeDim) {
    const int c = tid - 6;
    const float inv = 1.0f / (float)(nodes > 1 ? nodes - 1 : 1);
    const float angle = ((kTwoPi * (float)line) * (float)(1 << (c >> 1))) * inv;
    out[tid] = (c & 1) ? cosf(angle) : sinf(angle);
  }

  if (!kRows) {
    // 5c. each entry's column rank, and what the row pass needs of the column
    float* ranks = col_rank + (size_t)b * plane + line;
    for (int k = tid; k < len; k += T)
      ranks[(size_t)(uint32_t)keys[k] * m] = len > 1 ? (float)k / (float)(len - 1) : 0.0f;
    if (tid == 0) col_aux[(size_t)b * m + line] = make_float4(mn, tie, ent, 0.0f);
    return;
  }

  // 5r. the row's edge channels, staged a warp's 32 edges at a time
  int* rank = reinterpret_cast<int*>(vals + L);
  const int lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  float* stage = reinterpret_cast<float*>(rank + L) + warp * kStageFloats;
  for (int k = tid; k < len; k += T) rank[(uint32_t)keys[k]] = k;
  __syncthreads();
  const float* crank = col_rank + (size_t)b * plane + (size_t)line * m;
  const float4* aux = col_aux + (size_t)b * m;
  float* erow = edge + ((size_t)b * plane + (size_t)line * m) * kEdgeDim;
  for (int j0 = warp * 32; j0 < len; j0 += warps * 32) {
    const int j = j0 + lane;
    if (j < len) {
      const float x = vals[j];
      const float4 a = aux[j];
      float* s = stage + lane * kEdgeDim;
      s[0] = (x - med) / mad;
      s[1] = len > 1 ? (float)rank[j] / (float)(len - 1) : 0.0f;
      s[2] = crank[j];
      s[3] = x - mn;
      s[4] = x - a.x;
      s[5] = tie;
      s[6] = a.y;
      s[7] = ent;
      s[8] = a.z;
      s[9] = 0.0f;
    }
    __syncwarp();
    const int count = (len - j0 < 32 ? len - j0 : 32) * kEdgeDim;
    float* dst = erow + (size_t)j0 * kEdgeDim;
    for (int t = lane; t < count; t += 32) dst[t] = stage[t];
    __syncwarp();
  }
}

template <bool kRows>
cudaError_t launch(const float* C, int B, int n, int m, float* node, float* col_rank,
                   float4* col_aux, float* edge, cudaStream_t s) {
  const int L = next_pow2(kRows ? m : n);
  const size_t smem = smem_bytes(L, kRows);
  cudaError_t err = cudaFuncSetAttribute(graph_line_kernel<kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(kRows ? n : m), (unsigned)B);
  graph_line_kernel<kRows><<<grid, threads_for(L), smem, s>>>(C, n, m, L, node, col_rank,
                                                              col_aux, edge);
  return cudaGetLastError();
}

bool valid(int B, int n, int m) {
  return B >= 1 && B <= 65535 && n >= 1 && m >= 1 && n <= (1 << 24) && m <= (1 << 24);
}

}  // namespace

extern "C" {

// The column pass: C (B, n, m) float32 contiguous; writes col_feat
// (B, m, 14), col_rank (B, n, m) (each entry's rank in its column over
// n - 1) and col_aux (B, m, 4) (the column's min, tie fraction, entropy,
// 0).  Returns a cudaError_t.
int lapgnn_graph_features_cols(const float* C, float* col_feat, float* col_rank,
                               float* col_aux, int B, int n, int m, void* stream) {
  if (!valid(B, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false>(C, B, n, m, col_feat, col_rank,
                                        reinterpret_cast<float4*>(col_aux), nullptr,
                                        static_cast<cudaStream_t>(stream)));
}

// The row pass, after the column pass on the same stream: writes row_feat
// (B, n, 14) and edge (B, n, m, 10) from C, col_rank and col_aux.
int lapgnn_graph_features_rows(const float* C, float* row_feat, const float* col_rank,
                               const float* col_aux, float* edge, int B, int n, int m,
                               void* stream) {
  if (!valid(B, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<true>(
      C, B, n, m, row_feat, const_cast<float*>(col_rank),
      reinterpret_cast<float4*>(const_cast<float*>(col_aux)), edge,
      static_cast<cudaStream_t>(stream)));
}

// The longest line (n or m) both passes take on this device: the largest
// power of two whose row pass fits the opt-in shared memory a block, after
// the kernel's static shared memory.  Negative: a CUDA error code.
int lapgnn_graph_features_max_len(int device) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, graph_line_kernel<true>);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int best = 0;
  for (int L = 1; L <= (1 << 24); L <<= 1) {
    if (attr.sharedSizeBytes + smem_bytes(L, true) > (size_t)optin) break;
    best = L;
  }
  return best;
}

}  // extern "C"
