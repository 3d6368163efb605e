// Greedy maximal matching on the tight edges (S3) for Hopper: every proposal
// round of greedy_tight_matching in one cooperative launch, one grid barrier
// a round.
//
// Replaces lapgnn_tpu/solver/seeded.py:greedy_tight_matching (:99), a
// lax.while_loop with no Pallas kernel behind it.  Each round, in the JAX
// order: every free row proposes one available tight column (one whose
// column is free): in round 0 the lowest, in later rounds the one of the
// lowest hash score (_hash_scores, :71: wrapping uint32 arithmetic), the
// lowest column on a tie; each proposed-to column takes its lowest
// proposing row; until a round matches nothing.
//
// Design (the round structure is csrc/free_rows.cuh's).  Every block keeps
// a bit a free row and a bit a free column in its shared memory (n / 4
// bytes, so every n the card can hold the bool matrix for).  A round:
//  - one warp of the block ranks the free rows from its bits, the block
//    takes every G-th and scans each with a group of its warps: the row's
//    bytes 16 a load (a uint4 folded into 16 bits, a bit a column), kUnroll
//    loads a thread in flight, against the free columns' bits at that
//    offset; each thread keeps the least (score, column) as one 64-bit
//    word, the group the least of those;
//  - the proposal is an atomicMax of the inverted row on the column's slot
//    (the lowest row), which no proposer waits on: the free row of rank k
//    stores its proposal (column and row, or none) in entry k and adds one
//    to the round's count;
//  - one grid barrier (csrc/grid_barrier.cuh) whose payload is the count;
//    0 (no proposal, so no match) stops;
//  - every block reads the round's entries and their columns' slots and
//    applies the proposals that won to its bits, and the block that rank k
//    falls to writes x and y in device memory.
//
// Bound: each round reads the free rows of the n^2-byte tight matrix (at
// most rounds x n^2 B); at the solver's size a round is one grid barrier and
// the free rows' scans.

#include <cuda_runtime.h>
#include <stdint.h>

#include "free_rows.cuh"
#include "grid_barrier.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // 16-byte loads a thread has in flight
constexpr int kApply = 8;   // proposals a thread reads at once in the apply
constexpr int kBuffers = lapgnn::kRoundBuffers;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;
constexpr unsigned long long kNone = ~0ull;  // no available column; no proposal

// _hash_scores (seeded.py:71) of row i, column j in round r, in
// [0, 2^31 - 2].
__device__ __forceinline__ uint32_t hash_score(uint32_t i, uint32_t j, uint32_t r) {
  uint32_t h = i * 0x9E3779B1u + j * 0x85EBCA77u + r * 0xC2B2AE3Du;
  h ^= h >> 15;
  h *= 0x27D4EB2Fu;
  h ^= h >> 13;
  return min(h & 0x7FFFFFFFu, 0x7FFFFFFEu);
}

// Four bytes as four bits, bit k set where byte k is not 0.
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

// Bits c .. c + 15 of a bit array (bit k of word q for column 32 q + k)
// that has a zero word past its end.
__device__ __forceinline__ unsigned bits16(const unsigned* bits, int c) {
  const unsigned long long pair =
      (unsigned long long)bits[c >> 5] | ((unsigned long long)bits[(c >> 5) + 1] << 32);
  return (unsigned)(pair >> (c & 31)) & 0xFFFFu;
}

__device__ __forceinline__ bool bit(const unsigned* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

__host__ __device__ constexpr int align4(int words) { return (words + 3) & ~3; }

// A block's dynamic shared memory: the free rows' and columns' bits (the
// columns' with a zero word past the end) and its rows of the round.
__host__ __device__ constexpr size_t smem_bytes(int n, int own_cap) {
  return 4 * ((size_t)align4((n + 31) / 32) + align4((n + 31) / 32 + 1) + align4(own_cap));
}

struct Greedy {
  const unsigned char* tight;  // (n, n) bool, row-major
  long long* x;                // (n,) the matching out
  long long* y;
  unsigned* slot;              // (kBuffers, n) a column's lowest proposer, inverted (0: none)
  unsigned long long* props;   // (kBuffers, n) the proposal of the free row of each rank
  unsigned* count;             // (kBuffers,) the rounds' numbers of proposals
  unsigned* bar;               // the grid barrier's words
  long long* counts;           // += rounds
  int n, own_cap;
};

// The least (score, column) word of row i over its available columns in
// round `rnd`: this thread's share, columns gl, gl + g, ... of the group's
// 16-byte words (the unaligned head and the tail a byte at a time).
__device__ __forceinline__ unsigned long long propose(const unsigned char* row, int i, int n,
                                                      const unsigned* free_cols, int rnd,
                                                      int gl, int g) {
  unsigned long long best = kNone;
  auto take = [&](int j) {
    const uint32_t score = rnd == 0 ? (uint32_t)j : hash_score(i, j, rnd);
    const unsigned long long key = ((unsigned long long)score << 32) | (uint32_t)j;
    best = key < best ? key : best;
  };
  const int head = min(n, (int)((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15));
  const int body = (n - head) >> 4, tail = head + 16 * body;
  for (int j = gl; j < head; j += g)
    if (row[j] && bit(free_cols, j)) take(j);
  for (int j = tail + gl; j < n; j += g)
    if (row[j] && bit(free_cols, j)) take(j);
  const uint4* r4 = reinterpret_cast<const uint4*>(row + head);
  for (int q0 = gl; q0 < body; q0 += g * kUnroll) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q0 + g * u < body) w[u] = __ldg(r4 + q0 + g * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + g * u;
      if (q >= body) continue;
      const int c0 = head + 16 * q;
      unsigned avail = (nonzero4(w[u].x) | nonzero4(w[u].y) << 4 | nonzero4(w[u].z) << 8 |
                        nonzero4(w[u].w) << 12) & bits16(free_cols, c0);
      if (rnd == 0) {
        if (avail) take(c0 + __ffs(avail) - 1);
      } else {
        while (avail) {
          take(c0 + __ffs(avail) - 1);
          avail &= avail - 1;
        }
      }
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads, 1) greedy_match_kernel(Greedy a) {
  extern __shared__ __align__(16) unsigned smem_words[];
  __shared__ unsigned long long part[2][kWarps];
  __shared__ int total_s;
  __shared__ unsigned count_s;

  const int n = a.n, words = (n + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, blocks = gridDim.x;
  const int gthread = b * kThreads + tid, nthreads = blocks * kThreads;
  unsigned* free_rows = smem_words;
  unsigned* free_cols = free_rows + align4(words);
  int* own = reinterpret_cast<int*>(free_cols + align4(words + 1));
  lapgnn::GridBarrier bar(a.bar, (unsigned)blocks);

  for (int q = tid; q <= words; q += kThreads) {
    const unsigned all = q < words - 1 || n % 32 == 0 ? ~0u : (1u << (n % 32)) - 1u;
    if (q < words) free_rows[q] = all;
    free_cols[q] = q < words ? all : 0u;
  }
  for (int i = gthread; i < n; i += nthreads) {
    a.x[i] = -1;
    a.y[i] = -1;
  }
  __syncthreads();

  int rnd = 0, par = 0;
  int free1 = 0, free2 = 0;  // the free rows of the last round and the one before
  unsigned count;
  do {
    const int buf = rnd % kBuffers, old = (rnd + 1) % kBuffers;
    unsigned* slot = a.slot + (size_t)buf * n;
    unsigned long long* props = a.props + (size_t)buf * n;

    // round rnd - 2's slots: every block applied that round before barrier rnd - 1
    for (int k = gthread; k < free2; k += nthreads) {
      const unsigned long long e = __ldcg(a.props + (size_t)old * n + k);
      if (e != kNone) __stcg(a.slot + (size_t)old * n + (int)(e >> 32), 0u);
    }

    // the proposals: this block's free rows, a group of warps a row
    int total;
    const int rows = lapgnn::own_free_rows(free_rows, words, own, &total_s, b, blocks, total);
    const int gw = lapgnn::warps_a_row<kWarps>(rows);
    const int groups = kWarps / gw, grp = warp / gw, gl = tid - grp * gw * 32;
    for (int t0 = 0; t0 < rows; t0 += groups) {
      const int t = t0 + grp;
      const int i = t < rows ? own[t] : 0;
      unsigned long long best = kNone;
      if (t < rows)
        best = propose(a.tight + (size_t)i * n, i, n, free_cols, rnd, gl, gw * 32);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kAllLanes, best, off);
        best = o < best ? o : best;
      }
      if (lane == 0) part[par][warp] = best;
      __syncthreads();
      if (gl == 0 && t < rows) {
        for (int w = warp + 1; w < warp + gw; ++w) best = part[par][w] < best ? part[par][w] : best;
        const int j = (int)(uint32_t)best;
        if (best != kNone) {
          atomicMax(slot + j, ~(unsigned)i);
          atomicAdd(a.count + buf, 1u);
        }
        __stcg(props + b + (size_t)t * blocks,
               best != kNone ? ((unsigned long long)j << 32) | (uint32_t)i : kNone);
      }
      par ^= 1;
    }
    bar.sync([&] { lapgnn::st_relaxed_gpu(a.count + old, 0u); },
             [&] { count_s = lapgnn::ld_acquire_gpu(a.count + buf); });
    count = count_s;

    // the proposals that won, applied to the block's bits; rank k's block
    // writes x and y
    for (int k0 = tid; count != 0 && k0 < total; k0 += kThreads * kApply) {
      unsigned long long e[kApply];
      unsigned w[kApply];
#pragma unroll
      for (int u = 0; u < kApply; ++u)
        e[u] = k0 + u * kThreads < total ? __ldcg(props + k0 + u * kThreads) : kNone;
#pragma unroll
      for (int u = 0; u < kApply; ++u)
        if (e[u] != kNone) w[u] = __ldcg(slot + (int)(e[u] >> 32));
#pragma unroll
      for (int u = 0; u < kApply; ++u) {
        if (e[u] == kNone) continue;
        const int j = (int)(e[u] >> 32), i = (int)(uint32_t)e[u];
        if ((int)~w[u] != i) continue;
        atomicAnd(free_rows + (i >> 5), ~(1u << (i & 31)));
        atomicAnd(free_cols + (j >> 5), ~(1u << (j & 31)));
        if ((k0 + u * kThreads) % blocks == b) {
          a.x[i] = j;
          a.y[j] = i;
        }
      }
    }
    __syncthreads();
    free2 = free1;
    free1 = total;
    ++rnd;
  } while (count != 0);
  if (b == 0 && tid == 0) a.counts[0] += rnd;
}

}  // namespace

extern "C" {

// Blocks of the kernel one SM holds at once with `smem` bytes of dynamic
// shared memory, or minus a cudaError_t.
int lapgnn_greedy_match_occupancy(int smem) {
  cudaError_t err = cudaFuncSetAttribute(greedy_match_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, greedy_match_kernel, kThreads, smem);
  return err == cudaSuccess ? occ : -(int)err;
}

// The kernel's static shared memory a block, or minus a cudaError_t.
int lapgnn_greedy_match_static_smem(void) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, greedy_match_kernel);
  return err == cudaSuccess ? (int)attr.sharedSizeBytes : -(int)err;
}

// Bytes of zeroed device memory a launch takes (the barrier's words, the
// rounds' counts of proposals, the slots and the proposals).
long long lapgnn_greedy_match_work_bytes(int n) {
  return (long long)(lapgnn::kBarrierBytes + 128 + kBuffers * 12 * (size_t)n);
}

// tight: (n, n) bool contiguous; x, y: (n,) int64, the matching written
// there; work: lapgnn_greedy_match_work_bytes zeroed bytes; counts: 1 int64
// that the launch adds its rounds to; `own_cap` >= ceil(n / blocks).  One
// cooperative launch of `blocks` blocks.  Returns a cudaError_t.
int lapgnn_greedy_match(const unsigned char* tight, long long* x, long long* y, void* work,
                        long long* counts, int n, int blocks, int own_cap, void* stream) {
  Greedy a;
  unsigned char* w = static_cast<unsigned char*>(work);
  a.bar = reinterpret_cast<unsigned*>(w);
  w += lapgnn::kBarrierBytes;
  a.count = reinterpret_cast<unsigned*>(w);
  w += 128;
  a.props = reinterpret_cast<unsigned long long*>(w);
  a.slot = reinterpret_cast<unsigned*>(w + 8 * kBuffers * (size_t)n);
  a.tight = tight;
  a.x = x;
  a.y = y;
  a.counts = counts;
  a.n = n;
  a.own_cap = own_cap;
  const size_t smem = smem_bytes(n, own_cap);
  cudaError_t err = cudaFuncSetAttribute(greedy_match_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)greedy_match_kernel, dim3(blocks), dim3(kThreads),
                                    args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
