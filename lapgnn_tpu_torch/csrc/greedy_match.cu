// Greedy maximal matching on the tight edges (S3) for Hopper: every proposal
// round of greedy_tight_matching in one cooperative launch.
//
// Replaces lapgnn_tpu/solver/seeded.py:greedy_tight_matching (:99), a
// lax.while_loop with no Pallas kernel behind it.  Each round, in the JAX
// order: every free row proposes one available tight column (one whose
// column is free): in round 0 the lowest, in later rounds the one of the
// lowest hash score (_hash_scores, :71: wrapping uint32 arithmetic), the
// lowest column on a tie; each proposed-to column takes its lowest
// proposing row; until a round matches nothing.
//
// Design.  A warp per free row scans its row of the bool matrix against a
// per-block copy of the free columns in shared memory and keeps the least
// (score, column) as one 64-bit word; lane 0 proposes by an atomicMin of
// the row on the column; then a thread per column applies the winner and
// clears the slot.  Two grid syncs a round.  x and y change during the
// launch and are read from L2 (__ldcg).
//
// Bound: each round reads the free rows of the n^2-byte tight matrix (at
// most rounds x n^2 B); at the solver's size a round is two grid syncs and
// the free rows' scans.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;
constexpr unsigned long long kNone = ~0ull;

template <typename U>
__device__ __forceinline__ U ld(const U* p) {
  return __ldcg(p);
}

// _hash_scores (seeded.py:71) of row i, column j in round r, in
// [0, 2^31 - 2].
__device__ __forceinline__ uint32_t hash_score(uint32_t i, uint32_t j, uint32_t r) {
  uint32_t h = i * 0x9E3779B1u + j * 0x85EBCA77u + r * 0xC2B2AE3Du;
  h ^= h >> 15;
  h *= 0x27D4EB2Fu;
  h ^= h >> 13;
  return min(h & 0x7FFFFFFFu, 0x7FFFFFFEu);
}

struct Greedy {
  const unsigned char* tight;  // (n, n) bool, row-major
  long long* x;                // (n,) -1 in, the matching out
  long long* y;                // (n,) -1 in, the matching out
  int* win;                    // (n,) a column's lowest proposing row, n for none
  int* won;                    // (n + 2,) a column was matched in that round
  long long* counts;           // += rounds
  int n;
};

__global__ void __launch_bounds__(kThreads) greedy_match_kernel(Greedy a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char col_free[];  // (n,) the round's free columns
  const int n = a.n;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gthread = blockIdx.x * kThreads + tid, nthreads = gridDim.x * kThreads;
  const int gwarp = gthread >> 5, nwarps = nthreads >> 5;

  for (int j = gthread; j < n; j += nthreads) a.win[j] = n;
  for (int r = gthread; r < n + 2; r += nthreads) a.won[r] = 0;
  grid.sync();

  int rnd = 0;
  bool progressed;
  do {
    for (int j = tid; j < n; j += kThreads) col_free[j] = ld(a.y + j) < 0;
    __syncthreads();
    // the proposals, a warp a free row
    for (int i = gwarp; i < n; i += nwarps) {
      if (ld(a.x + i) >= 0) continue;
      const unsigned char* row = a.tight + (long long)i * n;
      unsigned long long best = kNone;
      for (int j = lane; j < n; j += 32) {
        if (row[j] && col_free[j]) {
          const uint32_t score = rnd == 0 ? (uint32_t)j : hash_score(i, j, rnd);
          const unsigned long long key = ((unsigned long long)score << 32) | (uint32_t)j;
          best = key < best ? key : best;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kAllLanes, best, off);
        best = o < best ? o : best;
      }
      if (lane == 0 && best != kNone) atomicMin(a.win + (int)(uint32_t)best, i);
    }
    grid.sync();
    // each proposed-to column takes its lowest proposing row
    for (int j = gthread; j < n; j += nthreads) {
      const int w = ld(a.win + j);
      if (w < n) {
        a.x[w] = j;
        a.y[j] = w;
        a.won[rnd] = 1;
        a.win[j] = n;
      }
    }
    grid.sync();
    progressed = ld(a.won + rnd) != 0;
    ++rnd;
  } while (progressed);
  if (blockIdx.x == 0 && tid == 0) a.counts[0] += rnd;
}

}  // namespace

extern "C" {

// Blocks of the kernel one SM holds at once for rows of n columns, or minus a
// cudaError_t.
int lapgnn_greedy_match_occupancy(int n) {
  cudaError_t err = cudaFuncSetAttribute(greedy_match_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, n);
  if (err != cudaSuccess) return -(int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, greedy_match_kernel, kThreads, n);
  return err == cudaSuccess ? occ : -(int)err;
}

long long lapgnn_greedy_match_work_bytes(int n) { return 4 * (long long)n + 4 * ((long long)n + 2); }

// tight: (n, n) bool contiguous; x, y: (n,) int64 holding -1, the matching
// written in place; work: lapgnn_greedy_match_work_bytes bytes; counts: 1
// int64 that the launch adds its rounds to.  One cooperative launch of
// `blocks` blocks.  Returns a cudaError_t.
int lapgnn_greedy_match(const unsigned char* tight, long long* x, long long* y, void* work,
                        long long* counts, int n, int blocks, void* stream) {
  Greedy a;
  a.tight = tight;
  a.x = x;
  a.y = y;
  a.win = static_cast<int*>(work);
  a.won = a.win + n;
  a.counts = counts;
  a.n = n;
  cudaError_t err = cudaFuncSetAttribute(greedy_match_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, n);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)greedy_match_kernel, dim3(blocks), dim3(kThreads),
                                    args, (size_t)n, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
