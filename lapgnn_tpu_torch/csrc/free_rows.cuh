// The round structure that the device solver's auction kernels share: the
// Jacobi-ARR rounds (S2, csrc/arr.cu) and the greedy proposal rounds (S3,
// csrc/greedy_match.cu).
//
// Every block keeps its own copy of which rows are free, as a bit a row, and
// updates it from each round's winners after the round's grid barrier, so
// that no second barrier is needed to publish the round's result.  At the
// start of a round each block ranks the free rows in row order (the copies
// are alike, so every block ranks alike) and takes the k-th free row where
// k mod G is its block index: the round's rows spread over the whole grid.
// A block scans its rows with a group of warps each, as many warps a row as
// there are rows to spare (warps_a_row).
//
// A round's bids meet in one of kRoundBuffers sets of per-column slots,
// where a fire-and-forget atomic keeps the winner, and of per-rank entries,
// where the row of rank k writes its bid (or none) with a plain store, so
// that no bidder waits for an atomic's answer.  Every block reads round r's
// entries and their columns' slots after round r's barrier and applies the
// entries that won; round r's slots are cleared during round r + 2 (after
// barrier r + 1, when every block has applied round r) and bid into again
// in round r + 3, so the clearing needs no barrier of its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lapgnn {

constexpr int kRoundBuffers = 3;

// Warps of a group that scans one row, for a block of kWarps warps with
// `rows` rows this round: one warp a row once there is a row for each warp,
// else the block's warps shared out (a power of two).
template <int kWarps>
__device__ __forceinline__ int warps_a_row(int rows) {
  int gw = kWarps;
  while (gw > 1 && rows * gw > kWarps) gw >>= 1;
  return gw;
}

// This block's free rows of the round: the set bits of `bits` (`words`
// words, a bit a row, bit k of word q for row 32 q + k) ranked in row order,
// rank k to block k mod `blocks`, written in rank order into `mine` (at most
// ceil(rows / blocks) of them).  One warp ranks (a lane a run of words, a
// prefix sum over the lanes, each lane's own ranks found by skipping words
// and clearing bits); `total_s`: an int of shared memory.  Every thread of
// the block calls it and gets the block's count back, and in `total` the
// round's free rows.
__device__ __forceinline__ int own_free_rows(const unsigned* bits, int words, int* mine,
                                             int* total_s, int block, int blocks, int& total) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (words + 31) / 32;
    const int lo = min(words, lane * per), hi = min(words, lo + per);
    int count = 0;
    for (int q = lo; q < hi; ++q) count += __popc(bits[q]);
    int incl = count;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      incl += lane >= off ? o : 0;
    }
    const int first = incl - count;  // the rank of the lane's first free row
    int k = first + (block - first % blocks + blocks) % blocks;
    int q = lo, base = first, pc = 0;
    unsigned w = 0;
    if (k < incl) {
      w = bits[q];
      pc = __popc(w);
    }
    for (; k < incl; k += blocks) {
      while (k >= base + pc) {
        base += pc;
        w = bits[++q];
        pc = __popc(w);
      }
      unsigned m = w;
      for (int s = k - base; s > 0; --s) m &= m - 1;
      mine[k / blocks] = 32 * q + __ffs(m) - 1;
    }
    if (lane == 31) *total_s = incl;
  }
  __syncthreads();
  total = *total_s;
  return total > block ? (total - block + blocks - 1) / blocks : 0;
}

}  // namespace lapgnn
