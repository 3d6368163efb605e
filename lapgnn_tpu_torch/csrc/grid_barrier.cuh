// A grid-wide barrier for a cooperative launch, written by hand so that a
// persistent kernel can carry a few words of payload through it: the
// device solver's sweep augmentation (csrc/augment.cu) folds its stop test
// into the words the barrier publishes.
//
// Centralised and sense-reversing.  Thread 0 of each block arrives with an
// acquire-release add on the count; the block that arrives last resets the
// count, runs the caller's `last` (nothing else runs in the grid then: every
// other block is waiting and none has left), and publishes the new sense
// with a release store; the others spin on the sense with acquire loads.
// The __syncthreads before the arrival orders the block's writes before
// thread 0's release, and the one after the spin hands what thread 0
// acquired to every thread of the block (as CUTLASS's GenericBarrier and
// cooperative_groups' grid sync do).  The count and the sense lie in
// separate 128-byte lines of device memory, zeroed before the first sync;
// every block starts at sense 0.

#pragma once

#include <cuda_runtime.h>

namespace lapgnn {

__device__ __forceinline__ unsigned atom_add_acq_rel_gpu(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed_gpu(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed_gpu(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A wait that has spun for kSpinLimit cycles (about half a minute) traps, so
// that a barrier that can never open fails the launch instead of hanging
// the card.
constexpr long long kSpinLimit = 1ll << 36;

__device__ __forceinline__ void check_spin(long long start) {
  if (clock64() - start > kSpinLimit) __trap();
}

// The barrier's words in device memory: the count and the sense, each in a
// 128-byte line of its own.
constexpr int kBarrierLine = 32;
constexpr size_t kBarrierBytes = 2 * kBarrierLine * sizeof(unsigned);

class GridBarrier {
 public:
  // `words`: kBarrierBytes of zeroed device memory; `blocks`: the grid.
  __device__ GridBarrier(unsigned* words, unsigned blocks)
      : count_(words), sense_(words + kBarrierLine), blocks_(blocks), gen_(0) {}

  // Every thread of every block calls it.  Thread 0 of the block that
  // arrives last runs `last()` before any block leaves; thread 0 of every
  // block runs `after()` once it has left, before the block's threads go on.
  template <typename Last, typename After>
  __device__ __forceinline__ void sync(Last last, After after) {
    __syncthreads();
    if (threadIdx.x == 0) {
      if (atom_add_acq_rel_gpu(count_, 1u) == blocks_ - 1) {
        st_relaxed_gpu(count_, 0u);  // no block touches the count until the sense turns
        last();
        st_release_gpu(sense_, gen_ ^ 1u);
      } else {
        const long long start = clock64();
        while (ld_acquire_gpu(sense_) == gen_) check_spin(start);
      }
      after();
    }
    gen_ ^= 1u;
    __syncthreads();
  }

  __device__ __forceinline__ void sync() {
    sync([] {}, [] {});
  }

 private:
  unsigned* count_;
  unsigned* sense_;
  unsigned blocks_;
  unsigned gen_;
};

}  // namespace lapgnn
