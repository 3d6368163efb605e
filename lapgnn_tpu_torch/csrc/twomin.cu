// Per-row two-minimum of C - v (K4) for Hopper.
//
// Replaces the Pallas kernel of lapgnn_tpu/ops/pallas/twomin.py
// (pallas_two_min / _twomin_kernel): for each row i of red = C - v[None, :],
//   argmin1_i = the first column attaining the row minimum,
//   min1_i    = red[i, argmin1_i],
//   min2_i    = the minimum of red[i, j] over j != argmin1_i,
// in one read of C.  Its device code is in twomin.cuh, which the device
// solver's Jacobi-ARR kernel (arr.cu) shares for its bid; this kernel is the
// bid of the eager ARR loop (solver/seeded.py:_jacobi_arr_eager).
//
// Bound: device-memory bytes (C and v read once, three (n,) vectors
// written).  In practice two things hold it above that bound.  At the
// solver's size (n = 2048, 16 MB, resident in L2 between ARR rounds) the
// whole read lasts a few microseconds, of which launch, ramp and tail are a
// good part: a row reduction of the same matrix by the framework takes as
// long.  And the compares are not free: about ten integer-pipe operations
// a column, on a pipe half as wide as the float pipe, which is as much time
// as the bytes take once the matrix streams from device memory at full
// rate.  Design:
//   * one warp per row striding along it, eight rows a block; C is
//     row-major, so every load is coalesced; 16-byte loads when m % 4 == 0
//     and both bases are 16-byte aligned, 4-byte loads otherwise; the loop
//     is unrolled so that four loads of C and four of v are requested before
//     the first compare;
//   * the compare state of a lane is branch-free (KeyState): the reduced
//     cost becomes an order key on which NaN is smallest and -0.0 equals
//     +0.0, and the two smallest (key, column) pairs are kept by integer
//     min / max / select.  Lanes merge through five butterfly shuffles of
//     the pairs as 64-bit words.  min1 and min2 are then the elements at the
//     two columns, read again, so their bits are the gather form's;
//   * for a matrix that does not fit in L2 the earlier state (FloatState:
//     float compares with a branch per column, fewer integer operations
//     on the common path) is faster and is kept; the caller chooses;
//   * NaN follows torch.argmin: a NaN counts as the smallest value and the
//     first NaN wins; min2 is NaN when any other column is NaN (amin
//     propagates NaN), and +-inf order as usual; equal values at two columns
//     give min2 == min1, as the masked form does;
//   * the argmin is written as int32 directly (no float round trip, so the
//     TPU kernel's n < 2^24 limit does not apply);
//   * float64 (lapgnn_two_min_f64, the float64 solves of the device solver)
//     takes the float compare state over doubles with 8-byte loads; the
//     Pallas kernel has no float64 form.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "twomin.cuh"

namespace {

using lapgnn::FloatState;
using lapgnn::KeyState;
using lapgnn::ReadOnlyV;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// One warp per row (lapgnn::scan_row); lane 0 writes the row's result.
template <typename T, typename State, bool kVec4, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    twomin_kernel(const T* __restrict__ C, const T* __restrict__ v,
                  T* __restrict__ min1, T* __restrict__ min2,
                  int32_t* __restrict__ argmin, int n, int m) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (row >= n) return;
  const T* crow = C + ((long long)b * n + row) * m;
  const T* vb = v + (long long)b * m;

  State s;
  s.init();
  lapgnn::scan_row<T, State, kVec4, kUnroll, ReadOnlyV>(s, crow, vb, m, lane);
  s.merge_lanes();
  if (lane == 0) {
    const long long o = (long long)b * n + row;
    int arg;
    s.template result<ReadOnlyV>(crow, vb, min1[o], min2[o], arg);
    argmin[o] = arg;
  }
}

template <typename State>
cudaError_t launch(const float* C, const float* v, float* min1, float* min2,
                   int32_t* argmin, int B, int n, int m, int vec, int unroll,
                   cudaStream_t s) {
  const dim3 grid((n + kWarps - 1) / kWarps, B);
  if (unroll == 4) {
    if (vec) {
      twomin_kernel<float, State, true, 4><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
    } else {
      twomin_kernel<float, State, false, 4><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
    }
  } else if (unroll == 1) {
    if (vec) {
      twomin_kernel<float, State, true, 1><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
    } else {
      twomin_kernel<float, State, false, 1><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_f64(const double* C, const double* v, double* min1,
                       double* min2, int32_t* argmin, int B, int n, int m,
                       int unroll, cudaStream_t s) {
  using State = FloatState<double>;
  const dim3 grid((n + kWarps - 1) / kWarps, B);
  if (unroll == 4) {
    twomin_kernel<double, State, false, 4><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
  } else if (unroll == 1) {
    twomin_kernel<double, State, false, 1><<<grid, kThreads, 0, s>>>(C, v, min1, min2, argmin, n, m);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// C: (B, n, m) f32 contiguous; v: (B, m) f32 contiguous; min1, min2: (B, n)
// f32; argmin: (B, n) int32.  The caller chooses the geometry: `vec` != 0
// for 16-byte loads (m % 4 == 0, C and v 16-byte aligned), `unroll` 1 or 4
// loads requested ahead, `float_state` != 0 for the float compare state instead
// of the integer keys.  Returns a cudaError_t.
int lapgnn_two_min(const float* C, const float* v, float* min1, float* min2,
                   int32_t* argmin, int B, int n, int m, int vec, int unroll,
                   int float_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec && (m % 4 != 0 || reinterpret_cast<uintptr_t>(C) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(v) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      float_state ? launch<FloatState<float>>(C, v, min1, min2, argmin, B, n, m, vec, unroll, s)
                  : launch<KeyState>(C, v, min1, min2, argmin, B, n, m, vec, unroll, s));
}

// The same for float64: C (B, n, m), v (B, m), min1 and min2 (B, n) f64,
// argmin (B, n) int32; the float compare state with 8-byte loads, `unroll`
// 1 or 4.  Returns a cudaError_t.
int lapgnn_two_min_f64(const double* C, const double* v, double* min1,
                       double* min2, int32_t* argmin, int B, int n, int m,
                       int unroll, void* stream) {
  return static_cast<int>(launch_f64(C, v, min1, min2, argmin, B, n, m, unroll,
                                     static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
