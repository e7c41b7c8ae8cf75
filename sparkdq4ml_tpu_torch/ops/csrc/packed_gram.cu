// Gramian A = Z^T Z of the pre-masked packed design Z = [X, y, 1] * mask,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_packed_gram_kernel`
// (sparkdq4ml_tpu/ops/pallas_kernels.py, called through `_packed_gram_call`
// and `packed_gram_pallas`), the only pass over the data of a linear fit.
//
// Z is (n, D) row-major with D = d + 2; A is (D, D). The two-stage plan
// (per-chunk partials, then a fixed-order chunk reduce; no atomics, so the
// result is bit-stable) lives in gram_common.cuh and is shared with
// masked_gram.cu; this file only says how a row of Z is read.
//
// Bound: A is symmetric, so the function needs n * D * (D + 1) flops (one
// triangle) on 4 * n * D bytes in float32. At the main path's D = 3 memory
// is the limit; at D = 514 the float32 (non-tensor) rate is. Stage 1
// computes both triangles, twice the flops the function needs.

#include "gram_common.cuh"

namespace {

template <typename T>
struct PackedDesign {
  const T* __restrict__ Z;
  int D;

  __device__ __forceinline__ T at(int64_t r, int c) const {
    return Z[r * D + c];
  }

  // One row is D consecutive values, so a warp reads consecutive bytes.
  template <int MAXD>
  __device__ __forceinline__ void row(int64_t r, T (&z)[MAXD]) const {
    const T* p = Z + r * D;
#pragma unroll
    for (int a = 0; a < MAXD; ++a) z[a] = a < D ? p[a] : T(0);
  }
};

template <typename T>
int run(const T* Z, T* part, T* out, long long n, int D, int chunks,
        long long rows_per_chunk, void* stream) {
  return gram::launch<T>(PackedDesign<T>{Z, D}, part, out, n, D, chunks,
                         rows_per_chunk, stream);
}

}  // namespace

extern "C" int packed_gram_f32(const float* Z, float* part, float* out,
                               long long n, int D, int chunks,
                               long long rows_per_chunk, void* stream) {
  return run<float>(Z, part, out, n, D, chunks, rows_per_chunk, stream);
}

extern "C" int packed_gram_f64(const double* Z, double* part, double* out,
                               long long n, int D, int chunks,
                               long long rows_per_chunk, void* stream) {
  return run<double>(Z, part, out, n, D, chunks, rows_per_chunk, stream);
}
