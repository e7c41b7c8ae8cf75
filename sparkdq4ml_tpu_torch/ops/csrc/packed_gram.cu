// Gramian A = Z^T Z of the pre-masked packed design Z = [X, y, 1] * mask,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_packed_gram_kernel`
// (sparkdq4ml_tpu/ops/pallas_kernels.py, called through `_packed_gram_call`
// and `packed_gram_pallas`), the only pass over the data of a linear fit.
//
// Z is (n, D) row-major with D = d + 2; A is (D, D). The plan (upper-
// triangle tiles over row chunks, a fixed-order chunk reduce, no atomics,
// one launch when there is one chunk; A symmetric bit for bit) lives in
// gram_common.cuh and is shared with masked_gram.cu; this file only says
// how a row of Z is read. The tiled form copies Z's rows as they are, 16
// bytes at a time when D is a multiple of 4 (8 or 4 bytes otherwise).
//
// Bound: A is symmetric, so the function needs n * D * (D + 1) flops (one
// triangle) on 4 * n * D bytes in float32. At the main path's D = 3 memory
// is the limit, at D = 514 the float32 (non-tensor) rate. On an H100 80GB
// HBM3 at 700 W (chip_smoke.py): about 45% of the bytes' bound at
// (10^7, 3) and 36% of the float32 rate's bound at (10^6, 514), where the
// 64-wide tiles of the triangle do 1.39 times the flops it needs.

#include "gram_common.cuh"

namespace {

template <typename T>
struct PackedDesign {
  static constexpr bool kScaled = false;   // rows are read as they are
  const T* __restrict__ Z;
  int D;

  // The tiled stage 1 copies Z's rows (stride D, D columns) as they are.
  __host__ __device__ const T* src() const { return Z; }
  __host__ __device__ int ld() const { return D; }

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
