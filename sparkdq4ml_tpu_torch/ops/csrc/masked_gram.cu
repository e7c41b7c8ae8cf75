// Masked augmented Gramian A = sum_i w_i^2 z_i z_i^T with z_i = [x_i, y_i, 1],
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gram_kernel`
// (sparkdq4ml_tpu/ops/pallas_kernels.py, called through `_masked_gram_call`
// and `masked_gram_pallas`), the data pass behind
// `models/solvers.py:augmented_gram`: the Huber fit's warm start, the
// cross-validation fold Gramians and `compute_gram`.
//
// It computes the XLA contract of augmented_gram, Zw = [X, y, 1] * w and
// A = Zw^T Zw, shape (d + 2, d + 2). The Pallas kernel's own (Z w)^T Z
// agrees with that only for 0/1 weights; the Huber fit passes sqrt(weight),
// so this kernel follows XLA. Each element is formed as z * w in the input
// type and then multiplied, as the plain version does.
//
// What the TPU kernel exists for is kept: X (n, d), y (n) and w (n, bool or
// the input's float type) are read directly and the row z * w is formed in
// registers (or in the shared-memory slab of the tiled form); Z is never
// written to global memory. The two-stage, atomic-free sum of
// gram_common.cuh makes the result bit-stable from run to run, which the
// cross-validation's A_all - A_fold needs.
//
// Bound: n * (d + 2) * elem bytes in (plus one byte or elem a row for w),
// D^2 * elem out, and n * D * (D + 1) flops for one triangle of the
// symmetric A. At d = 1 memory is the limit; at d = 512 the float32
// (non-tensor) rate is.

#include "gram_common.cuh"

namespace {

template <typename T, typename W>
struct MaskedDesign {
  const T* __restrict__ X;
  const T* __restrict__ y;
  const W* __restrict__ w;
  int d;

  __device__ __forceinline__ T at(int64_t r, int c) const {
    const T v = c < d ? X[r * d + c] : (c == d ? y[r] : T(1));
    return v * T(w[r]);
  }

  template <int MAXD>
  __device__ __forceinline__ void row(int64_t r, T (&z)[MAXD]) const {
    const T wr = T(w[r]);
    const T* p = X + r * d;
#pragma unroll
    for (int a = 0; a < MAXD; ++a) {
      const T v = a < d ? p[a] : (a == d ? y[r] : (a == d + 1 ? T(1) : T(0)));
      z[a] = v * wr;
    }
  }
};

template <typename T, typename W>
int run(const T* X, const T* y, const W* w, T* part, T* out, long long n,
        int d, int chunks, long long rows_per_chunk, void* stream) {
  return gram::launch<T>(MaskedDesign<T, W>{X, y, w, d}, part, out, n, d + 2,
                         chunks, rows_per_chunk, stream);
}

}  // namespace

// w as bool (one byte, 0 or 1) or as the input's own float type.
extern "C" int masked_gram_f32_b8(const float* X, const float* y,
                                  const uint8_t* w, float* part, float* out,
                                  long long n, int d, int chunks,
                                  long long rows_per_chunk, void* stream) {
  return run<float, uint8_t>(X, y, w, part, out, n, d, chunks,
                             rows_per_chunk, stream);
}

extern "C" int masked_gram_f32_f32(const float* X, const float* y,
                                   const float* w, float* part, float* out,
                                   long long n, int d, int chunks,
                                   long long rows_per_chunk, void* stream) {
  return run<float, float>(X, y, w, part, out, n, d, chunks, rows_per_chunk,
                           stream);
}

extern "C" int masked_gram_f64_b8(const double* X, const double* y,
                                  const uint8_t* w, double* part,
                                  double* out, long long n, int d,
                                  int chunks, long long rows_per_chunk,
                                  void* stream) {
  return run<double, uint8_t>(X, y, w, part, out, n, d, chunks,
                              rows_per_chunk, stream);
}

extern "C" int masked_gram_f64_f64(const double* X, const double* y,
                                   const double* w, double* part,
                                   double* out, long long n, int d,
                                   int chunks, long long rows_per_chunk,
                                   void* stream) {
  return run<double, double>(X, y, w, part, out, n, d, chunks,
                             rows_per_chunk, stream);
}
