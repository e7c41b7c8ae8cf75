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
// the input's float type) are read directly and Z is never written to
// global memory. At D <= 4 the row z * w is formed in registers. The tiled
// form copies raw X into the shared-memory slab (16 bytes at a time when d
// is a multiple of 4), reads the slab's w and y one slab ahead, and then
// scales the slab in place and fills the y and 1 columns, once per element
// and outside the multiply loop. The plan of gram_common.cuh makes the
// result bit-stable from run to run and symmetric bit for bit, which the
// cross-validation's A_all - A_fold needs.
//
// Bound: n * (d + 2) * elem bytes in (plus one byte or elem a row for w),
// D^2 * elem out, and n * D * (D + 1) flops for one triangle of the
// symmetric A. At d = 1 memory is the limit, at d = 512 the float32
// (non-tensor) rate. On an H100 80GB HBM3 at 700 W (chip_smoke.py): about
// 30% of the bytes' bound at (10^7, 1) and 31% of the float32 rate's bound
// at (10^6, 512), within 1.15 times packed_gram at the same D.

#include "gram_common.cuh"

namespace {

template <typename T, typename W>
struct MaskedDesign {
  static constexpr bool kScaled = true;    // slabs are scaled by w in place
  const T* __restrict__ X;
  const T* __restrict__ y;
  const W* __restrict__ w;
  int d;

  // The tiled stage 1 copies X's rows (stride d, d columns), then forms
  // [x, y, 1] * w in shared memory from the slab's weight() and label().
  __host__ __device__ const T* src() const { return X; }
  __host__ __device__ int ld() const { return d; }
  __device__ __forceinline__ T weight(int64_t r) const { return T(w[r]); }
  __device__ __forceinline__ T label(int64_t r) const { return y[r]; }

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
