// Fused data-quality rule chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dq_kernel`
// (sparkdq4ml_tpu/ops/pallas_kernels.py, called through `_dq_rules_call`
// and `dq_rules_pallas`). For each row:
//   pnm  = price < 20 ? -1 : price               (NaN passes through)
//   pcc  = (guest < 14 && price > 90) || isnan(price) || isnan(guest)
//            ? -1 : price
//   keep = pnm > 0 && pcc > 0
//
// Bound: pure data movement. Each row reads two values and writes two
// values and one byte (17 bytes in float32), with three compares per row,
// so the card's memory rate is the limit. The design is a 1-D grid-stride
// loop: neighbouring threads touch neighbouring elements, so every load and
// store is coalesced. The TPU version's (rows, 128) re-layout and sentinel
// padding have no purpose here; the ragged tail is the loop bound.
//
// Built without --use_fast_math: fast math lets the compiler assume no
// NaN, which would break isnan() and the NaN comparisons that make the two
// rules differ on nulls. The constants are compared in the input's own
// type, as the reference does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void dq_rules_kernel(const T* __restrict__ price,
                                const T* __restrict__ guest,
                                T* __restrict__ pnm, T* __restrict__ pcc,
                                bool* __restrict__ keep, int64_t n) {
  const T sentinel = T(-1.0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T p = price[i];
    const T g = guest[i];
    const T a = (p < T(20.0)) ? sentinel : p;
    const bool bad = (g < T(14.0)) && (p > T(90.0));
    const bool is_null = isnan(p) || isnan(g);
    const T b = (bad || is_null) ? sentinel : p;
    pnm[i] = a;
    pcc[i] = b;
    keep[i] = (a > T(0.0)) && (b > T(0.0));
  }
}

template <typename T>
int launch(const T* price, const T* guest, T* pnm, T* pcc, bool* keep,
           long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  // Enough blocks to keep every SM busy; the grid-stride loop covers the
  // rest.
  if (blocks > 132 * 32) blocks = 132 * 32;
  dq_rules_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      price, guest, pnm, pcc, keep, (int64_t)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dq_rules_f32(const float* price, const float* guest,
                            float* pnm, float* pcc, bool* keep, long long n,
                            void* stream) {
  return launch<float>(price, guest, pnm, pcc, keep, n, stream);
}

extern "C" int dq_rules_f64(const double* price, const double* guest,
                            double* pnm, double* pcc, bool* keep, long long n,
                            void* stream) {
  return launch<double>(price, guest, pnm, pcc, keep, n, stream);
}
