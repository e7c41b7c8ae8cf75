// Data-quality sketch of one flush for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package lets XLA fuse each profiled
// column's sketch (sparkdq4ml_tpu/utils/dqprof.py, _sketch_body and
// _rule_body) into one small program a column; done as plain PyTorch on
// the card that would be a dozen launches a column on every flush. Here
// every profiled column and every rule column of a flush is one grid:
//
//   column c: [count, nulls, sum, sumsq, min, max, hist[0..bins)]
//     count, nulls, sum, sumsq, min and max over every row below n whose
//     mask is set (NaN under the mask is a null, and no moment sees it);
//     the histogram over the stride sample rows 0, step, 2 step, ... below
//     n, each weighted by step (step = ceil(bucket / 4096), from the JAX
//     package's padded bucket, so both packages sample the same rows),
//     bucket floor((clip(sign(x) log10(1 + |x|), -12, 12) + 12) * c) with
//     c = float(bins / 24), clipped to [0, bins);
//   rule r: [rows, passed], rows = mask_in rows (every row without a
//     mask_in), passed = those with x > 0 (NaN fails).
//
// Values are read in their own type and converted to float32 as the JAX
// body's astype does; sums and squares are kept in double (a float32 value
// squares exactly in double), so a 10^7-row mean and M2 stay within 1e-15
// of float64 where the JAX package's float32 sums are not.
//
// Bound: bytes. A column reads 4 bytes (float32) and its mask byte a row:
// 5 bytes a row a column. The first kernel gives each (column, range of
// rows) one block, enough blocks to fill the card (ops/kernels.py:
// sketch_plan), each thread reading four rows an iteration before adding
// them; a thread keeps its own double sums over a fixed set of rows, the
// block adds the threads' partials in a fixed tree and writes one partial
// a block; histogram counts are integers (shared-memory integer atomics,
// whose order does not change a count). The second kernel, one block a
// column, adds the block partials in a fixed order. No float atomics
// anywhere: the result is the same bits on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The contract shared with ops/kernels.py (SKETCH_* and _SKETCH_TYPES),
// which passes each of these in its NVCC_FLAGS.
#ifndef DQ_SKETCH_MAX_COLS
#error "build with -DDQ_SKETCH_MAX_COLS (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_MAX_BINS
#error "build with -DDQ_SKETCH_MAX_BINS (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_MOMENTS
#error "build with -DDQ_SKETCH_MOMENTS (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_BIG
#error "build with -DDQ_SKETCH_BIG (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_TMAX
#error "build with -DDQ_SKETCH_TMAX (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_F32
#error "build with -DDQ_SKETCH_F32 (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_F64
#error "build with -DDQ_SKETCH_F64 (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_I32
#error "build with -DDQ_SKETCH_I32 (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_I64
#error "build with -DDQ_SKETCH_I64 (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_B8
#error "build with -DDQ_SKETCH_B8 (ops/kernels.py: NVCC_FLAGS)"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMoments = DQ_SKETCH_MOMENTS;
constexpr float kBig = DQ_SKETCH_BIG;    // an empty column's min / -max
constexpr float kTmax = DQ_SKETCH_TMAX;

// dtype codes, as ops/kernels.py:_SKETCH_TYPES numbers them
enum {
  kF32 = DQ_SKETCH_F32, kF64 = DQ_SKETCH_F64, kI32 = DQ_SKETCH_I32,
  kI64 = DQ_SKETCH_I64, kB8 = DQ_SKETCH_B8
};

}  // namespace

struct SketchArgs {
  const void* cols[2 * DQ_SKETCH_MAX_COLS];  // profiled columns, then rules
  int dtypes[2 * DQ_SKETCH_MAX_COLS];
  const bool* mask;       // the flush's output mask (columns)
  const bool* mask_in;    // its input mask (rules); null: every row
  long long n;
  long long step;         // the histogram's stride
  long long rows_per_block;
  int ncols;
  int nrules;
  int bins;
  int blocks;             // blocks a column
  float bucket_scale;     // float(bins / 24)
};

namespace {

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          long long i) {
  switch (dtype) {
    case kF64: return (float)((const double*)p)[i];
    case kI32: return (float)((const int32_t*)p)[i];
    case kI64: return (float)((const long long*)p)[i];
    case kB8: return ((const uint8_t*)p)[i] ? 1.0f : 0.0f;
    default: return ((const float*)p)[i];
  }
}

// A block partial: 6 doubles (count, nulls, sum, sumsq, min, max) then
// bins counts as doubles; a rule's: 2 doubles (rows, passed).
__device__ __forceinline__ long long partial_stride(int bins) {
  return kMoments + bins;
}

template <typename T, typename Op>
__device__ T block_reduce(T v, T* sh, Op op) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = op(sh[threadIdx.x],
                                              sh[threadIdx.x + s]);
    __syncthreads();
  }
  T out = sh[0];
  __syncthreads();
  return out;
}

struct Add {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

__device__ __forceinline__ int bucket_of(float x, int bins, float scale) {
  const float l = log10f(1.0f + fabsf(x));
  float t = x > 0.0f ? l : (x < 0.0f ? -l : 0.0f);
  t = fminf(fmaxf(t, -kTmax), kTmax);
  int idx = (int)((t + kTmax) * scale);
  return idx < 0 ? 0 : (idx > bins - 1 ? bins - 1 : idx);
}

// A thread reads kUnroll rows an iteration, kThreads apart, before it
// adds any: eight independent loads in flight a thread.
constexpr int kUnroll = 4;

__global__ void sketch_partials(const SketchArgs a, double* partials) {
  __shared__ double sh_d[kThreads];
  __shared__ long long sh_l[kThreads];
  __shared__ float sh_f[kThreads];
  __shared__ unsigned int hist[DQ_SKETCH_MAX_BINS];
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  const long long start = (long long)b * a.rows_per_block;
  long long end = start + a.rows_per_block;
  if (end > a.n) end = a.n;
  const void* col = a.cols[c];
  const int dtype = a.dtypes[c];
  if (c >= a.ncols) {
    // a rule column: [rows, passed] over the input mask (every row
    // without one)
    long long rows = 0, passed = 0;
    for (long long base = start + threadIdx.x; base < end;
         base += kUnroll * kThreads) {
      bool in[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + (long long)u * kThreads;
        in[u] = i < end && (a.mask_in == nullptr || a.mask_in[i]);
        v[u] = i < end ? load_f32(col, dtype, i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        rows += in[u];
        passed += in[u] && v[u] > 0.0f;
      }
    }
    rows = block_reduce(rows, sh_l, Add());
    passed = block_reduce(passed, sh_l, Add());
    if (threadIdx.x == 0) {
      double* out = partials + (long long)a.ncols * a.blocks *
                                   partial_stride(a.bins) +
                    ((long long)(c - a.ncols) * a.blocks + b) * 2;
      out[0] = (double)rows;
      out[1] = (double)passed;
    }
    return;
  }
  for (int k = threadIdx.x; k < a.bins; k += kThreads) hist[k] = 0;
  __syncthreads();
  long long count = 0, nulls = 0;
  double s1 = 0.0, s2 = 0.0;
  float mn = kBig, mx = -kBig;
  for (long long base = start + threadIdx.x; base < end;
       base += kUnroll * kThreads) {
    bool in[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      in[u] = i < end && a.mask[i];
      v[u] = i < end ? load_f32(col, dtype, i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!in[u]) continue;
      if (isnan(v[u])) {
        ++nulls;
        continue;
      }
      ++count;
      const double xd = (double)v[u];
      s1 += xd;
      s2 += xd * xd;
      mn = fminf(mn, v[u]);
      mx = fmaxf(mx, v[u]);
    }
  }
  // the stride sample within [start, end): rows k * step
  const long long k0 = (start + a.step - 1) / a.step;
  for (long long k = k0 + threadIdx.x; k * a.step < end; k += kThreads) {
    const long long i = k * a.step;
    if (!a.mask[i]) continue;
    const float x = load_f32(col, dtype, i);
    if (isnan(x)) continue;
    atomicAdd(&hist[bucket_of(x, a.bins, a.bucket_scale)], 1u);
  }
  count = block_reduce(count, sh_l, Add());
  nulls = block_reduce(nulls, sh_l, Add());
  s1 = block_reduce(s1, sh_d, Add());
  s2 = block_reduce(s2, sh_d, Add());
  mn = block_reduce(mn, sh_f, Min());
  mx = block_reduce(mx, sh_f, Max());
  double* out = partials + ((long long)c * a.blocks + b) *
                               partial_stride(a.bins);
  if (threadIdx.x == 0) {
    out[0] = (double)count;
    out[1] = (double)nulls;
    out[2] = s1;
    out[3] = s2;
    out[4] = (double)mn;
    out[5] = (double)mx;
  }
  for (int k = threadIdx.x; k < a.bins; k += kThreads)
    out[kMoments + k] = (double)hist[k];
}

// Slot v of a column partial: min (4) and max (5) combine by min and max,
// the rest by addition; a rule's two slots by addition.
__device__ __forceinline__ double combine(double x, double y, int v,
                                          bool rule) {
  if (!rule && v == 4) return fmin(x, y);
  if (!rule && v == 5) return fmax(x, y);
  return x + y;
}

__device__ __forceinline__ double identity(int v, bool rule) {
  if (!rule && v == 4) return (double)kBig;
  if (!rule && v == 5) return -(double)kBig;
  return 0.0;
}

// One block a column (or rule) adds its block partials in a fixed order:
// a pass takes W slots at once with P = kThreads / W threads a slot, the
// thread of phase p adding blocks p, p + P, p + 2P, ... in turn, then the
// P phases are added in phase order.
__global__ void sketch_combine(const SketchArgs a, const double* partials,
                               double* out) {
  __shared__ double sh[kThreads];
  const int c = blockIdx.x;
  const bool rule = c >= a.ncols;
  const int stride = rule ? 2 : (int)partial_stride(a.bins);
  const double* p = rule
      ? partials + (long long)a.ncols * a.blocks * partial_stride(a.bins) +
            (long long)(c - a.ncols) * a.blocks * 2
      : partials + (long long)c * a.blocks * stride;
  double* o = rule ? out + (long long)a.ncols * partial_stride(a.bins) +
                         2 * (c - a.ncols)
                   : out + (long long)c * stride;
  const int P = stride >= kThreads ? 1 : kThreads / stride;
  const int W = kThreads / P;
  const int lane = threadIdx.x % W;
  const int phase = threadIdx.x / W;
  for (int v0 = 0; v0 < stride; v0 += W) {
    const int v = v0 + lane;
    double acc = identity(v, rule);
    if (v < stride && phase < P) {
      for (int b = phase; b < a.blocks; b += P)
        acc = combine(acc, p[(long long)b * stride + v], v, rule);
    }
    sh[threadIdx.x] = acc;
    __syncthreads();
    if (phase == 0 && v < stride) {
      double r = sh[lane];
      for (int q = 1; q < P; ++q) r = combine(r, sh[q * W + lane], v, rule);
      o[v] = (!rule && v >= kMoments) ? r * (double)a.step : r;
    }
    __syncthreads();
  }
}

}  // namespace

// partials: (ncols * blocks * (6 + bins) + nrules * blocks * 2) doubles;
// out: (ncols * (6 + bins) + nrules * 2) doubles.
extern "C" int dq_sketch(const SketchArgs* a, double* partials, double* out,
                         void* stream) {
  const int groups = a->ncols + a->nrules;
  if (groups <= 0) return 0;
  if (groups > 2 * DQ_SKETCH_MAX_COLS || a->ncols > DQ_SKETCH_MAX_COLS ||
      a->bins < 1 || a->bins > DQ_SKETCH_MAX_BINS || a->blocks < 1 ||
      a->step < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)a->blocks, (unsigned)groups);
  sketch_partials<<<grid, kThreads, 0, s>>>(*a, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sketch_combine<<<(unsigned)groups, kThreads, 0, s>>>(*a, partials, out);
  return (int)cudaGetLastError();
}
