// Data-quality sketch of one flush for Hopper (sm_90a): one launch a call.
//
// Replaces no Pallas kernel. The JAX package lets XLA fuse each profiled
// column's sketch (sparkdq4ml_tpu/utils/dqprof.py, _sketch_body and
// _rule_body) into one small program a column; done as plain PyTorch on
// the card that would be a dozen launches a column on every flush. Here
// every profiled column and every rule column of a flush is one launch:
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
// Bound: bytes. A column reads 4 bytes (float32) and its mask byte a row,
// a rule its 4 bytes and, with one, its mask_in byte. The design:
// - One launch. A 1-D grid of blocks over contiguous ranges of rows, a
//   multiple of DQ_SKETCH_GRAIN rows each (ops/kernels.py: sketch_plan: at
//   most 1,056 blocks, about eight an H100 SM, a fixed function of n, so
//   the order of the adds is the same on every card). A block takes every
//   column and rule of the call over its range, so the mask the first
//   column read is in the cache for the next.
// - 16-byte reads. Thread t of a block (DQ_SKETCH_THREADS, 128) takes the
//   chunks of 16 rows (the grain) t, t + 128, ... of its range, in order:
//   a float32 column's chunk as four 16-byte words and its mask's as one,
//   through the read-only path, five loads for sixteen rows. (Chunks of
//   four rows, a float4 and a 4-byte mask word each, ran at half the rate
//   of an unmasked column on an H100: the loads, not the bytes, were the
//   limit; PERF.md section 6.) Where the column's or the mask's pointer is
//   off the 16-byte grid (a view; a range starts on the grain, so its
//   start is on it) the same rows are read one by one in the same order,
//   so the bits are the same. The rows past the last whole chunk are read
//   one by one. The pass is compiled for each dtype, so no switch is in
//   the loop.
// - Reductions in registers. Count and nulls as integers, min and max in
//   float32, sums in double; a butterfly of shuffles across each warp, then
//   one barrier for every column and rule at once, after which the warps
//   are added in warp order.
// - Across blocks, no second launch. Each block writes its tallies into
//   the stream's scratch and takes an integer ticket (tickets.cuh); the
//   last block adds each column's and rule's block tallies in a fixed
//   order (thread t the blocks t, t + 128, ... in order, the butterfly,
//   the warps in order), so which block comes last changes nothing, and
//   resets the ticket. One block writes the result itself.
// - The histogram: the stride sample (at most about 4,096 rows a column,
//   a few a block) counted in shared memory, every column's at once after
//   the pass, then added into integer counters in the scratch with integer
//   atomics, whose order does not change a count; the last block reads and
//   zeroes them, so the next call on the stream starts clean.
// No float atomics anywhere: the result is the same bits on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tickets.cuh"  // arrive: the last block's ticket

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
#ifndef DQ_SKETCH_GRAIN
#error "build with -DDQ_SKETCH_GRAIN (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_TALLY_BYTES
#error "build with -DDQ_SKETCH_TALLY_BYTES (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef DQ_SKETCH_THREADS
#error "build with -DDQ_SKETCH_THREADS (ops/kernels.py: NVCC_FLAGS)"
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

constexpr int kThreads = DQ_SKETCH_THREADS;  // a multiple of 32
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 2 * DQ_SKETCH_MAX_COLS;  // columns, then rules
constexpr int kMoments = DQ_SKETCH_MOMENTS;
constexpr float kBig = DQ_SKETCH_BIG;    // an empty column's min / -max
constexpr float kTmax = DQ_SKETCH_TMAX;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kThreads <= 1024,
              "DQ_SKETCH_THREADS: whole warps, one block");

// dtype codes, as ops/kernels.py:_SKETCH_TYPES numbers them
enum {
  kF32 = DQ_SKETCH_F32, kF64 = DQ_SKETCH_F64, kI32 = DQ_SKETCH_I32,
  kI64 = DQ_SKETCH_I64, kB8 = DQ_SKETCH_B8
};

}  // namespace

// A call's plan, as ops/kernels.py:_SketchPlan lays it out (made once a
// shape): the rows, the histogram's stride, each block's rows, where the
// ticket, the histogram counters and the block tallies lie in the
// stream's scratch (bytes from its start), the groups' dtype codes.
struct SketchPlan {
  long long n;
  long long step;
  long long rows_per_block;
  long long ticket_offset;
  long long hist_offset;
  long long tally_offset;
  int dtypes[2 * DQ_SKETCH_MAX_COLS];
  int ncols;
  int nrules;
  int bins;
  int blocks;
  float bucket_scale;     // float(bins / 24)
};

namespace {

struct SketchArgs {
  SketchPlan p;
  const void* cols[kGroups];      // profiled columns, then rules
  const unsigned char* mask;      // the flush's output mask (columns)
  const unsigned char* mask_in;   // its input mask (rules); null: every row
  unsigned char* scratch;         // the stream's scratch; null for one block
};

// One group's tallies over some rows: a column's count and nulls (n0, n1),
// sum and sum of squares, min and max; a rule's rows and passed (n0, n1).
struct Tally {
  double s1, s2;
  unsigned long long n0, n1;
  float mn, mx;
};
static_assert(sizeof(Tally) == DQ_SKETCH_TALLY_BYTES,
              "ops/kernels.py sizes the scratch by SKETCH_TALLY_BYTES");

__device__ __forceinline__ Tally empty_tally() {
  return Tally{0.0, 0.0, 0ull, 0ull, kBig, -kBig};
}

__device__ __forceinline__ Tally combine(Tally a, const Tally& b) {
  a.s1 += b.s1;
  a.s2 += b.s2;
  a.n0 += b.n0;
  a.n1 += b.n1;
  a.mn = fminf(a.mn, b.mn);
  a.mx = fmaxf(a.mx, b.mx);
  return a;
}

// A butterfly over the lanes in a fixed pattern; lane 0 holds the warp's.
__device__ __forceinline__ Tally warp_tally(Tally t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    t.s1 += __shfl_xor_sync(kFull, t.s1, o);
    t.s2 += __shfl_xor_sync(kFull, t.s2, o);
    t.n0 += __shfl_xor_sync(kFull, t.n0, o);
    t.n1 += __shfl_xor_sync(kFull, t.n1, o);
    t.mn = fminf(t.mn, __shfl_xor_sync(kFull, t.mn, o));
    t.mx = fmaxf(t.mx, __shfl_xor_sync(kFull, t.mx, o));
  }
  return t;
}

// A block tally another block wrote, read from L2.
__device__ __forceinline__ Tally load_tally(const Tally* p) {
  return Tally{__ldcg(&p->s1), __ldcg(&p->s2), __ldcg(&p->n0),
               __ldcg(&p->n1), __ldcg(&p->mn), __ldcg(&p->mx)};
}

// A thread's running tallies of a column: an invalid row adds +0.0 to the
// sums, which leaves them as they are (they never hold -0.0).
struct ColAcc {
  double s1 = 0.0, s2 = 0.0;
  unsigned count = 0, nulls = 0;
  float mn = kBig, mx = -kBig;
  __device__ __forceinline__ void add(float v, bool in) {
    const bool nan = isnan(v);
    const bool ok = in && !nan;
    count += ok;
    nulls += in && nan;
    const double d = ok ? (double)v : 0.0;
    s1 += d;
    s2 += d * d;
    if (ok) {
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  }
  __device__ __forceinline__ Tally tally() const {
    return Tally{s1, s2, count, nulls, mn, mx};
  }
};

// ... and of a rule.
struct RuleAcc {
  unsigned rows = 0, passed = 0;
  __device__ __forceinline__ void add(float v, bool in) {
    rows += in;
    passed += in && v > 0.0f;
  }
  __device__ __forceinline__ Tally tally() const {
    return Tally{0.0, 0.0, rows, passed, kBig, -kBig};
  }
};

template <typename T>
__device__ __forceinline__ float f32(T x) { return (float)x; }
template <>
__device__ __forceinline__ float f32<unsigned char>(unsigned char x) {
  return x ? 1.0f : 0.0f;
}

// A chunk: the kChunk rows of one grain, read as sizeof(T) words of 16
// bytes (one for bool) and its mask as one more; a row becomes float32
// when it is added. Row j of the words w.
constexpr int kChunk = DQ_SKETCH_GRAIN;
static_assert(kChunk == 16, "a chunk's mask is one 16-byte word");

__device__ __forceinline__ unsigned word(const uint4& q, int c) {
  return c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
}
template <typename T>
__device__ __forceinline__ float row_of(const uint4* w, int j);
template <>
__device__ __forceinline__ float row_of<float>(const uint4* w, int j) {
  return __uint_as_float(word(w[j / 4], j % 4));
}
template <>
__device__ __forceinline__ float row_of<int>(const uint4* w, int j) {
  return (float)(int)word(w[j / 4], j % 4);
}
template <>
__device__ __forceinline__ float row_of<double>(const uint4* w, int j) {
  const uint4& q = w[j / 2];
  return (float)__hiloint2double((int)(j % 2 ? q.w : q.y),
                                 (int)(j % 2 ? q.z : q.x));
}
template <>
__device__ __forceinline__ float row_of<long long>(const uint4* w, int j) {
  const uint4& q = w[j / 2];
  const unsigned long long lo = j % 2 ? q.z : q.x;
  const unsigned long long hi = j % 2 ? q.w : q.y;
  return (float)(long long)((hi << 32) | lo);
}
template <>
__device__ __forceinline__ float row_of<unsigned char>(const uint4* w,
                                                       int j) {
  return (word(w[0], j / 4) >> (8 * (j % 4))) & 0xffu ? 1.0f : 0.0f;
}
__device__ __forceinline__ bool mask_of(const uint4& m, int j) {
  return (word(m, j / 4) >> (8 * (j % 4))) & 0xffu;
}

// One group over the rows [start, end) of a block, into `acc`: thread t
// adds the chunks t, t + kThreads, ... in order, each row of a chunk in
// order, then the rows past the last whole chunk (only the last block has
// them), which the thread that owns the next chunk adds after its others.
// kVec: a chunk in sizeof(T) 16-byte reads of the column (one for bool)
// and one of the mask, so that a masked float32 chunk is five loads for
// sixteen rows; else the same rows one by one, in the same order. kMasked:
// read `m`; else every row is in.
template <typename T, bool kVec, bool kMasked, typename Acc>
__device__ __forceinline__ void pass(const T* __restrict__ x,
                                     const unsigned char* __restrict__ m,
                                     long long start, long long end,
                                     Acc& acc) {
  constexpr int W = sizeof(T);  // 16-byte words a chunk
  const long long whole = (end - start) / kChunk;
  for (long long k = threadIdx.x; k < whole; k += kThreads) {
    const long long i = start + kChunk * k;
    if (kVec) {
      uint4 w[W];
#pragma unroll
      for (int q = 0; q < W; ++q)
        w[q] = __ldg(reinterpret_cast<const uint4*>(x + i) + q);
      const uint4 mk = kMasked
                           ? __ldg(reinterpret_cast<const uint4*>(m + i))
                           : make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        acc.add(row_of<T>(w, j), mask_of(mk, j));
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        acc.add(f32(__ldg(x + i + j)),
                kMasked ? (bool)__ldg(m + i + j) : true);
    }
  }
  const long long tail = start + kChunk * whole;
  if (tail < end && threadIdx.x == whole % kThreads) {
    for (long long i = tail; i < end; ++i)
      acc.add(f32(__ldg(x + i)), kMasked ? (bool)__ldg(m + i) : true);
  }
}

template <typename T, bool kMasked, typename Acc>
__device__ __forceinline__ void typed_pass(const void* col,
                                           const unsigned char* m,
                                           long long start, long long end,
                                           Acc& acc) {
  const T* x = static_cast<const T*>(col);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (!kMasked || reinterpret_cast<uintptr_t>(m) % 16 == 0);
  if (vec)
    pass<T, true, kMasked>(x, m, start, end, acc);
  else
    pass<T, false, kMasked>(x, m, start, end, acc);
}

// The dtype's code picks the compiled pass once a group, outside the loop.
template <bool kMasked, typename Acc>
__device__ void group_pass(const void* col, int dtype,
                           const unsigned char* m, long long start,
                           long long end, Acc& acc) {
  switch (dtype) {
    case kF64: typed_pass<double, kMasked>(col, m, start, end, acc); break;
    case kI32: typed_pass<int, kMasked>(col, m, start, end, acc); break;
    case kI64: typed_pass<long long, kMasked>(col, m, start, end, acc); break;
    case kB8:
      typed_pass<unsigned char, kMasked>(col, m, start, end, acc);
      break;
    default: typed_pass<float, kMasked>(col, m, start, end, acc); break;
  }
}

__device__ __forceinline__ int bucket_of(float x, int bins, float scale) {
  const float l = log10f(1.0f + fabsf(x));
  float t = x > 0.0f ? l : (x < 0.0f ? -l : 0.0f);
  t = fminf(fmaxf(t, -kTmax), kTmax);
  int idx = (int)((t + kTmax) * scale);
  return idx < 0 ? 0 : (idx > bins - 1 ? bins - 1 : idx);
}

// The stride sample's rows k * step within [start, end) into `hist`: the
// row's mask and value read together (both in L2: the pass just read them).
template <typename T>
__device__ void typed_sample(const void* col, const unsigned char* m,
                             long long start, long long end,
                             const SketchPlan& p, unsigned* hist) {
  const T* x = static_cast<const T*>(col);
  for (long long k = (start + p.step - 1) / p.step + threadIdx.x;
       k * p.step < end; k += kThreads) {
    const long long i = k * p.step;
    const bool in = __ldg(m + i);
    const float v = f32(__ldg(x + i));
    if (in && !isnan(v))
      atomicAdd(&hist[bucket_of(v, p.bins, p.bucket_scale)], 1u);
  }
}

__device__ void sample(const void* col, int dtype, const unsigned char* m,
                       long long start, long long end, const SketchPlan& p,
                       unsigned* hist) {
  switch (dtype) {
    case kF64: typed_sample<double>(col, m, start, end, p, hist); break;
    case kI32: typed_sample<int>(col, m, start, end, p, hist); break;
    case kI64: typed_sample<long long>(col, m, start, end, p, hist); break;
    case kB8: typed_sample<unsigned char>(col, m, start, end, p, hist); break;
    default: typed_sample<float>(col, m, start, end, p, hist); break;
  }
}

// Group g's moments (a column's six, a rule's two) into `out`.
__device__ __forceinline__ void write_tally(const SketchPlan& p, int g,
                                            const Tally& t, double* out) {
  if (g < p.ncols) {
    double* o = out + (size_t)g * (kMoments + p.bins);
    o[0] = (double)t.n0;
    o[1] = (double)t.n1;
    o[2] = t.s1;
    o[3] = t.s2;
    o[4] = (double)t.mn;
    o[5] = (double)t.mx;
  } else {
    double* o = out + (size_t)p.ncols * (kMoments + p.bins) +
                2 * (size_t)(g - p.ncols);
    o[0] = (double)t.n0;
    o[1] = (double)t.n1;
  }
}

// The tallies src[t], src[t + kThreads], ... of `blocks` blocks, added in
// that order onto an empty tally, two loaded before they are added.
__device__ __forceinline__ Tally thread_blocks(const Tally* src,
                                               int blocks) {
  Tally t = empty_tally();
  int b = threadIdx.x;
  for (; b + kThreads < blocks; b += 2 * kThreads) {
    const Tally x0 = load_tally(src + b);
    const Tally x1 = load_tally(src + b + kThreads);
    t = combine(combine(t, x0), x1);
  }
  if (b < blocks) t = combine(t, load_tally(src + b));
  return t;
}

// The block's histograms (ncols x bins counters) in dynamic shared memory.
__global__ void __launch_bounds__(kThreads, 8)
    sketch(const SketchArgs a, double* __restrict__ out) {
  __shared__ Tally warps[kGroups][kWarps];
  extern __shared__ unsigned hist[];
  const SketchPlan& p = a.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = p.ncols + p.nrules;
  const int counts = p.ncols * p.bins;
  const bool one = p.blocks == 1;
  const long long start = (long long)blockIdx.x * p.rows_per_block;
  const long long end = min(p.n, start + p.rows_per_block);
  for (int e = threadIdx.x; e < counts; e += kThreads) hist[e] = 0;

  for (int g = 0; g < groups; ++g) {
    Tally t;
    if (g < p.ncols) {
      ColAcc acc;
      group_pass<true>(a.cols[g], p.dtypes[g], a.mask, start, end, acc);
      t = acc.tally();
    } else {
      RuleAcc acc;
      if (a.mask_in != nullptr)
        group_pass<true>(a.cols[g], p.dtypes[g], a.mask_in, start, end, acc);
      else
        group_pass<false>(a.cols[g], p.dtypes[g], nullptr, start, end, acc);
      t = acc.tally();
    }
    t = warp_tally(t);
    if (lane == 0) warps[g][warp] = t;
  }
  __syncthreads();  // every group's warps, and the zeroed histograms
  Tally* tallies = one ? nullptr
                       : reinterpret_cast<Tally*>(a.scratch + p.tally_offset);
  unsigned* counters =
      one ? nullptr : reinterpret_cast<unsigned*>(a.scratch + p.hist_offset);
  if ((int)threadIdx.x < groups) {
    const int g = threadIdx.x;
    Tally t = warps[g][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = combine(t, warps[g][w]);
    if (one)
      write_tally(p, g, t, out);
    else
      tallies[(size_t)g * p.blocks + blockIdx.x] = t;
  }
  for (int c = 0; c < p.ncols; ++c)
    sample(a.cols[c], p.dtypes[c], a.mask, start, end, p, hist + c * p.bins);
  __syncthreads();
  const int stride = kMoments + p.bins;
  for (int e = threadIdx.x; e < counts; e += kThreads) {
    const unsigned h = hist[e];
    if (one)
      out[(size_t)(e / p.bins) * stride + kMoments + e % p.bins] =
          (double)h * (double)p.step;
    else if (h)
      atomicAdd(counters + e, h);
  }
  if (one || !arrive(reinterpret_cast<unsigned*>(a.scratch + p.ticket_offset),
                     (unsigned)p.blocks))
    return;

  // The last block: each group's block tallies in a fixed order.
  for (int g = 0; g < groups; ++g) {
    const Tally t = warp_tally(
        thread_blocks(tallies + (size_t)g * p.blocks, p.blocks));
    if (lane == 0) warps[g][warp] = t;
  }
  __syncthreads();
  if ((int)threadIdx.x < groups) {
    const int g = threadIdx.x;
    Tally t = warps[g][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = combine(t, warps[g][w]);
    write_tally(p, g, t, out);
  }
  for (int e = threadIdx.x; e < counts; e += kThreads)
    out[(size_t)(e / p.bins) * stride + kMoments + e % p.bins] =
        (double)atomicExch(counters + e, 0u) * (double)p.step;
}

bool known_dtype(int d) {
  return d == kF32 || d == kF64 || d == kI32 || d == kI64 || d == kB8;
}

}  // namespace

// ptrs: the mask, the mask_in (0: every row), then the columns and rules;
// scratch: the stream's (its ticket and histogram counters at zero), which
// one block does not use; out: (ncols * (6 + bins) + nrules * 2) doubles.
extern "C" int dq_sketch(const SketchPlan* plan,
                         const unsigned long long* ptrs, void* scratch,
                         double* out, void* stream) {
  const SketchPlan& p = *plan;
  const int groups = p.ncols + p.nrules;
  if (groups < 1 || p.ncols < 0 || p.nrules < 0 ||
      p.ncols > DQ_SKETCH_MAX_COLS || p.nrules > DQ_SKETCH_MAX_COLS ||
      p.bins < 1 || p.bins > DQ_SKETCH_MAX_BINS || p.blocks < 1 ||
      p.step < 1 || p.n < 0 || p.rows_per_block < DQ_SKETCH_GRAIN ||
      p.rows_per_block % DQ_SKETCH_GRAIN != 0 ||
      (long long)p.blocks * p.rows_per_block < p.n ||
      (p.n > 0 && p.ncols > 0 && ptrs[0] == 0) ||
      (p.blocks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  SketchArgs a;
  a.p = p;
  a.mask = reinterpret_cast<const unsigned char*>(ptrs[0]);
  a.mask_in = reinterpret_cast<const unsigned char*>(ptrs[1]);
  for (int g = 0; g < kGroups; ++g) {
    if (g < groups &&
        (!known_dtype(p.dtypes[g]) || (p.n > 0 && ptrs[2 + g] == 0)))
      return (int)cudaErrorInvalidValue;
    a.cols[g] = g < groups ? reinterpret_cast<const void*>(ptrs[2 + g])
                           : nullptr;
  }
  a.scratch = static_cast<unsigned char*>(scratch);
  const int smem = p.ncols * p.bins * (int)sizeof(unsigned);
  if (smem > 32 * 1024) {  // past what 48 KB leaves beside the static part
    const cudaError_t err = cudaFuncSetAttribute(
        sketch, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  sketch<<<(unsigned)p.blocks, kThreads, smem, (cudaStream_t)stream>>>(a,
                                                                      out);
  return (int)cudaGetLastError();
}
