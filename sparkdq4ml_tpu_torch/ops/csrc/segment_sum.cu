// Fixed-order segment sums for Hopper (sm_90a): the float sums of the
// grouped engine (sparkdq4ml_tpu_torch/ops/segments.py, `_seg_sum`).
//
// A port-only kernel: it replaces no Pallas TPU kernel. The JAX package
// sums groups with `jax.ops.segment_sum` (sparkdq4ml_tpu/ops/segments.py),
// an XLA scatter that gives one answer for one input. torch's `index_add_`
// adds float atomics in no fixed order on the card, so a GROUP BY sum, and
// every comparison with it, could change from run to run. Neither kernel
// here adds a float with an atomic: each sum runs in an order set by the
// launch plan (`ops/kernels.py: dense_segment_plan`, and the fixed tile
// size below), which depends only on the input's shape, so one input
// gives one result. (The sorted kernel's one integer atomic numbers the
// entries of a work list; the order of that list reaches no sum.)
//
// dense_*: unsorted slot ids into a table small enough for shared memory
//   (the dense GROUP BY program: 40 slots for 39 guests). Each block takes
//   one fixed, contiguous row range, and each of its warps keeps a table
//   of its own in shared memory. Thirty-two rows at a time, the lanes that
//   hold one slot find each other with __match_any_sync, and the lowest of
//   them adds their values to the warp's table in lane order. The block
//   then adds its warp tables in warp order into its partial table, and a
//   second kernel adds the partial tables in block order (with one block
//   the first kernel writes the result itself).
// sorted_*: nondecreasing segment ids (the sorted GROUP BY program, whose
//   segments are contiguous after the stable sort). A warp stages 32 tiles
//   of kTile consecutive rows in shared memory; each lane sums the runs of
//   its tile in row order and writes a run that lies inside its tile
//   straight to the result. A run that crosses a tile edge leaves a
//   partial per tile; a warp for each segment's first tile adds the later
//   tiles' partials, lane by lane in tile order and then across the lanes
//   in a fixed butterfly.
//   A segment id outside [0, size) is never written (memory stays safe
//   whatever the ids; ids that decrease give wrong sums, not faults).
//
// Bound: bytes. Each row's segment id (8 bytes) and its C values are read
// once and the tables are small, so the card's memory rate is the limit
// (about 0.03 ms for 9.6 M rows and three float32 columns). The warp
// tables keep the dense kernel's adds in shared memory; the sorted kernel
// reads each thread's tile from consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The plan's constants come from ops/kernels.py through nvcc flags, where
// the Python side sizes the scratch buffers from the same values.
#ifndef SEGSUM_WARPS
#error "build with -DSEGSUM_WARPS (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef SEGSUM_TILE
#error "build with -DSEGSUM_TILE (ops/kernels.py: NVCC_FLAGS)"
#endif
constexpr int kWarps = SEGSUM_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = SEGSUM_TILE;

template <typename T>
__global__ void dense_partials(const T* __restrict__ x,
                               const int64_t* __restrict__ seg,
                               T* __restrict__ part, T* __restrict__ out,
                               int64_t n, int C, int slots,
                               int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* table = reinterpret_cast<T*>(smem_raw);            // kWarps*slots*C
  T* stage = table + (size_t)kWarps * slots * C;        // kWarps*32*C
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* wt = table + (size_t)warp * slots * C;
  T* ws = stage + (size_t)warp * 32 * C;
  for (int i = threadIdx.x; i < kWarps * slots * C; i += kThreads)
    table[i] = T(0);
  __syncthreads();

  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = min(n, lo + rows_per_block);
  // Every thread runs the same number of rounds, so the whole warp meets
  // each __match_any_sync.
  for (int64_t base = lo; base < hi; base += kThreads) {
    const int64_t r = base + warp * 32 + lane;
    int s = -1;
    if (r < hi) {
      const int64_t g = seg[r];
      if (g >= 0 && g < slots) {
        s = (int)g;
        for (int c = 0; c < C; ++c) ws[lane * C + c] = x[r * C + c];
      }
    }
    __syncwarp();
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    if (s >= 0 && lane == __ffs(peers) - 1) {
      for (int c = 0; c < C; ++c) {
        T acc = wt[s * C + c];
        for (unsigned m = peers; m; m &= m - 1)
          acc += ws[(__ffs(m) - 1) * C + c];
        wt[s * C + c] = acc;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  T* dst = gridDim.x == 1 ? out : part + (size_t)blockIdx.x * slots * C;
  for (int i = threadIdx.x; i < slots * C; i += kThreads) {
    T acc = table[i];
    for (int w = 1; w < kWarps; ++w) acc += table[(size_t)w * slots * C + i];
    dst[i] = acc;
  }
}

template <typename T>
__global__ void dense_reduce(const T* __restrict__ part, T* __restrict__ out,
                             int blocks, int entries) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= entries) return;
  T acc = part[i];
  for (int b = 1; b < blocks; ++b) acc += part[(size_t)b * entries + i];
  out[i] = acc;
}

// The first row of [lo, n) whose segment is above s (seg nondecreasing).
__device__ int64_t segment_end(const int64_t* __restrict__ seg, int64_t lo,
                               int64_t n, int64_t s) {
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (seg[mid] <= s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Stage 1 of the sorted kernel. A warp stages the 32 tiles of its chunk
// (32 * kTile rows) in shared memory with coalesced loads, then each lane
// sums the runs of its own tile in row order. A tile's row j sits at
// lane * (kTile + 1) + j: the pad keeps the lanes on different banks.
// A lane whose last run starts in its tile and goes on past it is the
// segment's owner and enters the owner list (an integer counter: the
// list's order may vary, each owner's sum does not).
template <typename T>
__global__ void sorted_tiles(const T* __restrict__ x,
                             const int64_t* __restrict__ seg,
                             T* __restrict__ out, T* __restrict__ head,
                             T* __restrict__ tail, int* __restrict__ owners,
                             int* __restrict__ n_owners, int64_t n, int C,
                             int64_t tiles, int64_t size) {
  constexpr int kPitch = kTile + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int64_t* s_seg = reinterpret_cast<int64_t*>(smem_raw) +
                   (size_t)warp * 32 * kPitch;
  T* s_x = reinterpret_cast<T*>(reinterpret_cast<int64_t*>(smem_raw) +
                                (size_t)kWarps * 32 * kPitch) +
           (size_t)warp * 32 * kPitch;
  const int64_t chunk = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t base = chunk * 32 * kTile;
  if (base >= n) return;                    // the whole warp leaves
  const int64_t t = chunk * 32 + lane;
  for (int i = 0; i < kTile; ++i) {         // row base + i * 32 + lane
    const int64_t r = base + (int64_t)i * 32 + lane;
    const int local = i * 32 + lane;
    if (r < n) s_seg[(local / kTile) * kPitch + local % kTile] = seg[r];
  }
  const int64_t r0 = t * kTile, r1 = min(n, r0 + kTile);
  const bool active = t < tiles;
  bool first_starts = false, last_ends = false;
  if (active) {
    first_starts = r0 == 0 || seg[r0 - 1] != seg[r0];
    last_ends = r1 == n || seg[r1] != seg[r1 - 1];
  }
  const int64_t* my_seg = s_seg + (size_t)lane * kPitch;
  for (int c = 0; c < C; ++c) {
    __syncwarp();
    for (int i = 0; i < kTile; ++i) {
      const int64_t r = base + (int64_t)i * 32 + lane;
      const int local = i * 32 + lane;
      if (r < n) s_x[(local / kTile) * kPitch + local % kTile] = x[r * C + c];
    }
    __syncwarp();
    if (!active) continue;
    const T* my_x = s_x + (size_t)lane * kPitch;
    const int rows = (int)(r1 - r0);
    int run_start = 0;
    int64_t run_seg = my_seg[0];
    T acc = T(0);
    for (int j = 0; j <= rows; ++j) {
      const bool done = j == rows;
      const int64_t sj = done ? -1 : my_seg[j];
      if (done || sj != run_seg) {
        const bool starts = run_start != 0 || first_starts;
        const bool ends = !done || last_ends;
        if (!starts) {
          head[t * C + c] = acc;
        } else if (!ends) {
          tail[t * C + c] = acc;
          if (c == 0) owners[atomicAdd(n_owners, 1)] = (int)t;
        } else if (run_seg >= 0 && run_seg < size) {
          out[run_seg * C + c] = acc;
        }
        if (done) break;
        run_start = j;
        run_seg = sj;
        acc = T(0);
      }
      acc += my_x[j];
    }
  }
}

// Stage 2: a warp a listed owner. The lanes add the partials of the
// later tiles of the owner's segment, lane l taking tiles t + 1 + l,
// t + 33 + l, ... in turn; a butterfly of shuffles adds the lanes in a
// fixed pattern, and the owner's own partial comes first.
template <typename T>
__global__ void sorted_carry(const int64_t* __restrict__ seg,
                             const T* __restrict__ head,
                             const T* __restrict__ tail,
                             const int* __restrict__ owners,
                             const int* __restrict__ n_owners,
                             T* __restrict__ out, int64_t n, int C,
                             int64_t size) {
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (blockDim.x / 32);
  const int count = *n_owners;
  for (int k = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; k < count;
       k += warps) {
    const int64_t t = owners[k];
    const int64_t r1 = min(n, (t + 1) * kTile);
    const int64_t s = seg[r1 - 1];
    if (s < 0 || s >= size) continue;
    const int64_t last_tile = (segment_end(seg, r1, n, s) - 1) / kTile;
    for (int c = 0; c < C; ++c) {
      T acc = T(0);
      for (int64_t u = t + 1 + lane; u <= last_tile; u += 32)
        acc += head[u * C + c];
      for (int off = 16; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) out[s * C + c] = tail[t * C + c] + acc;
    }
  }
}

template <typename T>
int dense_launch(const T* x, const int64_t* seg, T* part, T* out,
                 long long n, int C, int slots, int blocks,
                 long long rows_per_block, void* stream) {
  if (n <= 0 || blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = sizeof(T) * (size_t)kWarps * ((size_t)slots + 32) * C;
  cudaError_t err = cudaFuncSetAttribute(
      dense_partials<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_partials<T><<<blocks, kThreads, smem, s>>>(
      x, seg, part, out, (int64_t)n, C, slots, (int64_t)rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return (int)err;
  const int entries = slots * C;
  dense_reduce<T><<<(entries + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, out, blocks, entries);
  return (int)cudaGetLastError();
}

template <typename T>
int sorted_launch(const T* x, const int64_t* seg, T* head, T* tail,
                  int* owners, int* n_owners, T* out, long long n, int C,
                  long long size, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long chunks = (tiles + 31) / 32;
  const unsigned grid = (unsigned)((chunks + kWarps - 1) / kWarps);
  const size_t smem =
      (sizeof(int64_t) + sizeof(T)) * (size_t)kWarps * 32 * (kTile + 1);
  cudaError_t err = cudaFuncSetAttribute(
      sorted_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sorted_tiles<T><<<grid, kThreads, smem, s>>>(
      x, seg, out, head, tail, owners, n_owners, (int64_t)n, C,
      (int64_t)tiles, (int64_t)size);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // one warp a listed owner, at most one owner a chunk of 32 tiles each
  const long long carry_blocks = (chunks + kWarps - 1) / kWarps;
  const unsigned carry_grid =
      (unsigned)(carry_blocks < 2048 ? carry_blocks : 2048);
  sorted_carry<T><<<carry_grid, kThreads, 0, s>>>(
      seg, head, tail, owners, n_owners, out, (int64_t)n, C, (int64_t)size);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dense_segment_sum_f32(const float* x, const int64_t* seg,
                                     float* part, float* out, long long n,
                                     int C, int slots, int blocks,
                                     long long rows_per_block, void* stream) {
  return dense_launch<float>(x, seg, part, out, n, C, slots, blocks,
                             rows_per_block, stream);
}

extern "C" int dense_segment_sum_f64(const double* x, const int64_t* seg,
                                     double* part, double* out, long long n,
                                     int C, int slots, int blocks,
                                     long long rows_per_block, void* stream) {
  return dense_launch<double>(x, seg, part, out, n, C, slots, blocks,
                              rows_per_block, stream);
}

extern "C" int sorted_segment_sum_f32(const float* x, const int64_t* seg,
                                      float* head, float* tail, int* owners,
                                      int* n_owners, float* out, long long n,
                                      int C, long long size, void* stream) {
  return sorted_launch<float>(x, seg, head, tail, owners, n_owners, out, n,
                              C, size, stream);
}

extern "C" int sorted_segment_sum_f64(const double* x, const int64_t* seg,
                                      double* head, double* tail,
                                      int* owners, int* n_owners,
                                      double* out, long long n, int C,
                                      long long size, void* stream) {
  return sorted_launch<double>(x, seg, head, tail, owners, n_owners, out, n,
                               C, size, stream);
}
