// The two-stage Gramian plan shared by packed_gram.cu and masked_gram.cu,
// for Hopper (sm_90a).
//
// Both kernels compute A = Zw^T Zw for a design whose row r is
// Zw[r, :] = design.at(r, c) for c < D; they differ only in how a row is
// read (a Design type with `at(r, c)` and `row<MAXD>(r, z)`):
//   * packed_gram: Z is (n, D) in memory, already masked;
//   * masked_gram: z = [x, y, 1] * w, read from X (n, d), y (n) and w (n)
//     and formed in registers, never in global memory.
//
// The TPU kernels carry their sum from one sequential grid step to the
// next. Blocks on a GPU run in parallel and in no order, so the sum is taken
// in two deterministic stages with no atomics (cross-validation subtracts
// Gramians, so a result must be the same bits on every run):
//   1. one block per (output tile, row chunk) writes the chunk's partial
//      Gramian to part[chunk, :, :];
//   2. one thread per element of A adds the partials in chunk order.
// The caller (ops/kernels.py:gram_plan) bounds the chunk count so that
// `part` stays small at D = 514.
//
// Stage 1 has two forms, split at GRAM_SMALL_MAX_D (4, set on the nvcc
// command line by ops/kernels.py, whose chunk plan depends on it too):
//   * D <= GRAM_SMALL_MAX_D (the app's D = 3): each thread keeps the whole
//     D x D sum of its rows in registers, then the block reduces with warp
//     shuffles and a fixed-order sum over warps.
//   * larger D: 64 x 64 output tiles; 16-row slabs of the two column panels
//     are staged in shared memory and each thread accumulates a 4 x 4 block
//     of outputs. Sums of 16 slabs are added to the running total as one
//     term, which keeps the float32 rounding error of a long chunk small.
//
// Accumulation is in the input type (float or double), as in the reference.
// Tensor cores are not used: TF32 would break parity with the float32
// reference.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GRAM_SMALL_MAX_D
#error "build with -DGRAM_SMALL_MAX_D=<n> (ops/kernels.py passes it)"
#endif

namespace gram {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kRows = 16;
constexpr int kSlabsPerBlock = 16;

template <typename T, int MAXD, typename Design>
__global__ void __launch_bounds__(kThreads)
gram_small_kernel(Design design, T* __restrict__ part, int64_t n, int D,
                  int64_t rows_per_chunk) {
  const int64_t begin = (int64_t)blockIdx.x * rows_per_chunk;
  const int64_t end = begin + rows_per_chunk < n ? begin + rows_per_chunk : n;
  T acc[MAXD][MAXD];
#pragma unroll
  for (int a = 0; a < MAXD; ++a)
#pragma unroll
    for (int b = 0; b < MAXD; ++b) acc[a][b] = T(0);

  for (int64_t r = begin + threadIdx.x; r < end; r += kThreads) {
    T z[MAXD];
    design.template row<MAXD>(r, z);
#pragma unroll
    for (int a = 0; a < MAXD; ++a)
#pragma unroll
      for (int b = 0; b < MAXD; ++b) acc[a][b] += z[a] * z[b];
  }

  __shared__ T red[kThreads / 32][MAXD * MAXD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < MAXD; ++a)
#pragma unroll
    for (int b = 0; b < MAXD; ++b) {
      T v = acc[a][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][a * MAXD + b] = v;
    }
  __syncthreads();
  if (threadIdx.x < D * D) {
    const int a = threadIdx.x / D;
    const int b = threadIdx.x % D;
    T s = T(0);
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][a * MAXD + b];
    part[(int64_t)blockIdx.x * D * D + threadIdx.x] = s;
  }
}

template <typename T, typename Design>
__global__ void __launch_bounds__(kThreads)
gram_tiled_kernel(Design design, T* __restrict__ part, int64_t n, int D,
                  int64_t rows_per_chunk) {
  __shared__ T As[kRows][kTile];
  __shared__ T Bs[kRows][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int64_t begin = (int64_t)blockIdx.z * rows_per_chunk;
  const int64_t end = begin + rows_per_chunk < n ? begin + rows_per_chunk : n;

  T acc[4][4], blk[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = blk[u][v] = T(0);

  int slab = 0;
  for (int64_t r0 = begin; r0 < end; r0 += kRows) {
    for (int e = threadIdx.x; e < kRows * kTile; e += kThreads) {
      const int rr = e / kTile;
      const int cc = e % kTile;
      const int64_t r = r0 + rr;
      const bool row_ok = r < end;
      As[rr][cc] = (row_ok && i0 + cc < D) ? design.at(r, i0 + cc) : T(0);
      Bs[rr][cc] = (row_ok && j0 + cc < D) ? design.at(r, j0 + cc) : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      T a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = As[k][ty + 16 * u];
        b[u] = Bs[k][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) blk[u][v] += a[u] * b[v];
    }
    __syncthreads();
    if (++slab == kSlabsPerBlock) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[u][v] += blk[u][v];
          blk[u][v] = T(0);
        }
      slab = 0;
    }
  }

  T* out = part + (int64_t)blockIdx.z * D * D;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ty + 16 * u;
      const int j = j0 + tx + 16 * v;
      if (i < D && j < D) out[(int64_t)i * D + j] = acc[u][v] + blk[u][v];
    }
}

template <typename T>
__global__ void reduce_chunks_kernel(const T* __restrict__ part,
                                     T* __restrict__ out, int chunks,
                                     int64_t dd) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < dd;
       e += stride) {
    T s = T(0);
    for (int c = 0; c < chunks; ++c) s += part[(int64_t)c * dd + e];
    out[e] = s;
  }
}

// Both stages on `stream`; returns a cudaError_t (0 on success).
template <typename T, typename Design>
int launch(Design design, T* part, T* out, long long n, int D, int chunks,
           long long rows_per_chunk, void* stream) {
  if (n <= 0 || D <= 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= GRAM_SMALL_MAX_D) {
    gram_small_kernel<T, GRAM_SMALL_MAX_D, Design><<<chunks, kThreads, 0, s>>>(
        design, part, n, D, rows_per_chunk);
  } else {
    const unsigned tiles = (unsigned)((D + kTile - 1) / kTile);
    dim3 grid(tiles, tiles, (unsigned)chunks);
    gram_tiled_kernel<T, Design><<<grid, kThreads, 0, s>>>(
        design, part, n, D, rows_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long dd = (long long)D * D;
  long long blocks = (dd + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  reduce_chunks_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(part, out, chunks,
                                                           (int64_t)dd);
  return (int)cudaGetLastError();
}

}  // namespace gram
