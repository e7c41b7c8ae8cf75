// The Gramian plan shared by packed_gram.cu and masked_gram.cu, for Hopper
// (sm_90a).
//
// Both kernels compute A = Zw^T Zw, (D, D), for a design Zw of n rows; they
// differ only in how a row is read (a Design type, see the two .cu files):
//   * packed_gram: Z is (n, D) in memory, already masked;
//   * masked_gram: z = [x, y, 1] * w, read from X (n, d), y (n) and w (n);
//     Z is never written to global memory.
//
// The TPU kernels carry their sum from one sequential grid step to the
// next. Blocks on a GPU run in parallel and in no order, so the rows are
// cut into chunks (ops/kernels.py:gram_plan) and the sum is taken with no
// atomics, in a fixed order (cross-validation subtracts Gramians, so a
// result must be the same bits on every run):
//   1. one block per (output tile, row chunk) sums its chunk. With one
//      chunk it writes A itself, mirrored, and nothing else is launched;
//      otherwise it writes the chunk's partial Gramian to part[chunk];
//   2. (several chunks only) one warp per entry (i <= j) of A: lane l adds
//      chunks l, l + 32, ... in order, a fixed shuffle tree adds the lanes,
//      and the sum is written to (i, j) and (j, i).
// A is symmetric, so only tiles and entries with i <= j are computed, and
// the result is symmetric bit for bit.
//
// Stage 1 has two forms, split at GRAM_SMALL_MAX_D (4, set on the nvcc
// command line by ops/kernels.py, whose chunk plan depends on it too):
//   * D <= GRAM_SMALL_MAX_D (the app's D = 3): each thread keeps the whole
//     D x D sum of its rows in registers, then the block reduces with warp
//     shuffles and a fixed-order sum over warps. Memory bounds it.
//   * larger D: GRAM_TILE x GRAM_TILE output tiles of the upper triangle,
//     T (T + 1) / 2 of them for T = ceil(D / GRAM_TILE), a closed form
//     mapping the block index to the tile (upper_index). Without tensor
//     cores (TF32 would break float32 parity) the float32 FFMA rate bounds
//     it, so the tile is an SGEMM-like one:
//       - each thread holds a TM x TM block of outputs (8 x 8 in float,
//         4 x 4 in double) and reads its row and column fragments from the
//         slab as 16-byte vectors, two per side, half a tile apart, so
//         that the lanes of a warp read consecutive 16-byte words (no bank
//         conflicts) and each 16-byte read feeds TM FFMAs per value;
//       - slabs of 16 rows (8 in double) of the two column panels (one
//         panel on a diagonal tile) are copied into shared memory with
//         cp.async, 16 bytes at a time where the row stride and the
//         pointer allow (8 or 4 bytes otherwise), in three stages: while
//         slab k is multiplied, slab k + 1 is scaled (masked_gram) and
//         slab k + 2 is in flight, with one barrier a slab; the ragged row
//         and column edges are zero-filled by the copy itself;
//       - masked_gram copies raw X and reads the slab's w and y one slab
//         ahead; the block then scales the slab by w in place, 16 bytes at
//         a time, and fills the y and 1 columns: z * w is formed once per
//         element, as the plain version forms it, with no branch in the
//         multiply loop;
//       - sums of 256 rows are added to the running total as one term,
//         which keeps the float32 rounding error of a chunk of tens of
//         thousands of rows small.
//     GRAM_TILE = 64 (from ops/kernels.py). At D = 514 a 64-wide tile
//     computes 45 tiles, 72% of their entries inside the triangle, against
//     15 tiles and 54% for a 128-wide one; a 128-wide tile of 8 x 8 blocks
//     also needs 256 threads of about 255 registers, one block an SM, so
//     each barrier stalls the whole SM. PERF.md has the times.
//
// Accumulation is in the input type (float or double), as in the reference.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GRAM_SMALL_MAX_D
#error "build with -DGRAM_SMALL_MAX_D=<n> (ops/kernels.py passes it)"
#endif
#ifndef GRAM_TILE
#error "build with -DGRAM_TILE=<n> (ops/kernels.py passes it)"
#endif

namespace gram {

constexpr int kThreads = 256;      // small kernel and chunk reduce
constexpr int kTile = GRAM_TILE;
constexpr int kStages = 3;         // slabs in shared memory at a time
constexpr int kBlockRows = 256;    // rows of one term of the running sum

// Linear index b of the upper triangle, column by column
// (b = j (j + 1) / 2 + i with 0 <= i <= j), to (i, j). ops/kernels.py:
// gram_tiles mirrors it.
__device__ __forceinline__ void upper_index(int64_t b, int& i, int& j) {
  int64_t c = (int64_t)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
  while ((c + 1) * (c + 2) / 2 <= b) ++c;
  while (c * (c + 1) / 2 > b) --c;
  j = (int)c;
  i = (int)(b - c * (c + 1) / 2);
}

// Writes all D x D entries of the block's sum to dst + blockIdx.x * D * D
// (A itself when there is one chunk).
template <typename T, int MAXD, typename Design>
__global__ void __launch_bounds__(kThreads)
gram_small_kernel(Design design, T* __restrict__ dst, int64_t n, int D,
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
    dst[(int64_t)blockIdx.x * D * D + threadIdx.x] = s;
  }
}

// cp.async of CB bytes, zero-filled when !ok (then nothing is read).
template <int CB>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src = ok ? CB : 0;
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(CB), "r"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The V = 16 / sizeof(T) values at p (16-byte aligned) into v.
template <typename T>
__device__ __forceinline__ void load16(const T* p, T* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const T* v) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

template <typename T>
struct TileShape {
  static constexpr int TM = sizeof(T) == 4 ? 8 : 4;   // outputs a thread
  static constexpr int TPD = kTile / TM;              // threads a side
  static constexpr int NT = TPD * TPD;                // threads a block
  static constexpr int V = 16 / (int)sizeof(T);       // values a fragment
  static constexpr int NG = TM / V;                   // fragments a side
  static constexpr int GS = kTile / NG;               // fragment spacing
  static constexpr int R = sizeof(T) == 4 ? 16 : 8;   // rows a slab
  static constexpr int SPB = kBlockRows / R;          // slabs a block sum
};

// Grid (T (T + 1) / 2, chunks). Writes the entries i <= j of its tile to
// dst + blockIdx.y * D * D, and also (j, i) when `mirror` (one chunk: dst
// is A). CB is the width of one copy in bytes.
template <typename T, int CB, typename Design>
__global__ void __launch_bounds__(TileShape<T>::NT)
gram_tiled_kernel(Design design, T* __restrict__ dst, int64_t n, int D,
                  int64_t rows_per_chunk, bool mirror) {
  using S = TileShape<T>;
  constexpr int TM = S::TM, NT = S::NT, V = S::V, NG = S::NG, GS = S::GS;
  constexpr int R = S::R;
  constexpr int E = CB / (int)sizeof(T);       // values a copy
  constexpr int CPR = kTile / E;               // copies a slab row
  constexpr int COPIES = R * CPR / NT;         // copies a thread a panel
  static_assert(R * CPR % NT == 0, "copies must divide evenly");
  static_assert(R * kTile % (V * NT) == 0, "slab must divide evenly");

  __shared__ __align__(16) T As[kStages][R][kTile];
  __shared__ __align__(16) T Bs[kStages][R][kTile];
  __shared__ T ws[kStages][R];
  __shared__ T ys[kStages][R];

  int ti, tj;
  upper_index(blockIdx.x, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / S::TPD;
  const int tx = tid % S::TPD;
  const int64_t begin = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t end = begin + rows_per_chunk < n ? begin + rows_per_chunk : n;
  const int slabs = (int)((end - begin + R - 1) / R);
  const T* src = design.src();
  const int ld = design.ld();   // row stride of src and its column count

  // Issues the copies of slab `slab` into stage `st` as one group (an
  // empty group past the last slab, so that the waits stay uniform).
  auto load = [&](int slab, int st) {
    if (slab < slabs) {
      const int64_t r0 = begin + (int64_t)slab * R;
#pragma unroll
      for (int k = 0; k < COPIES; ++k) {
        const int idx = tid + k * NT;
        const int rr = idx / CPR;
        const int cc = (idx % CPR) * E;
        const int64_t r = r0 + rr;
        const bool row_ok = r < end;
        const T* row = src + (row_ok ? r : 0) * (int64_t)ld;
        const bool a_ok = row_ok && i0 + cc < ld;
        copy_async<CB>(&As[st][rr][cc], a_ok ? row + i0 + cc : src, a_ok);
        if (!diag) {
          const bool b_ok = row_ok && j0 + cc < ld;
          copy_async<CB>(&Bs[st][rr][cc], b_ok ? row + j0 + cc : src, b_ok);
        }
      }
    }
    copy_commit();
  };

  // masked_gram: a slab's w and y, read into registers while the slab
  // before it is multiplied, then stored beside the slab.
  T w_next = T(0), y_next = T(0);
  auto fetch_wy = [&](int slab) {
    if constexpr (Design::kScaled) {
      const int64_t r = begin + (int64_t)slab * R + tid;
      const bool ok = tid < R && r < end;
      w_next = ok ? design.weight(r) : T(0);
      y_next = ok ? design.label(r) : T(0);
    }
  };
  auto store_wy = [&](int st) {
    if constexpr (Design::kScaled) {
      if (tid < R) {
        ws[st][tid] = w_next;
        ys[st][tid] = y_next;
      }
    }
  };
  // z * w in place: X's columns scaled, then y and 1 in columns d, d + 1.
  auto scale_panel = [&](T (*P)[kTile], int c0, int st) {
    const int d = ld;
    const bool edge = c0 + kTile > d;
#pragma unroll
    for (int k = 0; k < R * kTile / (V * NT); ++k) {
      const int q = tid + k * NT;
      const int rr = q / (kTile / V);
      const int cc = q % (kTile / V) * V;
      const T wr = ws[st][rr];
      T v[V];
      load16(&P[rr][cc], v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (edge) {
          const int c = c0 + cc + e;
          v[e] = c < d ? v[e]
                       : (c == d ? ys[st][rr] : (c == d + 1 ? T(1) : T(0)));
        }
        v[e] *= wr;
      }
      store16(&P[rr][cc], v);
    }
  };
  auto scale = [&](int slab, int st) {
    if constexpr (Design::kScaled) {
      if (slab < slabs) {
        scale_panel(As[st], i0, st);
        if (!diag) scale_panel(Bs[st], j0, st);
      }
    }
  };

  T acc[TM][TM], blk[TM][TM];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TM; ++v) acc[u][v] = blk[u][v] = T(0);

  // Slab k sits in stage k % 3. While slab k is multiplied, slab k + 1 is
  // scaled (masked_gram) and slab k + 2 is in flight: one barrier a slab.
  fetch_wy(0);
  store_wy(0);
  load(0, 0);
  fetch_wy(1);
  store_wy(1);
  load(1, 1);
  copy_wait<1>();
  __syncthreads();
  scale(0, 0);
  int in_block = 0;
  for (int slab = 0; slab < slabs; ++slab) {
    const int st = slab % kStages;
    const int st1 = (slab + 1) % kStages;
    const int st2 = (slab + 2) % kStages;
    copy_wait<0>();
    __syncthreads();
    fetch_wy(slab + 2);
    load(slab + 2, st2);
    scale(slab + 1, st1);
    const T* Ap = &As[st][0][ty * V];
    const T* Bp = (diag ? &As[st][0][0] : &Bs[st][0][0]) + tx * V;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      T a[TM], b[TM];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        load16(Ap + k * kTile + g * GS, a + g * V);
        load16(Bp + k * kTile + g * GS, b + g * V);
      }
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TM; ++v) blk[u][v] += a[u] * b[v];
    }
    store_wy(st2);
    if (++in_block == S::SPB) {
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TM; ++v) {
          acc[u][v] += blk[u][v];
          blk[u][v] = T(0);
        }
      in_block = 0;
    }
  }

  T* out = dst + (int64_t)blockIdx.y * D * D;
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TM; ++v) {
      const int i = i0 + (u / V) * GS + ty * V + u % V;
      const int j = j0 + (v / V) * GS + tx * V + v % V;
      if (i <= j && j < D) {
        const T s = acc[u][v] + blk[u][v];
        out[(int64_t)i * D + j] = s;
        if (mirror) out[(int64_t)j * D + i] = s;
      }
    }
}

// Stage 2: one warp per entry i <= j of A, over the `chunks` partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_chunks_kernel(const T* __restrict__ part, T* __restrict__ out,
                     int chunks, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t dd = (int64_t)D * D;
  const int64_t entries = (int64_t)D * (D + 1) / 2;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t e = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       e < entries; e += warps) {
    int i, j;
    upper_index(e, i, j);
    const T* p = part + (int64_t)i * D + j;
    T s = T(0);
    for (int c = lane; c < chunks; c += 32) s += p[(int64_t)c * dd];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) {
      out[(int64_t)i * D + j] = s;
      out[(int64_t)j * D + i] = s;
    }
  }
}

template <typename T, int CB, typename Design>
void launch_tiled(Design design, T* dst, long long n, int D, int chunks,
                  long long rows_per_chunk, cudaStream_t s) {
  const long long tiles = (D + kTile - 1) / kTile;
  dim3 grid((unsigned)(tiles * (tiles + 1) / 2), (unsigned)chunks);
  gram_tiled_kernel<T, CB, Design><<<grid, TileShape<T>::NT, 0, s>>>(
      design, dst, n, D, rows_per_chunk, chunks == 1);
}

// Stage 1 on `stream`, and stage 2 when chunks > 1 (`part` holds chunks
// D x D partials then; it is not touched when chunks == 1). Returns a
// cudaError_t (0 on success).
template <typename T, typename Design>
int launch(Design design, T* part, T* out, long long n, int D, int chunks,
           long long rows_per_chunk, void* stream) {
  if (n <= 0 || D <= 0 || chunks <= 0 || (chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  T* dst = chunks == 1 ? out : part;
  if (D <= GRAM_SMALL_MAX_D) {
    gram_small_kernel<T, GRAM_SMALL_MAX_D, Design><<<chunks, kThreads, 0, s>>>(
        design, dst, n, D, rows_per_chunk);
  } else {
    // The widest copy that the pointer and the row stride allow.
    const uintptr_t at = (uintptr_t)design.src();
    const long long stride = (long long)design.ld() * (long long)sizeof(T);
    if (at % 16 == 0 && stride % 16 == 0)
      launch_tiled<T, 16>(design, dst, n, D, chunks, rows_per_chunk, s);
    else if (sizeof(T) == 8 || (at % 8 == 0 && stride % 8 == 0))
      launch_tiled<T, 8>(design, dst, n, D, chunks, rows_per_chunk, s);
    else
      launch_tiled<T, (sizeof(T) == 4 ? 4 : 8)>(design, dst, n, D, chunks,
                                                rows_per_chunk, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const long long entries = (long long)D * (D + 1) / 2;
  long long blocks = (entries + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 8192) blocks = 8192;
  reduce_chunks_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(part, out,
                                                                chunks, D);
  return (int)cudaGetLastError();
}

}  // namespace gram
