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
// size below) and by the rows' slot ids, never by timing, so one input
// gives one result. (The integer atomics number the entries of the sorted
// kernel's work list and hand out the dense kernel's tickets; neither
// reaches the order of a sum.)
//
// dense_*: unsorted slot ids into a table small enough for shared memory
//   (a GROUP BY's slots, a tree level's histogram, k-means' clusters), or
//   no ids at all: every row onto one slot (the global sums). One launch a
//   call. The rows are cut into chunks of one 16-byte vector per column
//   (4 float rows, 2 double rows); each block takes a fixed, contiguous
//   range of chunks and its thread t the chunks t, t + 256, ... of it, in
//   order, so a warp reads consecutive 16-byte words, and a thread loads a
//   few chunks ahead of its adds. Three forms (`dense_segment_plan` picks
//   one from (n, size, C, dtype) and whether there are ids):
//   - whole (no ids, C <= 4): each thread adds its chunks' values into C
//     registers, column by column in row order; no id is read.
//   - regs (ids, size * C <= SEGSUM_REG_ENTRIES, C <= 4): each thread keeps
//     its table in registers and adds a row to the slot whose number equals
//     its id, comparing slot by slot; an id outside [0, size) matches none,
//     so neither it nor a NaN it carries reaches a slot.
//     Both end the block with a butterfly of shuffles per entry over the
//     lanes and a fixed pairwise tree over the warps.
//   - table (any other table that fits): a table per warp in shared
//     memory. For each row of its chunk a lane finds the lanes holding the
//     same slot with __match_any_sync; the peers add their values in a
//     pairwise tree by rank (shuffles, log2(peers) steps), and the lowest
//     adds the group's sum to the warp's table. The block adds its warp
//     tables in a fixed pairwise tree. The match, the tree and the
//     __syncwarp that orders one row's table adds before the next row's
//     cost a fixed time a row, which holds this form above the byte bound
//     at two columns (PERF.md section 6).
//   Each block writes its partial table. A table of at most
//   SEGSUM_REG_ENTRIES entries: the last block to finish (an integer
//   ticket) adds them all, a warp an entry, its lanes over the blocks in
//   order, then a butterfly. A larger one: the last block to finish in each
//   group of SEGSUM_GROUP consecutive blocks adds the group's tables in
//   block order, and the last group to finish adds the group tables in
//   group order into the result. The counters come back to 0 within the
//   call, and the wrapper gives each stream its own (ops/kernels.py:
//   _stream_state), so concurrent calls on two streams never share one.
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
// Bound: bytes. Each row's segment id (8 bytes, none in the whole form)
// and its C values are read once and the tables are small, so the card's
// memory rate is the limit (about 0.06 ms for 9.6 M rows and three float32
// columns, 0.012 ms for 10^7 float32 values without ids). The dense kernel
// reads every row as 16-byte vectors with a few chunks in flight a thread;
// the sorted kernel reads each thread's tile from consecutive addresses.

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

#ifndef SEGSUM_REG_ENTRIES
#error "build with -DSEGSUM_REG_ENTRIES (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef SEGSUM_GROUP
#error "build with -DSEGSUM_GROUP (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef SEGSUM_SMEM_BYTES
#error "build with -DSEGSUM_SMEM_BYTES (ops/kernels.py: NVCC_FLAGS)"
#endif
constexpr int kRegEntries = SEGSUM_REG_ENTRIES;
constexpr int kGroup = SEGSUM_GROUP;
constexpr int kSmemBytes = SEGSUM_SMEM_BYTES;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// The dense kernel's forms, numbered as ops/kernels.py:DENSE_FORMS.
enum DenseForm { kWhole = 0, kRegs = 1, kTable = 2 };

// A chunk: the rows of one 16-byte vector per column.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int rows = 4;
  __device__ static void put(const float4& w, float* d) {
    d[0] = w.x;
    d[1] = w.y;
    d[2] = w.z;
    d[3] = w.w;
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int rows = 2;
  __device__ static void put(const double2& w, double* d) {
    d[0] = w.x;
    d[1] = w.y;
  }
};

// The values of chunk k, row j's column c at v[j * C + c] (0 past the
// last row, `rows` of them). A full chunk is read as C 16-byte vectors
// when x allows it; the values, and so the sums, are the same either way.
template <typename T, int C>
__device__ __forceinline__ void load_values(const T* __restrict__ x,
                                            int64_t k, int rows, bool vec,
                                            T (&v)[Vec<T>::rows * C]) {
  constexpr int V = Vec<T>::rows;
  if (vec && rows == V) {
    const typename Vec<T>::type* p =
        reinterpret_cast<const typename Vec<T>::type*>(x + k * V * C);
#pragma unroll
    for (int q = 0; q < C; ++q) Vec<T>::put(__ldg(p + q), v + q * V);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[j * C + c] = j < rows ? __ldg(x + (k * V + j) * C + c) : T(0);
  }
}

// The slot ids of chunk k's rows (-1 past the last row), as V / 2 16-byte
// vectors when the chunk is full and seg allows it.
template <typename T>
__device__ __forceinline__ void load_ids(const int64_t* __restrict__ seg,
                                         int64_t k, int rows, bool vec,
                                         int64_t (&id)[Vec<T>::rows]) {
  constexpr int V = Vec<T>::rows;
  if (vec && rows == V) {
    const longlong2* p = reinterpret_cast<const longlong2*>(seg + k * V);
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      const longlong2 w = __ldg(p + q);
      id[2 * q] = w.x;
      id[2 * q + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) id[j] = j < rows ? __ldg(seg + k * V + j) : -1;
  }
}

// Rows of chunk k (at most V; 0 for a chunk past `end`).
template <typename T>
__device__ __forceinline__ int chunk_rows(int64_t k, int64_t end, int64_t n) {
  constexpr int V = Vec<T>::rows;
  return k < end ? (int)min((int64_t)V, n - k * V) : 0;
}

// The sum of kWarps values src[0], src[stride], ... in a fixed pairwise
// tree.
template <typename T>
__device__ __forceinline__ T warp_tree(const T* src, int stride) {
  T w[kWarps];
#pragma unroll
  for (int i = 0; i < kWarps; ++i) w[i] = src[(size_t)i * stride];
#pragma unroll
  for (int h = 1; h < kWarps; h *= 2)
#pragma unroll
    for (int i = 0; i + h < kWarps; i += 2 * h) w[i] += w[i + h];
  return w[0];
}

// One of `members` blocks that each wrote a table takes a ticket from
// `counter`; true in every thread of the block that came last, which also
// puts the counter back to 0 for the next call on this stream (every
// member has taken its ticket by then).
__device__ bool arrive(unsigned* counter, unsigned members) {
  __shared__ bool last;
  __threadfence();  // this block's table is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == members - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// dst[e] = src[e] + src[entries + e] + ... over `rows` tables, in order,
// read from L2 (other blocks wrote them): a thread an entry.
template <typename T>
__device__ void reduce_rows(const T* src, int rows, int entries, T* dst) {
  for (int e = threadIdx.x; e < entries; e += kThreads) {
    T acc = __ldcg(src + e);
#pragma unroll 4
    for (int r = 1; r < rows; ++r)
      acc += __ldcg(src + (size_t)r * entries + e);
    dst[e] = acc;
  }
}

// The same sum for a small table over many rows: a warp an entry, lane l
// adds rows l, l + 32, ... in order, then a butterfly over the lanes.
template <typename T>
__device__ void reduce_rows_by_lanes(const T* src, int rows, int entries,
                                     T* dst) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < entries; e += kWarps) {
    T acc = T(0);
    for (int r = lane; r < rows; r += 32)
      acc += __ldcg(src + (size_t)r * entries + e);
#pragma unroll
    for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(kFull, acc, m);
    if (lane == 0) dst[e] = acc;
  }
}

// After each block wrote its table to part[block]. A table of at most
// kRegEntries entries: the last block adds every block's table (one
// ticket). A larger one: the last block of each group of kGroup
// consecutive blocks adds the group's tables into gpart[group] (into out
// when there is one group), and the last of those adds the group tables.
template <typename T>
__device__ void finish(const T* part, T* gpart, unsigned* tickets, T* out,
                       int entries) {
  const int blocks = gridDim.x;
  if (entries <= kRegEntries) {
    if (arrive(tickets, blocks))
      reduce_rows_by_lanes(part, blocks, entries, out);
    return;
  }
  const int groups = (blocks + kGroup - 1) / kGroup;
  const int g = blockIdx.x / kGroup;
  const int first = g * kGroup;
  if (!arrive(tickets + g, min(kGroup, blocks - first))) return;
  reduce_rows(part + (size_t)first * entries, min(kGroup, blocks - first),
              entries, groups == 1 ? out : gpart + (size_t)g * entries);
  if (groups == 1 || !arrive(tickets + groups, groups)) return;
  reduce_rows<T>(gpart, groups, entries, out);
}

// The whole (kIds false: every row onto slot 0, no id read) and regs
// forms: a table of S slots x C columns in each thread's registers.
template <typename T, int C, bool kIds>
__global__ void __launch_bounds__(kThreads, 2)
    dense_regs(const T* __restrict__ x, const int64_t* __restrict__ seg,
               T* __restrict__ part, unsigned* __restrict__ tickets,
               T* __restrict__ out, int64_t n, int slots,
               int64_t chunks_per_block, bool vec) {
  constexpr int V = Vec<T>::rows;
  constexpr int S = kIds ? kRegEntries / C : 1;
  constexpr int E = S * C;
  // chunks a thread loads before adding: about 8 vectors in flight
  constexpr int U = kIds ? 2 : (C == 1 ? 8 : 4);
  __shared__ T warp_sums[kWarps * E];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int entries = (kIds ? slots : 1) * C;
  T acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = T(0);

  const int64_t chunks = (n + V - 1) / V;
  const int64_t c0 = (int64_t)blockIdx.x * chunks_per_block;
  const int64_t c1 = min(chunks, c0 + chunks_per_block);
  for (int64_t k = c0 + threadIdx.x; k < c1; k += U * kThreads) {
    T v[U][V * C];
    int64_t id[U][V];
    int rows[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t ku = k + (int64_t)u * kThreads;
      rows[u] = chunk_rows<T>(ku, c1, n);
      if (rows[u] > 0) {
        load_values<T, C>(x, ku, rows[u], vec, v[u]);
        if (kIds) load_ids<T>(seg, ku, rows[u], vec, id[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j >= rows[u]) break;
        if (!kIds) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += v[u][j * C + c];
          continue;
        }
        const int64_t s = id[u][j];
#pragma unroll
        for (int q = 0; q < S; ++q) {
          if (q >= slots) break;
          if (s == q) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[q * C + c] += v[u][j * C + c];
          }
        }
      }
  }

#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e >= entries) break;
    T s = acc[e];
#pragma unroll
    for (int m = 16; m > 0; m /= 2) s += __shfl_xor_sync(kFull, s, m);
    if (lane == 0) warp_sums[warp * E + e] = s;
  }
  __syncthreads();
  const bool one = gridDim.x == 1;
  T* table = one ? out : part + (size_t)blockIdx.x * entries;
  if ((int)threadIdx.x < entries)
    table[threadIdx.x] = warp_tree(warp_sums + threadIdx.x, E);
  if (one) return;
  finish(part, part + (size_t)gridDim.x * entries, tickets, out, entries);
}

// The table form: a table of slots x cols per warp in shared memory.
// C > 0 is the column count, known when compiled; C = 0 takes `cols` at
// run time and reads each value when it adds it.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 2)
    dense_table(const T* __restrict__ x, const int64_t* __restrict__ seg,
                T* __restrict__ part, unsigned* __restrict__ tickets,
                T* __restrict__ out, int64_t n, int cols, int slots,
                int64_t chunks_per_block, bool vec) {
  constexpr int V = Vec<T>::rows;
  constexpr int CV = C > 0 ? C : 1;  // columns held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cc = C > 0 ? C : cols;
  const int entries = slots * cc;
  T* tables = reinterpret_cast<T*>(smem_raw);  // kWarps * entries
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* wt = tables + (size_t)warp * entries;
  for (int i = threadIdx.x; i < kWarps * entries; i += kThreads)
    tables[i] = T(0);
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
  const int64_t chunks = (n + V - 1) / V;
  const int64_t c0 = (int64_t)blockIdx.x * chunks_per_block;
  const int64_t c1 = min(chunks, c0 + chunks_per_block);
  // The lanes of a warp take consecutive chunks, and every lane runs the
  // warp's rounds, so all meet each __match_any_sync. The next round's
  // chunk is loaded before this round's rows are added.
  T v[V * CV], nv[V * CV];
  int64_t id[V], nid[V];
  int64_t k = c0 + warp * 32 + lane;
  int rows = chunk_rows<T>(k, c1, n);
  if (rows > 0) {
    if (C > 0) load_values<T, CV>(x, k, rows, vec, v);
    load_ids<T>(seg, k, rows, vec, id);
  }
  for (int64_t base = c0 + warp * 32; base < c1;
       base += kThreads, k += kThreads) {
    const int nrows = chunk_rows<T>(k + kThreads, c1, n);
    if (nrows > 0) {
      if (C > 0) load_values<T, CV>(x, k + kThreads, nrows, vec, nv);
      load_ids<T>(seg, k + kThreads, nrows, vec, nid);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int s =
          j < rows && id[j] >= 0 && id[j] < slots ? (int)id[j] : -1;
      const unsigned peers = __match_any_sync(kFull, s);
      const int rank = __popc(peers & below);
      const int count = __popc(peers);
      const int most =
          (int)__reduce_max_sync(kFull, s >= 0 ? (unsigned)count : 0u);
      for (int c = 0; c < cc; c += CV) {
        T a[CV];
#pragma unroll
        for (int q = 0; q < CV; ++q)
          a[q] = C > 0 ? v[j * CV + q]
                       : (s >= 0 ? __ldg(x + (k * V + j) * cols + c) : T(0));
        // Peers add in a pairwise tree by rank: at step d the peer of rank
        // r, a multiple of 2d, adds the sum held by the peer of rank r + d,
        // the lowest lane of `up` once the d - 1 lower ones are cleared.
        unsigned up = peers & ~((2u << lane) - 1u);  // the peers above
        for (int d = 1; d < most; d *= 2) {
          for (int i = 0; i < d / 2; ++i) up &= up - 1u;
          const bool take = (rank & (2 * d - 1)) == 0 && rank + d < count;
          const int src = take ? __ffs(up) - 1 : lane;
#pragma unroll
          for (int q = 0; q < CV; ++q) {
            const T o = __shfl_sync(kFull, a[q], src);
            if (take) a[q] += o;
          }
        }
        if (s >= 0 && rank == 0) {
#pragma unroll
          for (int q = 0; q < CV; ++q) wt[s * cc + c + q] += a[q];
        }
      }
      __syncwarp();
    }
    rows = nrows;
#pragma unroll
    for (int i = 0; i < V * CV; ++i) v[i] = nv[i];
#pragma unroll
    for (int i = 0; i < V; ++i) id[i] = nid[i];
  }
  __syncthreads();

  const bool one = gridDim.x == 1;
  T* table = one ? out : part + (size_t)blockIdx.x * entries;
  for (int e = threadIdx.x; e < entries; e += kThreads)
    table[e] = warp_tree(tables + e, entries);
  if (one) return;
  finish(part, part + (size_t)gridDim.x * entries, tickets, out, entries);
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

template <typename T, int C>
cudaError_t launch_regs(bool ids, const T* x, const int64_t* seg, T* part,
                        unsigned* tickets, T* out, long long n, int slots,
                        int blocks, long long chunks_per_block, bool vec,
                        cudaStream_t s) {
  if (ids)
    dense_regs<T, C, true><<<blocks, kThreads, 0, s>>>(
        x, seg, part, tickets, out, (int64_t)n, slots,
        (int64_t)chunks_per_block, vec);
  else
    dense_regs<T, C, false><<<blocks, kThreads, 0, s>>>(
        x, nullptr, part, tickets, out, (int64_t)n, 1,
        (int64_t)chunks_per_block, vec);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_table(const T* x, const int64_t* seg, T* part,
                         unsigned* tickets, T* out, long long n, int cols,
                         int slots, int blocks, long long chunks_per_block,
                         bool vec, cudaStream_t s) {
  // The shared-memory ceiling is raised once per device for each instance,
  // to the most a table that fits (dense_segment_fits) takes: past 48 KB
  // of dynamic and static shared memory together a launch needs it.
  static bool raised[kMaxDevices];
  const size_t smem = sizeof(T) * (size_t)kWarps * slots * cols;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(dense_table<T, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  dense_table<T, C><<<blocks, kThreads, smem, s>>>(
      x, seg, part, tickets, out, (int64_t)n, cols, slots,
      (int64_t)chunks_per_block, vec);
  return cudaGetLastError();
}

// One launch of the form the plan chose. part holds blocks + groups tables
// of slots x C entries; tickets groups + 1 zeroed counters.
template <typename T>
int dense_launch(const T* x, const int64_t* seg, T* part, unsigned* tickets,
                 T* out, long long n, int C, int slots, int form, int blocks,
                 long long chunks_per_block, int vec, void* stream) {
  if (n <= 0 || blocks <= 0) return 0;
  // only the whole form reads no ids
  if (form != kWhole && seg == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool v = vec != 0;
  if (form == kWhole || form == kRegs) {
    const bool ids = form == kRegs;
    switch (C) {
      case 1:
        return (int)launch_regs<T, 1>(ids, x, seg, part, tickets, out, n,
                                      slots, blocks, chunks_per_block, v, s);
      case 2:
        return (int)launch_regs<T, 2>(ids, x, seg, part, tickets, out, n,
                                      slots, blocks, chunks_per_block, v, s);
      case 3:
        return (int)launch_regs<T, 3>(ids, x, seg, part, tickets, out, n,
                                      slots, blocks, chunks_per_block, v, s);
      case 4:
        return (int)launch_regs<T, 4>(ids, x, seg, part, tickets, out, n,
                                      slots, blocks, chunks_per_block, v, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (form != kTable) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1:
      return (int)launch_table<T, 1>(x, seg, part, tickets, out, n, C, slots,
                                     blocks, chunks_per_block, v, s);
    case 2:
      return (int)launch_table<T, 2>(x, seg, part, tickets, out, n, C, slots,
                                     blocks, chunks_per_block, v, s);
    case 3:
      return (int)launch_table<T, 3>(x, seg, part, tickets, out, n, C, slots,
                                     blocks, chunks_per_block, v, s);
    case 4:
      return (int)launch_table<T, 4>(x, seg, part, tickets, out, n, C, slots,
                                     blocks, chunks_per_block, v, s);
    default:
      return (int)launch_table<T, 0>(x, seg, part, tickets, out, n, C, slots,
                                     blocks, chunks_per_block, v, s);
  }
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

// The launch's arguments that follow from its plan alone, built once a
// plan (ops/kernels.py: _DenseArgs): rows, chunks a block, columns, slots,
// the form, blocks, and the bytes of ticket counters at the head of the
// stream's scratch, whose partial tables follow them.
struct DenseArgs {
  long long n;
  long long chunks_per_block;
  int C;
  int slots;
  int form;
  int blocks;
  long long ticket_bytes;
};

extern "C" int dense_segment_sum_f32(const float* x, const int64_t* seg,
                                     void* scratch, float* out,
                                     const DenseArgs* a, int vec,
                                     void* stream) {
  return dense_launch<float>(
      x, seg, reinterpret_cast<float*>((char*)scratch + a->ticket_bytes),
      (unsigned*)scratch, out, a->n, a->C, a->slots, a->form, a->blocks,
      a->chunks_per_block, vec, stream);
}

extern "C" int dense_segment_sum_f64(const double* x, const int64_t* seg,
                                     void* scratch, double* out,
                                     const DenseArgs* a, int vec,
                                     void* stream) {
  return dense_launch<double>(
      x, seg, reinterpret_cast<double*>((char*)scratch + a->ticket_bytes),
      (unsigned*)scratch, out, a->n, a->C, a->slots, a->form, a->blocks,
      a->chunks_per_block, vec, stream);
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
