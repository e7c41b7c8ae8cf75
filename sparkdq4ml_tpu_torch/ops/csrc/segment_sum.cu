// Fixed-order segment sums for Hopper (sm_90a): the float sums of the
// grouped engine (sparkdq4ml_tpu_torch/ops/segments.py, `_seg_sum`).
//
// A port-only kernel: it replaces no Pallas TPU kernel. The JAX package
// sums groups with `jax.ops.segment_sum` (sparkdq4ml_tpu/ops/segments.py),
// an XLA scatter that gives one answer for one input. torch's `index_add_`
// adds float atomics in no fixed order on the card, so a GROUP BY sum, and
// every comparison with it, could change from run to run. Neither kernel
// here adds a float with an atomic: each sum runs in an order set by the
// launch plan (`ops/kernels.py: dense_segment_plan`, `sorted_segment_plan`)
// and by the rows' slot ids, never by timing, so one input gives one
// result. (The one integer atomic hands out both kernels' tickets; it
// decides which block adds the partials, never the order of a sum.)
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
//   segments are contiguous after the stable sort; a table past the dense
//   kernel's shared memory after a stable sort of its ids), any number of
//   columns. One launch a call (ops/kernels.py: sorted_segment_plan). Each
//   block takes a fixed, contiguous range of rows and reads it once, in
//   stages: the stage's ids and its rows' values (all columns, one flat
//   span) are copied into shared memory with cp.async, as 16-byte vectors
//   where both inputs lie on the 16-byte grid and value by value where a
//   view does not, while the stage before is added (two stage buffers).
//   Rows wider than a stage's share of a thread are read in slabs of
//   columns, the range once a slab, so that shared memory does not grow
//   with the column count. In a stage, thread t
//   adds rows t * K .. t * K + K - 1 in row order (K odd, so that the lanes
//   read different banks) and writes a run that starts and ends among them
//   straight to its slot. A scan by segments over the threads (shuffles by
//   doubling distance over the lanes, then the warps in order) adds the
//   threads' parts of a run that crosses threads; the thread where the run
//   ends writes it, and the stage's last run is carried to the next stage
//   in shared memory. Only a run that crosses the block's two edges leaves
//   the block: its first run, when it began in the block before, and its
//   last, when it goes on into the next, as two partials in the stream's
//   scratch. The last block to finish (an integer ticket, as in the dense
//   kernel) adds each crossing run's partials in block order with the same
//   scan over the blocks and writes its slot. Empty slots: where the
//   output has few bytes beside the rows', each block first writes zeros
//   over its own slots, from past the id before its first row to its last
//   id (from slot 0 in the first block, to the last slot in the last), and
//   the sums over them after a barrier; where it has many (sparse ids, as
//   PIC's affinity), a memset on the stream before the launch zeroes it,
//   at the card's whole rate where a few blocks would zero long gaps alone.
//   A segment id outside [0, size) is never written (memory stays safe
//   whatever the ids; ids that decrease give wrong sums, not faults).
//
// Bound: bytes. Each row's segment id (8 bytes, none in the whole form)
// and its C values are read once and the tables are small, so the card's
// memory rate is the limit (about 0.06 ms for 9.6 M rows and three float32
// columns, 0.012 ms for 10^7 float32 values without ids; for the sorted
// kernel the output's bytes too, 64 MiB for PIC's 16.8 M slots). The dense
// kernel reads every row as 16-byte vectors with a few chunks in flight a
// thread; the sorted kernel keeps one stage in flight a block, two blocks
// an SM, in float32 and float64 and at any column count alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The plan's constants come from ops/kernels.py through nvcc flags, where
// the Python side sizes the scratch buffers from the same values.
#ifndef SEGSUM_WARPS
#error "build with -DSEGSUM_WARPS (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef SEGSUM_STAGE_BYTES
#error "build with -DSEGSUM_STAGE_BYTES (ops/kernels.py: NVCC_FLAGS)"
#endif
#ifndef SEGSUM_SORTED_SMEM_BYTES
#error "build with -DSEGSUM_SORTED_SMEM_BYTES (ops/kernels.py: NVCC_FLAGS)"
#endif
constexpr int kWarps = SEGSUM_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kStageBytes = SEGSUM_STAGE_BYTES;
constexpr int kSortedSmemBytes = SEGSUM_SORTED_SMEM_BYTES;

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

// cp.async: copies from global to shared memory that the thread does not
// wait for. copy16 reads `bytes` (at most 16) and fills the rest of the 16
// with zeros; copy_one reads one value of B bytes.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
template <int B>
__device__ __forceinline__ void copy_one(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "n"(B)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows a thread of the sorted kernel adds in one stage at C columns known
// when compiled: as many as fill a stage of kStageBytes, made odd. The
// plan (ops/kernels.py: sorted_segment_plan) computes the same number.
template <typename T, int C>
__host__ __device__ constexpr int sorted_rows_per_thread() {
  const int k =
      kStageBytes / (kThreads * (int)(sizeof(int64_t) + C * sizeof(T)));
  return k < 1 ? 1 : (k % 2 ? k : k - 1);
}

// The first slot past id s, in [0, size].
__device__ __forceinline__ int64_t slot_after(int64_t s, int64_t size) {
  return s < 0 ? 0 : (s >= size ? size : s + 1);
}

// Copies rows [a, a + rows) of columns [c0, c0 + w) into a stage buffer:
// their ids first, then, after stage_rows ids, their values, w a row. With
// `vec` (both inputs on the 16-byte grid; a is a multiple of 16 / sizeof(T)
// rows, so both spans start on it) the ids as 16-byte vectors, and the
// values too when the stage holds whole rows (one flat span); else value
// by value. One commit group.
template <typename T>
__device__ void stage_copy(unsigned char* buf, int stage_rows,
                           const T* __restrict__ x,
                           const int64_t* __restrict__ seg, int64_t a,
                           int rows, int cols, int c0, int w, bool vec) {
  int64_t* ids = reinterpret_cast<int64_t*>(buf);
  T* vals = reinterpret_cast<T*>(buf + (size_t)stage_rows * sizeof(int64_t));
  const int count = rows * w;
  if (vec) {
    const char* gi = reinterpret_cast<const char*>(seg + a);
    const int ib = rows * (int)sizeof(int64_t);
    for (int o = 16 * threadIdx.x; o < ib; o += 16 * kThreads)
      copy16(reinterpret_cast<char*>(ids) + o, gi + o, min(16, ib - o));
  } else {
    for (int i = threadIdx.x; i < rows; i += kThreads)
      copy_one<8>(ids + i, seg + a + i);
  }
  if (vec && w == cols) {
    const char* gv = reinterpret_cast<const char*>(x + a * cols);
    const int vb = count * (int)sizeof(T);
    for (int o = 16 * threadIdx.x; o < vb; o += 16 * kThreads)
      copy16(reinterpret_cast<char*>(vals) + o, gv + o, min(16, vb - o));
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const int r = i / w;
      copy_one<(int)sizeof(T)>(vals + i, x + (a + r) * cols + c0 + i - r * w);
    }
  }
  copy_commit();
}

// An inclusive scan by segments of G values a thread over the block's
// threads in thread order: a segment starts at each thread whose `start`
// is set, and the threads before the first start go on from `carry` (0
// when null). On return v holds the sum of its segment up to this thread,
// and prev the same for the thread before (for thread 0 the carry). The
// lanes add by doubling distance, five steps of shuffles, then each thread
// folds the warps before its own in order: one fixed order of adds. Every
// thread of the block calls it; s_warp and s_start are read again until
// the caller's next barrier.
template <typename T, int G>
__device__ void segmented_scan(bool start, T (&v)[G], T (&prev)[G],
                               const T* carry, T* s_warp, bool* s_start) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned starts = __ballot_sync(kFull, start);
  const unsigned upto = starts & (kFull >> (31 - lane));  // lanes <= lane
  const int first = upto ? 31 - __clz(upto) : 0;  // this segment's first lane
#pragma unroll
  for (int d = 1; d < 32; d *= 2)
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const T o = __shfl_up_sync(kFull, v[q], d);
      if (lane - d >= first) v[q] = o + v[q];
    }
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < G; ++q) s_warp[warp * G + q] = v[q];
    s_start[warp] = starts != 0;
  }
  __syncthreads();
  T p[G];
#pragma unroll
  for (int q = 0; q < G; ++q) p[q] = carry ? carry[q] : T(0);
  for (int w = 0; w < warp; ++w) {
    const bool restart = s_start[w];
#pragma unroll
    for (int q = 0; q < G; ++q)
      p[q] = restart ? s_warp[w * G + q] : p[q] + s_warp[w * G + q];
  }
  if (upto == 0)
#pragma unroll
    for (int q = 0; q < G; ++q) v[q] = p[q] + v[q];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const T o = __shfl_up_sync(kFull, v[q], 1);
    prev[q] = lane > 0 ? o : p[q];
  }
}

// Columns a thread adds together when the count is known only at run
// time: one pass over the stage's rows for each group of them.
constexpr int kSortedGroup = 4;

// The sorted kernel (see the head of this file). C > 0 is the column count,
// known when compiled; C = 0 takes `cols` at run time, and a stage holds
// `width` of them (all, or a slab of them: the block then reads its rows
// once a slab, its ids again each time). part holds two partials of cols
// values a block (the head, then the tail); the dynamic shared memory two
// stage buffers of stage_rows rows of width values, then two carries of
// width values rounded up to whole groups. With `zero` the block writes
// the zeros of its empty slots (else a memset before the launch did).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 2)
    sorted_segments(const T* __restrict__ x, const int64_t* __restrict__ seg,
                    T* __restrict__ part, unsigned* __restrict__ ticket,
                    T* __restrict__ out, int64_t n, int64_t size, int cols,
                    int width, int64_t rows_per_block, int stage_rows,
                    int per_thread, bool zero, bool vec) {
  constexpr int G = C > 0 ? C : kSortedGroup;
  constexpr int KC = C > 0 ? sorted_rows_per_thread<T, C>() : 1;
  const int cc = C > 0 ? C : cols;
  const int wd = C > 0 ? C : width;
  const int K = C > 0 ? KC : per_thread;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_warp[kWarps * G];
  __shared__ bool s_start[kWarps];
  __shared__ int64_t s_carry_id[2];
  const size_t stage_bytes =
      (size_t)stage_rows * (sizeof(int64_t) + (size_t)wd * sizeof(T));
  const int carry_len = (wd + G - 1) / G * G;
  T* s_carry = reinterpret_cast<T*>(smem_raw + 2 * stage_bytes);

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(n, r0 + rows_per_block);
  const int stages = (int)((r1 - r0 + stage_rows - 1) / stage_rows);
  const int slabs = C > 0 ? 1 : (cc + wd - 1) / wd;  // one at C known
  const int steps = stages * slabs;
  // Step t (stage t % stages of slab t / stages) into its buffer of the
  // two, one commit group (an empty one past the last step, so that the
  // groups count the steps).
  auto issue = [&](int t) {
    if (t < steps) {
      const int slab = slabs == 1 ? 0 : t / stages;
      const int64_t a = r0 + (int64_t)(t - slab * stages) * stage_rows;
      stage_copy<T>(smem_raw + (t & 1) * stage_bytes, stage_rows, x, seg, a,
                    (int)min((int64_t)stage_rows, r1 - a), cc, slab * wd,
                    min(wd, cc - slab * wd), vec);
    } else {
      copy_commit();
    }
  };
  issue(0);  // one step ahead

  // The block's first id, and whether its first run began in the block
  // before (then the run leaves as the head partial). Its slots, zeroed
  // before any sum is written: from past the id before its first row to
  // its last id, clipped to [0, size); slot 0 on in the first block, to the
  // last slot in the last.
  const int64_t first = __ldg(seg + r0);
  const int64_t before = r0 > 0 ? __ldg(seg + r0 - 1) : 0;
  const int64_t after = r1 < n ? __ldg(seg + r1) : 0;  // for the block's end
  const bool open_start = r0 > 0 && before == first;
  if (zero) {  // as 16-byte vectors between a ragged head and tail
    const int64_t lo = r0 > 0 ? slot_after(before, size) : 0;
    const int64_t hi = r1 < n ? slot_after(__ldg(seg + r1 - 1), size) : size;
    constexpr int V = Vec<T>::rows;
    T* z = out + lo * cc;
    const int64_t count = hi > lo ? (hi - lo) * cc : 0;
    const int64_t head = min(
        count, (int64_t)(((16 - ((size_t)z & 15)) & 15) / sizeof(T)));
    const int64_t body = (count - head) / V;
    typename Vec<T>::type* zv =
        reinterpret_cast<typename Vec<T>::type*>(z + head);
    for (int64_t e = threadIdx.x; e < head; e += kThreads) z[e] = T(0);
    for (int64_t e = threadIdx.x; e < body; e += kThreads)
      zv[e] = typename Vec<T>::type{};
    for (int64_t e = head + body * V + threadIdx.x; e < count; e += kThreads)
      z[e] = T(0);
  }

  T* head_part = part + (size_t)blockIdx.x * 2 * cc;
  T* tail_part = head_part + cc;
  // A run of id s that ended: the head partial when it began in the block
  // before, else its slot (none for an id outside [0, size)). Columns c0
  // .. c0 + m - 1.
  auto emit = [&](int64_t s, const T* v, int c0, int m) {
    if (open_start && s == first) {
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (q < m) head_part[c0 + q] = v[q];
    } else if (s >= 0 && s < size) {
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (q < m) out[s * cc + c0 + q] = v[q];
    }
  };

  for (int t = 0; t < steps; ++t) {
    const int slab = slabs == 1 ? 0 : t / stages, k = t - slab * stages;
    const int c_lo = slab * wd, w = C > 0 ? C : min(wd, cc - c_lo);
    const int rows =
        (int)min((int64_t)stage_rows, r1 - r0 - (int64_t)k * stage_rows);
    copy_wait<0>();   // step t is in, for every thread after the
    __syncthreads();  // barrier, and step t - 1 is added:
    issue(t + 1);     // its buffer takes the next step
    const unsigned char* buf = smem_raw + (t & 1) * stage_bytes;
    const int64_t* ids = reinterpret_cast<const int64_t*>(buf);
    const T* vals =
        reinterpret_cast<const T*>(buf + (size_t)stage_rows * sizeof(int64_t));
    const int j0 = threadIdx.x * K, j1 = min(j0 + K, rows);
    const bool has = j0 < rows;
    const int last = (rows - 1) / K;  // the thread of the stage's last row
    const int64_t fid = has ? ids[j0] : 0, lid = has ? ids[j1 - 1] : 0;
    // Whether the thread's first run goes on from the thread (or stage)
    // before, and its last run into the next thread; the stage's last run
    // is always carried.
    const bool open_in =
        has && (threadIdx.x > 0 ? ids[j0 - 1] == fid
                                : k > 0 && s_carry_id[k & 1] == fid);
    const bool open_out = has && ((int)threadIdx.x == last || ids[j1] == lid);
    const T* carry = k > 0 ? s_carry + (k & 1) * carry_len : nullptr;
    T* next_carry = s_carry + ((k + 1) & 1) * carry_len;
    if (threadIdx.x == 0 && k > 0 && !open_in)  // the carried run ended
      for (int c0 = 0; c0 < w; c0 += G)
        emit(s_carry_id[k & 1], carry + c0, c_lo + c0, min(G, w - c0));
    for (int c0 = 0; c0 < w; c0 += G) {
      const int m = C > 0 ? G : min(G, w - c0);
      T head[G], acc[G], prev[G];
#pragma unroll
      for (int q = 0; q < G; ++q) head[q] = acc[q] = T(0);
      bool brk = false;  // a run ends inside the thread
      int64_t run = fid;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int j = j0 + i;
        if (j >= j1) break;
        const int64_t s = ids[j];
        if (s != run) {
          if (brk) {
            emit(run, acc, c_lo + c0, m);  // a run inside the thread
          } else {
#pragma unroll
            for (int q = 0; q < G; ++q) head[q] = acc[q];
          }
          brk = true;
          run = s;
#pragma unroll
          for (int q = 0; q < G; ++q) acc[q] = T(0);
        }
#pragma unroll
        for (int q = 0; q < G; ++q)
          if (q < m) acc[q] += vals[(size_t)j * w + c0 + q];
      }
      // acc: the thread's part of its last run; after the scan, that run's
      // sum from its start (the carry included), and prev the same for the
      // thread before.
      segmented_scan<T, G>(has && (brk || !open_in), acc, prev,
                           carry ? carry + c0 : nullptr, s_warp, s_start);
      if (has) {
        if (brk) {  // the thread's first run ends inside it
          if (open_in)
#pragma unroll
            for (int q = 0; q < G; ++q) head[q] = prev[q] + head[q];
          emit(fid, head, c_lo + c0, m);
        }
        if (!open_out) {
          emit(lid, acc, c_lo + c0, m);
        } else if ((int)threadIdx.x == last) {
#pragma unroll
          for (int q = 0; q < G; ++q)
            if (q < m) next_carry[c0 + q] = acc[q];
          if (c0 == 0) s_carry_id[(k + 1) & 1] = lid;
        }
      }
      if (C == 0) __syncthreads();  // s_warp again in the next group
    }
    if (k < stages - 1) continue;
    // The slab's last stage: the block's last run, carried out of it, is a
    // tail partial when it goes on into the next block (a head partial
    // when it also began in the block before), else it ended here.
    __syncthreads();
    if (threadIdx.x == 0) {
      const T* v = s_carry + (stages & 1) * carry_len;
      const int64_t s = s_carry_id[stages & 1];
      const bool open_end = r1 < n && after == s;
      if (open_end && !(open_start && s == first)) {
        for (int c = 0; c < w; ++c) tail_part[c_lo + c] = v[c];
      } else {
        for (int c0 = 0; c0 < w; c0 += G)
          emit(s, v + c0, c_lo + c0, min(G, w - c0));
      }
    }
  }
  if (gridDim.x == 1 || !arrive(ticket, gridDim.x)) return;

  // The last block, thread b for block b. A run that crosses blocks left
  // a tail partial in the block where it began and a head partial in each
  // later block it reaches (the whole block's sum in a block it goes
  // through). The scan by segments over the blocks, in block order, adds
  // them; the block where the run ends writes its slot.
  const int b = threadIdx.x;
  const bool valid = b < (int)gridDim.x;
  int64_t fb = 0, lb = 0;
  bool bos = false, boe = false;
  if (valid) {
    const int64_t b0 = (int64_t)b * rows_per_block;
    const int64_t b1 = min(n, b0 + rows_per_block);
    fb = __ldg(seg + b0);
    lb = __ldg(seg + b1 - 1);
    bos = b0 > 0 && __ldg(seg + b0 - 1) == fb;
    boe = b1 < n && __ldg(seg + b1) == lb;
  }
  const bool through = bos && fb == lb;  // one run from end to end
  const bool ends = valid && bos && (!boe || fb != lb) && fb >= 0 && fb < size;
  const T* bp = part + (size_t)b * 2 * cc;
  for (int c0 = 0; c0 < cc; c0 += G) {
    const int m = C > 0 ? G : min(G, cc - c0);
    T v[G], prev[G];
#pragma unroll
    for (int q = 0; q < G; ++q)
      v[q] = valid && boe && q < m ? __ldcg(bp + (through ? 0 : cc) + c0 + q)
                                   : T(0);
    segmented_scan<T, G>(!through, v, prev, nullptr, s_warp, s_start);
    if (ends)
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (q < m) out[fb * cc + c0 + q] = prev[q] + __ldcg(bp + c0 + q);
    __syncthreads();
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

template <typename T, int C>
cudaError_t launch_sorted(const T* x, const int64_t* seg, T* part,
                          unsigned* ticket, T* out, long long n,
                          long long size, int cols, int width, int blocks,
                          long long rows_per_block, int stage_rows,
                          int per_thread, int smem, bool memset, bool vec,
                          cudaStream_t s) {
  // the plan's rows a thread are the ones this instance adds
  if (C > 0 && per_thread != sorted_rows_per_thread<T, C>())
    return cudaErrorInvalidValue;
  // raised once per device for each instance, to the most a plan takes
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(sorted_segments<T, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSortedSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  if (memset) {
    err = cudaMemsetAsync(out, 0, (size_t)size * cols * sizeof(T), s);
    if (err != cudaSuccess) return err;
  }
  sorted_segments<T, C><<<blocks, kThreads, smem, s>>>(
      x, seg, part, ticket, out, (int64_t)n, (int64_t)size, cols, width,
      (int64_t)rows_per_block, stage_rows, per_thread, !memset, vec);
  return cudaGetLastError();
}

// One launch of the sorted kernel (after a memset of the output when the
// plan says so). part holds two partials of C values a block; ticket one
// zeroed counter.
template <typename T>
int sorted_launch(const T* x, const int64_t* seg, T* part, unsigned* ticket,
                  T* out, long long n, long long size, int C, int width,
                  int blocks, long long rows_per_block, int stage_rows,
                  int per_thread, int smem, int memset, int vec,
                  void* stream) {
  if (n <= 0 || C <= 0) return 0;
  // the last block adds the partials a thread a block
  if (blocks < 1 || blocks > kThreads || smem > kSortedSmemBytes ||
      size < 0 || seg == nullptr || width < 1 || width > C ||
      (C <= 4 && width != C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool m = memset != 0, v = vec != 0;
  switch (C) {
    case 1:
      return (int)launch_sorted<T, 1>(x, seg, part, ticket, out, n, size, C,
                                      width, blocks, rows_per_block,
                                      stage_rows, per_thread, smem, m, v, s);
    case 2:
      return (int)launch_sorted<T, 2>(x, seg, part, ticket, out, n, size, C,
                                      width, blocks, rows_per_block,
                                      stage_rows, per_thread, smem, m, v, s);
    case 3:
      return (int)launch_sorted<T, 3>(x, seg, part, ticket, out, n, size, C,
                                      width, blocks, rows_per_block,
                                      stage_rows, per_thread, smem, m, v, s);
    case 4:
      return (int)launch_sorted<T, 4>(x, seg, part, ticket, out, n, size, C,
                                      width, blocks, rows_per_block,
                                      stage_rows, per_thread, smem, m, v, s);
    default:
      return (int)launch_sorted<T, 0>(x, seg, part, ticket, out, n, size, C,
                                      width, blocks, rows_per_block,
                                      stage_rows, per_thread, smem, m, v, s);
  }
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

// The sorted kernel's arguments that follow from its plan alone (ops/
// kernels.py: _SortedArgs): rows, rows a block, the bytes of ticket
// counters at the head of the stream's scratch (the partials follow them),
// columns, the columns a stage holds, blocks, rows a stage, rows a thread
// in a stage, the dynamic shared memory, and whether a memset zeroes the
// output before the launch (else the blocks zero their empty slots).
struct SortedArgs {
  long long n;
  long long rows_per_block;
  long long ticket_bytes;
  int C;
  int width;
  int blocks;
  int stage_rows;
  int per_thread;
  int smem;
  int memset;
};

extern "C" int sorted_segment_sum_f32(const float* x, const int64_t* seg,
                                      void* scratch, float* out,
                                      const SortedArgs* a, long long size,
                                      int vec, void* stream) {
  return sorted_launch<float>(
      x, seg, reinterpret_cast<float*>((char*)scratch + a->ticket_bytes),
      (unsigned*)scratch, out, a->n, size, a->C, a->width, a->blocks,
      a->rows_per_block, a->stage_rows, a->per_thread, a->smem, a->memset,
      vec, stream);
}

extern "C" int sorted_segment_sum_f64(const double* x, const int64_t* seg,
                                      void* scratch, double* out,
                                      const SortedArgs* a, long long size,
                                      int vec, void* stream) {
  return sorted_launch<double>(
      x, seg, reinterpret_cast<double*>((char*)scratch + a->ticket_bytes),
      (unsigned*)scratch, out, a->n, size, a->C, a->width, a->blocks,
      a->rows_per_block, a->stage_rows, a->per_thread, a->smem, a->memset,
      vec, stream);
}
