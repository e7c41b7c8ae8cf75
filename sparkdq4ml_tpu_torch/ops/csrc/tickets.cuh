// The integer ticket that ends a one-launch reduction across blocks: each
// block writes its partial to the stream's scratch, takes a ticket, and the
// block that takes the last one adds every partial in a fixed order. Shared
// by the segment sums (segment_sum.cu) and the sketch (dq_sketch.cu); the
// wrapper gives each stream its own counters (ops/kernels.py:
// _stream_state), and each kernel its own slots among them.
#pragma once

#include <cuda_runtime.h>

namespace {

// One of `members` blocks that each wrote a partial takes a ticket from
// `counter`; true in every thread of the block that came last, which also
// puts the counter back to 0 for the next call on this stream (every
// member has taken its ticket by then).
__device__ bool arrive(unsigned* counter, unsigned members) {
  __shared__ bool last;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == members - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

}  // namespace
