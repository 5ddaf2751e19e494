// The sum over a launch's points of a few float64 partials, inside the
// launch (K1b in noise3d.cu, K3b in noise1d.cu): each block sums its
// threads' partials in a fixed order, writes them to a [blocks, P] scratch,
// and the last block to take a ticket sums the blocks' partials in block
// order.  Deterministic, no atomics on the values, no host sync.
//
// The ticket is one device word at 0 before a launch; the last block's
// atom.inc wraps it back to 0, so the next launch needs no memset.  Two
// launches that share a ticket must not overlap: the wrappers keep one
// ticket per stream (kernels/grid_sum.py).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// Sum v over the block's THREADS threads in a fixed order: a shuffle tree
// in each warp, then warp 0 over the warps' sums through `warps` (shared,
// [P][THREADS / 32]).  The sums are valid in thread 0; every thread of the
// block calls it.
template <int P, int THREADS>
__device__ __forceinline__ void block_sum(double (&v)[P], double* warps) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
  constexpr int W = THREADS / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] += __shfl_down_sync(FULL_MASK, v[j], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < P; ++j) warps[j * W + warp] = v[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = lane < W ? warps[j * W + lane] : 0.0;
#pragma unroll
    for (int off = W / 2; off > 0; off /= 2) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        v[j] += __shfl_down_sync(FULL_MASK, v[j], off);
      }
    }
  }
}

// Take the block's ticket (thread 0, after writing the block's partials):
// true in the last block to take one.  One acquire-release atom.inc at GPU
// scope: the release orders this block's partials before its ticket, the
// acquire makes every earlier block's partials visible to this thread (and,
// past a barrier, to its block), and the increment wraps the ticket back to
// 0 after the last block for the next launch.
__device__ __forceinline__ bool take_last_ticket(unsigned* ticket) {
  unsigned prev;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(prev)
               : "l"(ticket), "r"(gridDim.x - 1)
               : "memory");
  return prev == gridDim.x - 1;
}

// Sum each thread's partials v over the grid.  Every thread of every block
// calls it once, at its end.  Returns true in thread 0 of the last block,
// whose v then holds the grid's sums; false elsewhere (v is then spent).
template <int P, int THREADS>
__device__ __forceinline__ bool grid_sum(double (&v)[P],
                                         double* __restrict__ block_sums,
                                         unsigned* __restrict__ ticket) {
  __shared__ double warps[P * (THREADS / 32)];
  __shared__ bool last;
  block_sum<P, THREADS>(v, warps);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < P; ++j) block_sums[blockIdx.x * P + j] = v[j];
    last = take_last_ticket(ticket);
  }
  __syncthreads();
  if (!last) return false;
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = 0.0;
  // unrolled so that a thread's loads are in flight together
#pragma unroll 4
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] += __ldcg(block_sums + b * P + j);
  }
  block_sum<P, THREADS>(v, warps);
  return threadIdx.x == 0;
}

}  // namespace
