// Shared device code of the two SAAT scatter kernels (impact_scatter.cu,
// impact_scatter_topk.cu): the per-block posting range search and the
// per-doc sum, so both kernels add every doc's contributions in one order.
//
// Input layout (from repro_torch.kernels.common.sorted_posting_tiles): row b
// of docs i32[B, P] is sorted ascending by doc id, and contribs f32[B, P]
// rides with it. A doc id equal to the padded doc count marks a slot that
// carries nothing; those slots sit at the tail of the row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// First index i in [lo, hi) with a[i] >= key, or hi. Warp-cooperative: all
// 32 lanes of the calling warp call it with the same arguments. Each round
// probes 32 evenly spaced points at once, so a row of 2^21 postings takes 4
// dependent rounds of loads instead of 21.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int lo, int hi,
                                                int key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long len = hi - lo;
    const int q = lo + static_cast<int>((len * lane) / 32);
    const unsigned below = __ballot_sync(0xffffffffu, __ldg(a + q) < key);
    const int f = __popc(below);  // the probes below key form a prefix
    if (f == 0) return lo;
    const int last_below = lo + static_cast<int>((len * (f - 1)) / 32);
    const int first_at_or_above = f < 32 ? lo + static_cast<int>((len * f) / 32) : hi;
    lo = last_below + 1;
    hi = first_at_or_above;
  }
  const int q = lo + lane;
  const unsigned below = __ballot_sync(0xffffffffu, q < hi && __ldg(a + q) < key);
  return lo + __popc(below);
}

// First index i in [lo, hi) with a[i] >= key, or hi. One thread.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Sum of the contributions of doc block_start + threadIdx.x, added one by
// one in row order. Launch with blockDim.x == block_d (>= 64, a multiple of
// 32). s_bounds holds block_d + 1 ints of shared memory, s_range 2 ints.
__device__ __forceinline__ float block_doc_sum(const int* __restrict__ docs,
                                               const float* __restrict__ contribs, int P,
                                               int block_start, int block_d,
                                               int* s_bounds, int* s_range) {
  const int t = threadIdx.x;
  const int warp = t >> 5;
  // warp 0 finds where this block's postings begin, warp 1 where they end
  if (warp < 2) {
    const int pos = warp_lower_bound(docs, 0, P, block_start + warp * block_d);
    if ((t & 31) == 0) s_range[warp] = pos;
  }
  __syncthreads();
  const int lo = s_range[0];
  const int hi = s_range[1];
  // each thread finds where its doc begins; it ends where the next begins
  s_bounds[t] = lower_bound(docs, lo, hi, block_start + t);
  if (t == 0) s_bounds[block_d] = hi;
  __syncthreads();
  float acc = 0.0f;
  const int end = s_bounds[t + 1];
  for (int p = s_bounds[t]; p < end; ++p) acc += __ldg(contribs + p);
  return acc;
}

}  // namespace repro_torch
