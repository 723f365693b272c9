// Shared device code of the two SAAT scatter kernels (impact_scatter.cu,
// impact_scatter_topk.cu): the per-block posting range search and the
// per-doc sum, so both kernels add every doc's contributions in one order.
//
// What held the earlier per-doc sum back (impact_scatter_topk at 11x its
// bound, 1.053 ms at rho = 1M; chip_smoke.py on an NVIDIA H100 80GB HBM3,
// 700.00 W): each of a CTA's block_d threads ran its own dependent binary
// search in device memory for its doc's first posting (about 10 serial
// loads over a block's ~1,100 postings), then summed its run with loads
// that did not coalesce (the lanes of a warp at scattered addresses).
// block_doc_sums now stages the block's postings in shared memory with
// coalesced loads and finds every doc's run there with one scan.
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

// Sums of the contributions of the DPT docs block_start + threadIdx.x + q *
// blockDim.x (q < DPT) of a block of block_d = DPT * blockDim.x docs, each
// added one by one in row order, into acc[q]. blockDim.x >= 64, a multiple
// of 32. Shared scratch: s_ids and s_vals `stage` entries each, s_start
// block_d ints, s_range 3 ints.
//
// Warps 0 and 1 find the block's posting range [lo, hi) (two warp-wide
// searches of the row); the range is then staged into shared memory in
// coalesced stages of at most `stage` postings. In a stage, a posting whose
// doc differs from its predecessor's starts that doc's run, and the docs
// between the two, which have no posting in the stage, start there too:
// s_start[e] is the first staged posting of a doc >= e, the lower bound the
// per-thread searches of the earlier design found in device memory. Each
// thread then adds each of its docs' runs of the stage, s_start[d] up to
// s_start[d + 1], from shared memory; a range longer than one stage carries
// each doc's partial sum into the next, so every doc's contributions are
// added in row order and the sum has the earlier design's bits.
template <int DPT>
__device__ __forceinline__ void block_doc_sums(const int* __restrict__ docs,
                                               const float* __restrict__ contribs, int P,
                                               int block_start, int block_d, int stage,
                                               int* s_ids, float* s_vals, int* s_start,
                                               int* s_range, float (&acc)[DPT]) {
  const int t = threadIdx.x;
  const int threads = blockDim.x;
  const int warp = t >> 5;
  if (warp < 2) {
    const int pos = warp_lower_bound(docs, 0, P, block_start + warp * block_d);
    if ((t & 31) == 0) s_range[warp] = pos;
  }
#pragma unroll
  for (int q = 0; q < DPT; ++q) acc[q] = 0.0f;
  __syncthreads();
  const int lo = s_range[0];
  const int hi = s_range[1];
  for (int p0 = lo; p0 < hi; p0 += stage) {
    const int n = min(stage, hi - p0);
    for (int i = t; i < n; i += threads) {
      s_ids[i] = __ldg(docs + p0 + i) - block_start;
      s_vals[i] = __ldg(contribs + p0 + i);
    }
    __syncthreads();
    for (int i = t; i < n; i += threads) {
      const int cur = s_ids[i];
      for (int e = (i == 0 ? -1 : s_ids[i - 1]) + 1; e <= cur; ++e) s_start[e] = i;
    }
    if (t == 0) s_range[2] = s_ids[n - 1];  // docs past it have no posting in the stage
    __syncthreads();
    const int last = s_range[2];
#pragma unroll
    for (int q = 0; q < DPT; ++q) {
      const int d = t + q * threads;
      const int end = d < last ? s_start[d + 1] : n;
      for (int p = d <= last ? s_start[d] : n; p < end; ++p) acc[q] += s_vals[p];
    }
    __syncthreads();  // the next stage overwrites the arrays
  }
}

}  // namespace repro_torch
