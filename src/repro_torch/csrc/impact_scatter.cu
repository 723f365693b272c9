// impact_scatter: the SAAT accumulator, acc[b, d] = sum of contribs[b, p]
// over the postings p of row b with docs[b, p] == d.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/impact_scatter/kernel.py:impact_scatter_batched_kernel
// (and its single-query impact_scatter_kernel, which the Python wrapper
// runs as a batch of one).
//
// Bound on the H100: memory. Each posting slot is read once (8 B: a doc id
// and a contribution) and each accumulator entry written once (4 B); the
// arithmetic is one add per posting. At the main path's shapes the output
// (B x n_docs_pad x 4 B) is of the same order as the postings read.
//
// Design. The TPU kernel built each block's sum as a one-hot matmul on the
// MXU over a (block x posting tile) grid and skipped tiles by their doc
// range. Here the postings arrive sorted by doc, so a block's postings form
// one contiguous run: one CTA per (query, block of block_d docs) finds the
// run with two warp-cooperative binary searches, each thread finds its own
// doc's sub-run inside it, and adds that sub-run sequentially in row order.
// The order is fixed, so the result is the same from run to run (no
// atomics), and each output is written once, coalesced. A doc has at most
// one posting per query term, so no thread walks a long run; slots that
// carry nothing were moved past every block by the sorting step.
#include "scatter_common.cuh"

namespace {

__global__ void impact_scatter_kernel(const int* __restrict__ docs,
                                      const float* __restrict__ contribs,
                                      float* __restrict__ out, int P, int n_docs, int block_d) {
  extern __shared__ int s_bounds[];  // block_d + 1
  __shared__ int s_range[2];
  const size_t row = blockIdx.y;
  const int block_start = blockIdx.x * block_d;
  const float acc = repro_torch::block_doc_sum(docs + row * P, contribs + row * P, P,
                                               block_start, block_d, s_bounds, s_range);
  out[row * n_docs + block_start + threadIdx.x] = acc;
}

}  // namespace

// docs i32[B, P] (rows sorted), contribs f32[B, P] -> out f32[B, n_docs].
// n_docs % block_d == 0; block_d a power of two in [64, 1024].
extern "C" int impact_scatter_launch(const void* docs, const void* contribs, void* out, int B,
                                     int P, int n_docs, int block_d, void* stream) {
  const dim3 grid(n_docs / block_d, B);
  const size_t smem = (block_d + 1) * sizeof(int);
  impact_scatter_kernel<<<grid, block_d, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(docs), static_cast<const float*>(contribs),
      static_cast<float*>(out), P, n_docs, block_d);
  return static_cast<int>(cudaGetLastError());
}
