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
// run with two warp-cooperative binary searches, stages it in shared memory
// with coalesced loads, finds each doc's sub-run there with one scan, and
// adds each doc's sub-run sequentially in row order (scatter_common.cuh;
// the staged accumulation replaced per-thread binary searches in device
// memory, with the same bits). The order is fixed, so the result is the same from run to run (no atomics), and each
// output is written once, coalesced. A doc has at most one posting per
// query term, so no thread walks a long run; slots that carry nothing were
// moved past every block by the sorting step. A CTA may own a doc per
// thread or several (dpt), so that more CTAs, each a chain of dependent
// loads, are in flight on an SM; the wrapper chooses dpt and the stage.
// Shared memory per CTA: 8 B per staged posting and 4 B per doc of run
// starts (scatter_shape in kernels/common.py). At rho = 1M (64 queries,
// 540 blocks of 512 docs) it takes 0.240 ms, 2.1x its bound (0.417 ms a
// thread a doc with searches in device memory; chip_smoke.py, NVIDIA H100
// 80GB HBM3, 700.00 W).
#include "scatter_common.cuh"

namespace {

template <int DPT>
__global__ void impact_scatter_kernel(const int* __restrict__ docs,
                                      const float* __restrict__ contribs,
                                      float* __restrict__ out, int P, int n_docs, int block_d,
                                      int stage) {
  extern __shared__ int s_ids[];  // stage doc ids, then the arrays below
  float* s_vals = reinterpret_cast<float*>(s_ids + stage);  // stage
  int* s_start = reinterpret_cast<int*>(s_vals + stage);    // block_d
  __shared__ int s_range[3];
  const size_t row = blockIdx.y;
  const int block_start = blockIdx.x * block_d;
  float acc[DPT];
  repro_torch::block_doc_sums<DPT>(docs + row * P, contribs + row * P, P, block_start, block_d,
                                   stage, s_ids, s_vals, s_start, s_range, acc);
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    out[row * n_docs + block_start + threadIdx.x + q * blockDim.x] = acc[q];
  }
}

template <int DPT>
int launch(const void* docs, const void* contribs, void* out, int B, int P, int n_docs,
           int block_d, int stage, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      impact_scatter_kernel<DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_docs / block_d, B);
  impact_scatter_kernel<DPT><<<grid, block_d / DPT, smem, stream>>>(
      static_cast<const int*>(docs), static_cast<const float*>(contribs),
      static_cast<float*>(out), P, n_docs, block_d, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// docs i32[B, P] (rows sorted), contribs f32[B, P] -> out f32[B, n_docs].
// n_docs % block_d == 0; block_d a power of two in [64, 1024]; dpt (docs a
// thread) 1, 2 or 4 with block_d / dpt >= 64; stage postings staged at once;
// smem = 8 * stage + 4 * block_d bytes.
extern "C" int impact_scatter_launch(const void* docs, const void* contribs, void* out, int B,
                                     int P, int n_docs, int block_d, int dpt, int stage,
                                     int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dpt) {
    case 1: return launch<1>(docs, contribs, out, B, P, n_docs, block_d, stage, smem, s);
    case 2: return launch<2>(docs, contribs, out, B, P, n_docs, block_d, stage, smem, s);
    case 4: return launch<4>(docs, contribs, out, B, P, n_docs, block_d, stage, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
