// impact_scatter_topk: the fused SAAT scatter and per-block top-k. For each
// (query b, block of block_d docs) it sums the block's accumulator exactly
// as impact_scatter does, masks pad docs (id >= n_live) and tombstoned docs
// (live[id] == 0) to -inf, and emits the block's k best (score, doc id)
// pairs, highest score first and the lowest doc id first among equal
// scores, -inf included. A merge over the [B, n_blocks, k] pool outside the
// kernel gives the exact global top-k.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/impact_scatter_topk/kernel.py:impact_scatter_topk_batched_kernel
// (and its single-query impact_scatter_topk_kernel, which the Python
// wrapper runs as a batch of one).
//
// Bound on the H100: memory. Each posting slot is read once (8 B); the
// accumulator never leaves the chip, and only 8 B x k per block are
// written, plus 4 B per doc of the tombstone bitmap when there is one.
//
// Design. The accumulation is impact_scatter's (scatter_common.cuh): one
// CTA per (query, block), one thread per doc, each doc's contributions
// added sequentially in row order, so the scores are bit-identical to the
// unfused kernel's. The block's scores then stay in shared memory (block_d
// floats and block_d 64-bit keys: 6 KB at block_d = 512). Each key packs the
// score, mapped to an unsigned integer of the same order, above
// 0xFFFFFFFF - local index, so one descending bitonic sort over unique keys
// orders by score and breaks ties toward the lower doc id, the tie rule of
// lax.top_k in the reference (select_common.cuh). The first k threads write
// the result.
#include "scatter_common.cuh"
#include "select_common.cuh"

namespace {

__global__ void impact_scatter_topk_kernel(const int* __restrict__ docs,
                                           const float* __restrict__ contribs,
                                           const int* __restrict__ live,
                                           float* __restrict__ out_s, int* __restrict__ out_i,
                                           int P, int n_docs, int n_live, int block_d, int k) {
  extern __shared__ unsigned long long s_key[];  // block_d keys, then the arrays below
  float* s_val = reinterpret_cast<float*>(s_key + block_d);  // block_d
  int* s_bounds = reinterpret_cast<int*>(s_val + block_d);   // block_d + 1
  __shared__ int s_range[2];

  const int t = threadIdx.x;
  const size_t row = blockIdx.y;
  const int block_start = blockIdx.x * block_d;
  const float acc = repro_torch::block_doc_sum(docs + row * P, contribs + row * P, P,
                                               block_start, block_d, s_bounds, s_range);
  const int gid = block_start + t;
  const bool keep = gid < n_live && (live == nullptr || __ldg(live + gid) != 0);
  const float v = keep ? acc : __int_as_float(0xff800000);  // -inf
  s_val[t] = v;
  s_key[t] = repro_torch::select_key(v, t);
  __syncthreads();
  repro_torch::bitonic_sort_desc(s_key, block_d);

  if (t < k) {
    const int idx = repro_torch::key_index(s_key[t]);
    const size_t o = (row * gridDim.x + blockIdx.x) * k + t;
    out_s[o] = s_val[idx];
    out_i[o] = block_start + idx;
  }
}

}  // namespace

// docs i32[B, P] (rows sorted), contribs f32[B, P], live i32[n_docs] or null
// -> out_s f32[B, n_docs / block_d, k], out_i i32[B, n_docs / block_d, k].
// n_docs % block_d == 0; block_d a power of two in [64, 1024]; 0 < k <= block_d.
extern "C" int impact_scatter_topk_launch(const void* docs, const void* contribs,
                                          const void* live, void* out_s, void* out_i, int B,
                                          int P, int n_docs, int n_live, int block_d, int k,
                                          void* stream) {
  const dim3 grid(n_docs / block_d, B);
  const size_t smem = block_d * (sizeof(unsigned long long) + sizeof(float)) +
                      (block_d + 1) * sizeof(int);
  impact_scatter_topk_kernel<<<grid, block_d, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(docs), static_cast<const float*>(contribs),
      static_cast<const int*>(live), static_cast<float*>(out_s), static_cast<int*>(out_i), P,
      n_docs, n_live, block_d, k);
  return static_cast<int>(cudaGetLastError());
}
