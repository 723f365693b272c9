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
// Bound on the H100: memory. Each posting slot of the block ranges is read
// once (8 B); the accumulator never leaves the chip, and only 8 B x k per
// block are written, plus 4 B per doc of the tombstone bitmap when there is
// one.
//
// What held the earlier design back (1.053 ms at rho = 1M against a 0.094
// ms bound; chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W): not the
// bytes but the work of each of the 34,560 CTAs (540 blocks of 512 docs x
// 64 queries): 512 dependent binary searches in device memory for the
// docs' first postings, sums from loads that did not coalesce, and a full
// 512-key bitonic sort (45 barrier-separated stages) to keep k = 10.
//
// Design. One CTA per (query, block), a thread per doc or per few docs
// (dpt, so that more CTAs, each a chain of dependent loads, are in flight
// on an SM). The accumulation (scatter_common.cuh): the block's posting
// range is staged into shared memory in coalesced stages, each doc's run is
// found there by one scan, and each doc's run is added in row order, the
// order the unfused kernel keeps, so the scores are bit-identical to its
// sums (and to the earlier design's). The block's scores stay in shared memory. Each key packs the
// score, mapped to an unsigned integer of the same order, above
// 0xFFFFFFFF - local index (select_common.cuh), so keys are unique, order
// by score and break ties toward the lower doc id, the tie rule of
// lax.top_k in the reference; any correct sort or select of them gives the
// same ids. Where k is small the k best keys are kept by block_select_desc
// (rounds of a warp-wide max, then a merge of the warps' lists: two
// barriers); where k nears block_d a descending bitonic sort of the block's
// keys is cheaper than k rounds. The wrapper chooses (use_select in
// kernels/impact_scatter_topk/ops.py). Shared memory per CTA: the stage
// (8 B a posting), the run starts and the scores (4 B x block_d each), and
// the keys (8 B x block_d for the sort, or the warps' select lists, 8 B x
// (threads / 32) x min(k, 32 x dpt)); impact_scatter_topk_layout counts it.
//
// chip_smoke.py sweeps the CTA shape (4 docs a thread with a 1,024-posting
// stage halved the time of a thread a doc) and the select against the sort
// (the select wins up to k_blk = 32, the sort at 64: the select's k
// rounds are serial); PERF.md has the times.
#include "launch_plan.cuh"
#include "scatter_common.cuh"
#include "select_common.cuh"

namespace {

template <int DPT, bool kSelect>
__global__ void impact_scatter_topk_kernel(const int* __restrict__ docs,
                                           const float* __restrict__ contribs,
                                           const int* __restrict__ live,
                                           float* __restrict__ out_s, int* __restrict__ out_i,
                                           int P, int n_docs, int n_live, int block_d, int k,
                                           int stage, int n_keys, int list_len) {
  extern __shared__ unsigned long long s_key[];  // n_keys keys, then the arrays below
  float* s_val = reinterpret_cast<float*>(s_key + n_keys);  // block_d
  int* s_ids = reinterpret_cast<int*>(s_val + block_d);     // stage
  float* s_vals = reinterpret_cast<float*>(s_ids + stage);  // stage
  int* s_start = reinterpret_cast<int*>(s_vals + stage);    // block_d
  __shared__ int s_range[3];

  const int t = threadIdx.x;
  const size_t row = blockIdx.y;
  const int block_start = blockIdx.x * block_d;
  float acc[DPT];
  repro_torch::block_doc_sums<DPT>(docs + row * P, contribs + row * P, P, block_start, block_d,
                                   stage, s_ids, s_vals, s_start, s_range, acc);
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = t + q * blockDim.x;
    const int gid = block_start + d;
    const bool keep = gid < n_live && (live == nullptr || __ldg(live + gid) != 0);
    const float v = keep ? acc[q] : __int_as_float(0xff800000);  // -inf
    s_val[d] = v;
    if (!kSelect) s_key[d] = repro_torch::select_key(v, d);
  }
  __syncthreads();
  const size_t o = (row * gridDim.x + blockIdx.x) * k;
  if constexpr (kSelect) {
    repro_torch::block_select_desc(
        [&](int i) { return repro_torch::select_key(s_val[i], i); }, block_d, k, list_len, s_key,
        [&](int r, unsigned long long key) {
          const int idx = repro_torch::key_index(key);
          out_s[o + r] = s_val[idx];
          out_i[o + r] = block_start + idx;
        });
  } else {
    repro_torch::bitonic_sort_desc(s_key, block_d);
    for (int r = t; r < k; r += blockDim.x) {
      const int idx = repro_torch::key_index(s_key[r]);
      out_s[o + r] = s_val[idx];
      out_i[o + r] = block_start + idx;
    }
  }
}

repro_torch::LaunchPlan plan(int B, int n_docs, int block_d, int dpt, int smem) {
  return {dim3(n_docs / block_d, B), block_d / dpt, 1, static_cast<size_t>(smem)};
}

template <int DPT, bool kSelect>
int launch(const void* docs, const void* contribs, const void* live, void* out_s, void* out_i,
           int B, int P, int n_docs, int n_live, int block_d, int k, int stage, int n_keys,
           int list_len, int smem, cudaStream_t stream) {
  auto kernel = impact_scatter_topk_kernel<DPT, kSelect>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const repro_torch::LaunchPlan p = plan(B, n_docs, block_d, DPT, smem);
  kernel<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const int*>(docs), static_cast<const float*>(contribs),
      static_cast<const int*>(live), static_cast<float*>(out_s), static_cast<int*>(out_i), P,
      n_docs, n_live, block_d, k, stage, n_keys, list_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// docs i32[B, P] (rows sorted), contribs f32[B, P], live i32[n_docs] or null
// -> out_s f32[B, n_docs / block_d, k], out_i i32[B, n_docs / block_d, k].
// n_docs % block_d == 0; block_d a power of two in [64, 1024]; 0 < k <= block_d;
// dpt (docs a thread) 1, 2 or 4 with block_d / dpt >= 64; stage postings
// staged at once. select: keep the k best by block_select_desc, with
// n_keys = (block_d / dpt / 32) * list_len list keys, else sort n_keys =
// block_d keys. smem as the wrapper lays it out (impact_scatter_topk_layout).
extern "C" int impact_scatter_topk_plan(int B, int P, int n_docs, int n_live, int block_d,
                                        int k, int dpt, int stage, int select, int n_keys,
                                        int list_len, int smem, int* out) {
  if (dpt != 1 && dpt != 2 && dpt != 4) return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::write_plan(plan(B, n_docs, block_d, dpt, smem), out);
}

extern "C" int impact_scatter_topk_launch(const void* docs, const void* contribs,
                                          const void* live, void* out_s, void* out_i, int B,
                                          int P, int n_docs, int n_live, int block_d, int k,
                                          int dpt, int stage, int select, int n_keys,
                                          int list_len, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D, S)                                                                    \
  return launch<D, S>(docs, contribs, live, out_s, out_i, B, P, n_docs, n_live, block_d, k, \
                      stage, n_keys, list_len, smem, s)
  if (select) {
    switch (dpt) {
      case 1: REPRO_LAUNCH(1, true);
      case 2: REPRO_LAUNCH(2, true);
      case 4: REPRO_LAUNCH(4, true);
    }
  } else {
    switch (dpt) {
      case 1: REPRO_LAUNCH(1, false);
      case 2: REPRO_LAUNCH(2, false);
      case 4: REPRO_LAUNCH(4, false);
    }
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
