// sparse_score: match-and-accumulate scoring of doc rows,
//   score[b, d] = sum_j w_dj * sum_l [t_dj == qt[b, l]] * qw[b, l],
// with two ways to address the rows:
// * gathered rows (sparse_score_launch): dt/dw[B, n, tmax], one row per
//   (query, doc), every row scored; the TPU kernel's own contract;
// * the index's store in place (sparse_score_blocks_launch): the doc-major
//   doc_terms/doc_weights[n_docs_pad, tmax] and block_ids[B, nb]; query b
//   scores the docs of its nb selected blocks, out[b, j * bs + i] for doc
//   block_ids[b, j] * bs + i. Pad docs (id >= n_live), tombstoned docs
//   (live[id] == 0) and, with block_live, the docs of the blocks whose
//   entry is 0 score -inf and are not read. This is the DAAT split mode's
//   scorer.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/sparse_score/kernel.py:sparse_score_batched_kernel
// (and its single-query sparse_score_kernel, which the Python wrapper runs
// as a batch of one). The reference gathers the selected blocks' rows
// outside Pallas (src/repro/core/daat.py: _score_blocks_kernel_batched) and
// scores the copy; the store entry computes the same function without it.
//
// Bound on the H100: memory. A scored doc's term ids are read once (4 B per
// slot) up to its last real term, a weight (4 B) only where the slot's
// term is one of the query's, the live bit of a doc (4 B) when there is a
// bitmap, and each score is written once (4 B); the matching is a few
// integer operations per term slot.
//
// What held the split mode back (chip_smoke.py on an NVIDIA H100 80GB HBM3,
// 700.00 W): before each launch the engine gathered the selected rows,
// index.doc_terms[flat] and index.doc_weights[flat], two [64, 2048, 650]
// copies of 340.8 MB each a trip; the kernel then read the copy to Tmax
// ("it takes any rows"), though a spladev2 doc fills about 199 of its 650
// slots and the rest is the pad term. The kernel ran at 6.6x its bound
// (0.118 ms at [64, 1024, 650]) and split mode took 217.692 ms a 136-trip
// batch, against 52.398 ms fused over the same trips.
//
// Design. The TPU kernel matched every term slot against every query slot
// as a one-hot [BD * Tmax, Lq] matrix and contracted it on the MXU. Here the
// query's distinct terms go into shared memory once per CTA, sorted, with
// duplicate slots summed, beside a hashed filter of them (score_common.cuh);
// one warp scores one doc, keeping 8 chunks of 32 term ids in flight,
// testing each term against the filter and looking up only the few it
// passes, and reading a weight only where its term matches. The store entry
// reads each row where it lies in the index and stops at the row's padding
// (warp_doc_score<true>, as chunk_step does: in the store a row holds its
// distinct terms, then the pad id to its end); the gathered entry takes any
// rows, so it reads them to Tmax. Both add a doc's matches in the same lane
// order, so a doc scores the same bits either way, and in chunk_step. One
// CTA owns a (query, span of docs_per_cta docs): 4 docs a warp, fewer where
// the batch would not fill the card. The registers are capped so that an SM
// holds 8 CTAs (64 warps). At the split trip's shape (64 queries x 2,048
// docs) 32 docs a CTA took 0.133 ms, and longer spans, which pay the CTA's
// query setup (the filter, the deduplication, three barriers) fewer times,
// were slower: 0.143 ms at 128 docs, 0.282 at 512 (chip_smoke.py's sweep,
// NVIDIA H100 80GB HBM3, 700.00 W). In trials, loading each slot's weight
// with its term (one round trip, twice the bytes) and loading the next
// doc's term ids under this doc's work were both slower.
#include "score_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// kStore: doc d of query row `row` is doc block_ids[row, d / bs] * bs + d % bs
// of the store (n == nb * bs); else it is row (row, d) of the gathered dt/dw.
template <bool kStore>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS)
sparse_score_kernel(const int* __restrict__ dt, const float* __restrict__ dw,
                    const int* __restrict__ qt, const float* __restrict__ qw,
                    const int* __restrict__ block_ids, const int* __restrict__ live,
                    const unsigned char* __restrict__ block_live, float* __restrict__ out,
                    int n, int tmax, int lq, int nb, int bs, int n_live, int docs_per_cta) {
  __shared__ int s_qt[repro_torch::MAX_LQ];
  __shared__ float s_qw[repro_torch::MAX_LQ];
  __shared__ unsigned char s_flag[repro_torch::MAX_LQ];
  __shared__ int s_terms[repro_torch::MAX_LQ];
  __shared__ float s_vals[repro_torch::MAX_LQ];
  __shared__ unsigned s_filter[repro_torch::FILTER_WORDS];
  __shared__ int s_n;
  const size_t row = blockIdx.y;
  repro_torch::load_query_table(qt + row * lq, qw + row * lq, lq, s_qt, s_qw, s_flag,
                                s_terms, s_vals, &s_n, s_filter);
  const int n_q = s_n;
  const int warp = threadIdx.x >> 5;
  const int d0 = blockIdx.x * docs_per_cta;
  const int d_end = min(n, d0 + docs_per_cta);
  for (int d = d0 + warp; d < d_end; d += WARPS) {
    size_t off;
    bool keep = true;  // the same for every lane of the warp
    if constexpr (kStore) {
      const int j = d / bs;
      const int gid = __ldg(block_ids + row * nb + j) * bs + (d - j * bs);
      keep = (block_live == nullptr || block_live[row * nb + j] != 0) && gid < n_live &&
             (live == nullptr || __ldg(live + gid) != 0);
      off = static_cast<size_t>(gid) * tmax;
    } else {
      off = (row * n + d) * static_cast<size_t>(tmax);
    }
    float s = __int_as_float(0xff800000);  // -inf
    if (keep) {
      s = repro_torch::warp_doc_score<kStore>(dt + off, dw + off, tmax, s_filter, s_terms,
                                              s_vals, n_q);
    }
    if ((threadIdx.x & 31) == 0) out[row * n + d] = s;
  }
}

}  // namespace

// dt i32[B, n, tmax], dw f32[B, n, tmax], qt i32[B, lq], qw f32[B, lq]
// (lq <= MAX_LQ) -> out f32[B, n]; one CTA per docs_per_cta docs of a query.
extern "C" int sparse_score_launch(const void* dt, const void* dw, const void* qt,
                                   const void* qw, void* out, int B, int n, int tmax, int lq,
                                   int docs_per_cta, void* stream) {
  const dim3 grid((n + docs_per_cta - 1) / docs_per_cta, B);
  sparse_score_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dt), static_cast<const float*>(dw), static_cast<const int*>(qt),
      static_cast<const float*>(qw), nullptr, nullptr, nullptr, static_cast<float*>(out), n,
      tmax, lq, 0, 1, 0, docs_per_cta);
  return static_cast<int>(cudaGetLastError());
}

// doc_terms i32[n_docs_pad, tmax], doc_weights f32[n_docs_pad, tmax] (the
// index's store), block_ids i32[B, nb] (< n_docs_pad / bs), live i32[n_docs_pad]
// or null, block_live u8[B, nb] or null, qt i32[B, lq], qw f32[B, lq]
// (lq <= MAX_LQ) -> out f32[B, nb * bs].
extern "C" int sparse_score_blocks_launch(const void* doc_terms, const void* doc_weights,
                                          const void* block_ids, const void* live,
                                          const void* block_live, const void* qt,
                                          const void* qw, void* out, int B, int nb, int bs,
                                          int n_live, int tmax, int lq, int docs_per_cta,
                                          void* stream) {
  const int n = nb * bs;
  const dim3 grid((n + docs_per_cta - 1) / docs_per_cta, B);
  sparse_score_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(doc_terms), static_cast<const float*>(doc_weights),
      static_cast<const int*>(qt), static_cast<const float*>(qw),
      static_cast<const int*>(block_ids), static_cast<const int*>(live),
      static_cast<const unsigned char*>(block_live), static_cast<float*>(out), n, tmax, lq, nb,
      bs, n_live, docs_per_cta);
  return static_cast<int>(cudaGetLastError());
}
