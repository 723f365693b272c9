// sparse_score: match-and-accumulate scoring of gathered doc rows,
//   score[b, d] = sum_j dw[b, d, j] * sum_l [dt[b, d, j] == qt[b, l]] * qw[b, l].
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/sparse_score/kernel.py:sparse_score_batched_kernel
// (and its single-query sparse_score_kernel, which the Python wrapper runs
// as a batch of one).
//
// Bound on the H100: memory. Each doc row's term ids are read once (4 B
// per term slot), a weight (4 B) only where the slot's term is one of the
// query's, and each score written once (4 B); the matching is a few dozen
// integer operations per term slot.
//
// Design. The TPU kernel matched every term slot against every query slot
// as a one-hot [BD * Tmax, Lq] matrix and contracted it on the MXU. Here the
// query's distinct terms go into shared memory once per CTA, sorted, with
// duplicate slots summed, beside a hashed filter of them (score_common.cuh);
// one warp scores one doc, keeping 8 chunks of 32 term ids in flight, testing
// each term against the filter and looking up only the few it passes, and
// reading a weight only where its term matches. This kernel takes any rows,
// so it reads each row to Tmax; the fused chunk_step kernel, which reads the
// index's own store, stops at the row's padding with the same device function
// and gives the same bits. One CTA owns a (query, block of DOCS docs).
#include "score_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int DOCS = 64;

__global__ void __launch_bounds__(THREADS)
sparse_score_kernel(const int* __restrict__ dt, const float* __restrict__ dw,
                    const int* __restrict__ qt, const float* __restrict__ qw,
                    float* __restrict__ out, int n, int tmax, int lq) {
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
  const int d_end = min(n, static_cast<int>(blockIdx.x + 1) * DOCS);
  for (int d = blockIdx.x * DOCS + warp; d < d_end; d += THREADS / 32) {
    const size_t off = (row * n + d) * static_cast<size_t>(tmax);
    const float s = repro_torch::warp_doc_score<false>(dt + off, dw + off, tmax, s_filter,
                                                       s_terms, s_vals, n_q);
    if ((threadIdx.x & 31) == 0) out[row * n + d] = s;
  }
}

}  // namespace

// dt i32[B, n, tmax], dw f32[B, n, tmax], qt i32[B, lq], qw f32[B, lq]
// (lq <= MAX_LQ) -> out f32[B, n].
extern "C" int sparse_score_launch(const void* dt, const void* dw, const void* qt,
                                   const void* qw, void* out, int B, int n, int tmax, int lq,
                                   void* stream) {
  const dim3 grid((n + DOCS - 1) / DOCS, B);
  sparse_score_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dt), static_cast<const float*>(dw), static_cast<const int*>(qt),
      static_cast<const float*>(qw), static_cast<float*>(out), n, tmax, lq);
  return static_cast<int>(cudaGetLastError());
}
