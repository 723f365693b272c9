// Shared device code of the two DAAT scorers (sparse_score.cu and the fused
// chunk_step.cu): the query's term table in shared memory and one doc's
// score, so split mode and fused mode give bit-identical scores, thresholds
// and work counts on the card.
//
// A doc's score is sum_j w_dj * qv(term_dj), with
// qv(t) = sum_l [t == qt_l] * qw_l added in slot order, so duplicate query
// terms sum and slots of weight 0 add nothing.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int MAX_LQ = 256;

// The query's distinct terms of nonzero weight, ascending, each with qv(t),
// in s_terms/s_vals[0, *s_n). Every thread of the block calls it; it
// returns after a __syncthreads(). s_flag holds MAX_LQ bytes of scratch,
// s_qt/s_qw MAX_LQ entries each; lq <= MAX_LQ.
__device__ __forceinline__ void load_query_table(const int* __restrict__ qt,
                                                 const float* __restrict__ qw, int lq,
                                                 int* s_qt, float* s_qw, unsigned char* s_flag,
                                                 int* s_terms, float* s_vals, int* s_n) {
  for (int l = threadIdx.x; l < lq; l += blockDim.x) {
    s_qt[l] = __ldg(qt + l);
    s_qw[l] = __ldg(qw + l);
  }
  __syncthreads();
  // a slot is its term's first when no earlier slot of nonzero weight holds the term
  for (int l = threadIdx.x; l < lq; l += blockDim.x) {
    bool first = s_qw[l] != 0.0f;
    for (int m = 0; m < l && first; ++m) first = !(s_qw[m] != 0.0f && s_qt[m] == s_qt[l]);
    s_flag[l] = first;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lq; l += blockDim.x) {
    if (!s_flag[l]) continue;
    const int t = s_qt[l];
    float v = 0.0f;
    int rank = 0;
    for (int m = 0; m < lq; ++m) {
      if (s_qt[m] == t && s_qw[m] != 0.0f) v = __fadd_rn(v, s_qw[m]);
      rank += s_flag[m] && s_qt[m] < t;
    }
    s_terms[rank] = t;
    s_vals[rank] = v;
  }
  if (threadIdx.x == 0) {
    int n = 0;
    for (int l = 0; l < lq; ++l) n += s_flag[l];
    *s_n = n;
  }
  __syncthreads();
}

// Score of one doc, computed by the 32 lanes of the calling warp: lane i
// adds the matching terms j = i, i + 32, ... (reads of a row are coalesced;
// a weight is read only where its term matches), then a butterfly sum gives
// every lane the same total. Product and sum are rounded separately (no
// FMA), so the same row gives the same bits in every kernel.
__device__ __forceinline__ float warp_doc_score(const int* __restrict__ terms,
                                                const float* __restrict__ weights, int tmax,
                                                const int* s_terms, const float* s_vals,
                                                int n_q) {
  float acc = 0.0f;
  for (int j = threadIdx.x & 31; j < tmax; j += 32) {
    const int t = __ldg(terms + j);
    int lo = 0, hi = n_q;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_terms[mid] < t) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < n_q && s_terms[lo] == t) acc = __fadd_rn(acc, __fmul_rn(__ldg(weights + j), s_vals[lo]));
  }
  for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

}  // namespace repro_torch
