// Shared device code of the two DAAT scorers (sparse_score.cu and the fused
// chunk_step.cu): the query's term table in shared memory and one doc's
// score, so split mode and fused mode give bit-identical scores, thresholds
// and work counts on the card.
//
// A doc's score is sum_j w_dj * qv(term_dj), with
// qv(t) = sum_l [t == qt_l] * qw_l added in slot order, so duplicate query
// terms sum and slots of weight 0 add nothing.
//
// Bound: the bytes of the doc rows. A scorer reads each term id it needs
// once (4 B) and a weight (4 B) only where the term matches a query term;
// the matching is a few integer operations per term slot.
//
// What held the earlier scorer back (the fused trip at 10.4x its bound,
// chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W): each lane loaded one
// term id, then ran a dependent binary search of about 6 shared-memory
// steps over the query's terms before it issued the next load, so a warp
// had one 128-B load in flight; and it read every row to Tmax, though a
// learned-sparse doc fills about a third of its row (199 of 650 slots in
// spladev2), the rest being the pad term.
//
// What it does now:
// * A warp issues the loads of SCORE_CHUNKS chunks of 32 term ids (1 KB)
//   before it looks at any of them, then the weight loads of all the
//   chunks' matches before it adds any of them.
// * A term is first tested against a 65,536-bit hashed filter of the
//   query's terms in shared memory (one load; most terms of a doc match no
//   query term); only a term whose bit is set is looked up by binary search.
// * With stop_at_pad (chunk_step, which reads the index's doc-major store),
//   the warp stops at the first chunk whose valid slots (two or more) all
//   hold one term id. In that store a row holds its doc's distinct terms
//   and then the pad term V to its end (core/impact_index.py), so such a
//   chunk is padding and so is the rest of the row. A pad term matches no
//   query term, so stopping adds nothing different.
// Lane i still adds its matches j = i, i + 32, ... in order of j, and the
// warp sums the lanes with the same butterfly, so a score's bits are what
// the earlier scorer gave, in both kernels.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int MAX_LQ = 256;
constexpr int FILTER_WORDS = 2048;  // 65,536 bits, 8 KB
constexpr int SCORE_CHUNKS = 8;     // chunks of 32 term ids in flight per warp

// The query's distinct terms of nonzero weight, ascending, each with qv(t),
// in s_terms/s_vals[0, *s_n), and their hashed filter in s_filter. Every
// thread of the block calls it; it returns after a __syncthreads(). s_flag
// holds MAX_LQ bytes of scratch, s_qt/s_qw MAX_LQ entries each, s_filter
// FILTER_WORDS words; lq <= MAX_LQ.
__device__ __forceinline__ void load_query_table(const int* __restrict__ qt,
                                                 const float* __restrict__ qw, int lq,
                                                 int* s_qt, float* s_qw, unsigned char* s_flag,
                                                 int* s_terms, float* s_vals, int* s_n,
                                                 unsigned* s_filter) {
  for (int l = threadIdx.x; l < lq; l += blockDim.x) {
    s_qt[l] = __ldg(qt + l);
    s_qw[l] = __ldg(qw + l);
  }
  for (int w = threadIdx.x; w < FILTER_WORDS; w += blockDim.x) s_filter[w] = 0u;
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
    atomicOr(s_filter + ((t >> 5) & (FILTER_WORDS - 1)), 1u << (t & 31));
  }
  if (threadIdx.x == 0) {
    int n = 0;
    for (int l = 0; l < lq; ++l) n += s_flag[l];
    *s_n = n;
  }
  __syncthreads();
}

// The slot of term t in s_terms, or -1 when t is not a query term.
__device__ __forceinline__ int query_slot(int t, const unsigned* s_filter, const int* s_terms,
                                          int n_q) {
  if (!((s_filter[(t >> 5) & (FILTER_WORDS - 1)] >> (t & 31)) & 1u)) return -1;
  int lo = 0, hi = n_q;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_terms[mid] < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n_q && s_terms[lo] == t ? lo : -1;
}

// Score of one doc, computed by the 32 lanes of the calling warp (all of
// them call it): lane i adds the matching terms j = i, i + 32, ... (reads
// of a row are coalesced; a weight is read only where its term matches),
// then a butterfly sum gives every lane the same total. Product and sum are
// rounded separately (no FMA), so the same row gives the same bits in
// every kernel. stop_at_pad: see the head of this file.
template <bool stop_at_pad>
__device__ __forceinline__ float warp_doc_score(const int* __restrict__ terms,
                                                const float* __restrict__ weights, int tmax,
                                                const unsigned* s_filter, const int* s_terms,
                                                const float* s_vals, int n_q) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int c0 = 0; c0 < tmax; c0 += 32 * SCORE_CHUNKS) {
    int t[SCORE_CHUNKS];
#pragma unroll
    for (int u = 0; u < SCORE_CHUNKS; ++u) {
      const int j = c0 + 32 * u + lane;
      t[u] = j < tmax ? __ldg(terms + j) : 0;
    }
    int slot[SCORE_CHUNKS];
    bool stop = false;
#pragma unroll
    for (int u = 0; u < SCORE_CHUNKS; ++u) {
      const int base = c0 + 32 * u;
      const bool valid = base + lane < tmax;
      if (stop_at_pad && !stop) {
        const int t0 = __shfl_sync(0xffffffffu, t[u], 0);
        const bool same = __all_sync(0xffffffffu, !valid || t[u] == t0);
        stop = base >= tmax || (base + 1 < tmax && same);
      }
      slot[u] = valid && !stop ? query_slot(t[u], s_filter, s_terms, n_q) : -1;
    }
    float w[SCORE_CHUNKS];
#pragma unroll
    for (int u = 0; u < SCORE_CHUNKS; ++u) {
      w[u] = slot[u] >= 0 ? __ldg(weights + c0 + 32 * u + lane) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SCORE_CHUNKS; ++u) {
      if (slot[u] >= 0) acc = __fadd_rn(acc, __fmul_rn(w[u], s_vals[slot[u]]));
    }
    if (stop) break;
  }
  for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

}  // namespace repro_torch
