// impact_scatter_topk: the fused SAAT scatter and per-block top-k. For each
// (query b, block of block_d docs) it sums the block's accumulator exactly
// as impact_scatter does, masks pad docs (id >= n_live) and tombstoned docs
// (live[id] == 0) to -inf, and emits the block's k best (score, doc id)
// pairs, highest score first and the lowest doc id first among equal
// scores, -inf included. A merge over the [B, n_blocks, k] pool outside the
// kernel gives the exact global top-k. This kernel takes gathered postings
// sorted by doc; impact_scatter_topk_segments, further down, computes the
// same pool from the SAAT plan and the posting store, the engine's route.
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

// ---------------------------------------------------------------------------
// impact_scatter_topk_segments: the same per-block candidates, read straight
// from the index through the SAAT plan. On the engine's fused route it is the
// counterpart of the Pallas TPU kernel
//   src/repro/kernels/impact_scatter_topk/kernel.py:impact_scatter_topk_batched_kernel
// together with the gather of a [B, rho] posting array and its sort by doc
// that the reference runs before that kernel, and that this port ran too
// (PERF.md: the gather, the sort and their passes took about 11.5 s of 15 s
// busy in a 30 s serving window on an NVIDIA H100 80GB HBM3 at 700 W, B1
// itself 0.47 s).
//
// What the gather and the sort recovered is in the index already: each
// term's postings are stored in segments of one impact, each segment in
// ascending doc order, a doc at most once in a segment. Row b admits the
// plan's columns (segments, in decreasing contribution) up to the first
// whose inclusive prefix cum_len reaches limit = min(rho, total), that one
// cut to its first limit - cum_prev postings; each doc's terms, in the row
// order the stable doc sort kept, are its hits in those segments taken in
// plan order.
//
// Bound on the H100: memory, the admitted postings' doc ids (4 B each) read
// once; the searches below read a few more lines a segment. It runs at 0.66
// ms for B = 32 rows at rho = 1M (24.9M postings, a 0.03 ms bound), against
// 6.66 ms for the gather, the doc sort and the [B, P] entry it replaces
// (`chip_smoke.py --saat-cell` on an NVIDIA H100 80GB HBM3, 700 W); its
// layout sweep there favours more threads a window, that is more segment
// searches in flight: each search is a chain of dependent loads.
//
// Design. A CTA takes a (row, range of cta_docs docs), several pool blocks
// of block_d, so that each segment is searched once a range and not once a
// pool block. The row's admitted columns are taken in windows of one column
// a thread: each thread finds its segment's postings inside the range by two
// binary searches (the segment is sorted), and a block scan lays the
// window's postings out in plan order. That list is taken in pieces of
// PER_THREAD postings a thread: each posting's doc is read from doc_ids
// and counted in shared memory (integer atomics: the counts do not depend
// on their order), a scan turns the counts into runs, one a doc, and each
// posting claims a place in its doc's run. The claims come in any order, so
// each doc's owner thread orders its run by column, which is plan order
// since a column holds the doc once, and adds the run's contributions one
// at a time onto the doc's running sum in shared memory. Pieces and windows
// go in plan order, so every doc's terms are added in row order from 0, as
// block_doc_sums adds them: every score keeps its bits. Then pad and
// tombstoned docs are masked to -inf, and each warp keeps one pool block's
// k best by warp_select_desc, with the keys of select_common.cuh.
//
// Shared memory: the running sums and the counts (4 B x cta_docs each), the
// window's columns (first posting, list offset, contribution: 12 B a
// thread) and the ordered list (2 B a posting of a piece).

// The first i in [0, n) with a[i] >= lo, and the first with a[i] >= hi (n
// where there is none): one thread's two binary searches, stepped together
// so that each round's two loads are in flight at once.
__device__ __forceinline__ int2 lower_bounds(const int* __restrict__ a, int n, int lo, int hi) {
  int b0 = 0, n0 = n, b1 = 0, n1 = n;
  while (n0 > 0 || n1 > 0) {
    const int h0 = n0 >> 1;
    const int h1 = n1 >> 1;
    const bool below0 = n0 > 0 && __ldg(a + b0 + h0) < lo;
    const bool below1 = n1 > 0 && __ldg(a + b1 + h1) < hi;
    if (n0 > 0) {
      b0 = below0 ? b0 + h0 + 1 : b0;
      n0 = below0 ? n0 - h0 - 1 : h0;
    }
    if (n1 > 0) {
      b1 = below1 ? b1 + h1 + 1 : b1;
      n1 = below1 ? n1 - h1 - 1 : h1;
    }
  }
  return make_int2(b0, b1);
}

// Exclusive prefix sum of v over the block's threads (in thread order);
// *total gets the sum. scratch: 32 ints. Every thread calls it; it returns
// after a barrier, with scratch free again.
__device__ __forceinline__ int block_exclusive_sum(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? scratch[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  *total = scratch[n_warps - 1];
  const int out = (warp ? scratch[warp - 1] : 0) + x - v;
  __syncthreads();
  return out;
}

// Postings a thread a piece (the wrapper's SEGMENT_PER_THREAD).
constexpr int PER_THREAD = 16;

__global__ void impact_scatter_topk_segments_kernel(
    const int* __restrict__ doc_ids, const int* __restrict__ starts,
    const float* __restrict__ contribs, const int* __restrict__ cum,
    const int* __restrict__ live, float* __restrict__ out_s, int* __restrict__ out_i, int C,
    int rho, int n_docs, int n_live, int block_d, int k, int cta_docs) {
  extern __shared__ float s_acc[];                                  // cta_docs running sums
  int* s_pos = reinterpret_cast<int*>(s_acc + cta_docs);            // cta_docs counts, then runs
  int* s_beg = s_pos + cta_docs;                                    // a column's first posting
  int* s_off = s_beg + blockDim.x;                                  // its offset in the list, + end
  float* s_con = reinterpret_cast<float*>(s_off + blockDim.x + 1);  // its contribution
  unsigned short* s_ent = reinterpret_cast<unsigned short*>(s_con + blockDim.x);  // a piece
  __shared__ int s_scan[32];
  __shared__ int s_cols;

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int dpt = cta_docs / T;
  const size_t row = blockIdx.y;
  const int lo = blockIdx.x * cta_docs;
  const int hi = min(lo + cta_docs, n_docs);
  const int* crow = cum + row * C;
  const int limit = min(rho, __ldg(crow + C - 1));
  if (t < 32) {  // the admitted columns: through the first whose cum_len reaches the limit
    const int last = repro_torch::warp_lower_bound(crow, 0, C, limit);
    if (t == 0) s_cols = limit > 0 ? last + 1 : 0;
  }
  for (int q = 0; q < dpt; ++q) {
    s_acc[t + q * T] = 0.0f;
    s_pos[t + q * T] = 0;
  }
  __syncthreads();
  const int n_cols = s_cols;
  for (int w0 = 0; w0 < n_cols; w0 += T) {
    const int j = w0 + t;
    int n = 0;
    if (j < n_cols) {
      const int prev = j > 0 ? __ldg(crow + j - 1) : 0;
      const int len = min(__ldg(crow + j), limit) - prev;  // the last column is cut
      const int start = __ldg(starts + row * C + j);
      const int2 at = lower_bounds(doc_ids + start, len, lo, hi);
      n = at.y - at.x;
      s_beg[t] = start + at.x;
      s_con[t] = __ldg(contribs + row * C + j);
    }
    int n_list;
    const int off = block_exclusive_sum(n, s_scan, &n_list);
    s_off[t] = off;
    if (t == 0) s_off[T] = n_list;
    __syncthreads();
    for (int p0 = 0; p0 < n_list; p0 += PER_THREAD * T) {
      unsigned staged[PER_THREAD];  // (local doc << 16) | column, or ~0u past the list
#pragma unroll
      for (int r = 0; r < PER_THREAD; ++r) {
        const int p = p0 + t + r * T;
        staged[r] = ~0u;
        if (p < n_list) {
          int c = 0;  // the column of list position p: the last with s_off[c] <= p
          for (int len = T + 1; len > 0;) {
            const int half = len >> 1;
            if (s_off[c + half] <= p) {
              c += half + 1;
              len -= half + 1;
            } else {
              len = half;
            }
          }
          --c;
          const int d = __ldg(doc_ids + s_beg[c] + (p - s_off[c])) - lo;
          atomicAdd(s_pos + d, 1);
          staged[r] = (static_cast<unsigned>(d) << 16) | static_cast<unsigned>(c);
        }
      }
      __syncthreads();
      // one run a doc, in owner order (thread t, then its docs t + q T): run ends
      int mine = 0;
      for (int q = 0; q < dpt; ++q) mine += s_pos[t + q * T];
      int n_piece;
      int end = block_exclusive_sum(mine, s_scan, &n_piece);
      for (int q = 0; q < dpt; ++q) {
        end += s_pos[t + q * T];
        s_pos[t + q * T] = end;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < PER_THREAD; ++r) {
        if (staged[r] != ~0u) {
          const int at = atomicSub(s_pos + (staged[r] >> 16), 1) - 1;
          s_ent[at] = static_cast<unsigned short>(staged[r] & 0xffffu);
        }
      }
      __syncthreads();
      // s_pos now holds each run's start; a run ends where the next begins
      for (int q = 0; q < dpt; ++q) {
        const int d = t + q * T;
        const int beg = s_pos[d];
        const int stop = q + 1 < dpt ? s_pos[d + T] : (t + 1 < T ? s_pos[t + 1] : n_piece);
        if (stop <= beg) continue;
        for (int i = beg + 1; i < stop; ++i) {  // order the run by column: plan order
          const unsigned short v = s_ent[i];
          int m = i - 1;
          for (; m >= beg && s_ent[m] > v; --m) s_ent[m + 1] = s_ent[m];
          s_ent[m + 1] = v;
        }
        float acc = s_acc[d];
        for (int i = beg; i < stop; ++i) acc += s_con[s_ent[i]];
        s_acc[d] = acc;
      }
      __syncthreads();
      for (int q = 0; q < dpt; ++q) s_pos[t + q * T] = 0;  // the next piece counts anew
      __syncthreads();
    }
  }
  for (int q = 0; q < dpt; ++q) {
    const int gid = lo + t + q * T;
    if (gid < hi && !(gid < n_live && (live == nullptr || __ldg(live + gid) != 0))) {
      s_acc[t + q * T] = __int_as_float(0xff800000);  // -inf
    }
  }
  __syncthreads();
  const int n_blocks = n_docs / block_d;
  const int n_sub = (hi - lo) / block_d;
  for (int sb = t >> 5; sb < n_sub; sb += T >> 5) {
    const float* v = s_acc + sb * block_d;
    const size_t o = (row * n_blocks + lo / block_d + sb) * k;
    repro_torch::warp_select_desc(
        [&](int i) { return repro_torch::select_key(v[i], i); }, block_d, k,
        [&](int r, unsigned long long key) {
          const int idx = repro_torch::key_index(key);
          out_s[o + r] = v[idx];
          out_i[o + r] = lo + sb * block_d + idx;
        });
  }
}

repro_torch::LaunchPlan segments_plan(int B, int n_docs, int cta_docs, int threads, int smem) {
  return {dim3((n_docs + cta_docs - 1) / cta_docs, B), threads, 1, static_cast<size_t>(smem)};
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

// doc_ids i32[P] (each segment ascending, a doc at most once in it), the
// plan's starts i32[B, C], contribs f32[B, C] and inclusive cum_len i32[B, C],
// live i32[n_docs] or null -> out_s f32[B, n_docs / block_d, k], out_i
// i32[B, n_docs / block_d, k]. Admits min(rho, cum_len[b, C - 1]) postings of
// row b. n_docs % block_d == 0; block_d a power of two in [64, 1024];
// 0 < k <= block_d; cta_docs a power of two, a multiple of block_d and of
// threads, at most 65,536; threads a multiple of 32 in [64, 1024]. smem as
// the wrapper lays it out (segments_layout in
// kernels/impact_scatter_topk/ops.py), its piece PER_THREAD x threads.
extern "C" int impact_scatter_topk_segments_plan(int B, int C, int rho, int n_docs, int n_live,
                                                 int block_d, int k, int cta_docs, int threads,
                                                 int smem, int* out) {
  return repro_torch::write_plan(segments_plan(B, n_docs, cta_docs, threads, smem), out);
}

extern "C" int impact_scatter_topk_segments_launch(const void* doc_ids, const void* starts,
                                                   const void* contribs, const void* cum,
                                                   const void* live, void* out_s, void* out_i,
                                                   int B, int C, int rho, int n_docs, int n_live,
                                                   int block_d, int k, int cta_docs, int threads,
                                                   int smem, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      impact_scatter_topk_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const repro_torch::LaunchPlan p = segments_plan(B, n_docs, cta_docs, threads, smem);
  impact_scatter_topk_segments_kernel<<<p.grid, p.threads, p.smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(doc_ids), static_cast<const int*>(starts),
      static_cast<const float*>(contribs), static_cast<const int*>(cum),
      static_cast<const int*>(live), static_cast<float*>(out_s), static_cast<int*>(out_i), C,
      rho, n_docs, n_live, block_d, k, cta_docs);
  return static_cast<int>(cudaGetLastError());
}
