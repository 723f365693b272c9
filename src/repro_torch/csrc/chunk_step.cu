// chunk_step: the fused DAAT phase-2 trip, select + score + merge, for each
// query of a batch:
//   1. select the `budget` blocks of highest remaining bound
//      (processed blocks count as -inf; ties to the lowest block id);
//   2. a selected block is live when its bound is above theta;
//   3. score the live blocks' docs from the doc-major store; pad docs
//      (id >= n_live), tombstoned docs (live[id] == 0) and the docs of
//      blocks that are not live score -inf;
//   4. merge pool then candidates into the new top-k (ties to the earlier
//      position, as merge_topk does), theta = the k-th score, and mark the
//      live selected blocks processed.
// The multi-trip launcher runs up to `trips` of these per query in one
// launch: a row runs trip t only while t < trips_left[row] and its highest
// remaining bound is above theta, and it reports how many trips it ran.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/chunk_step/kernel.py:chunk_step_batched_kernel (one trip)
//   src/repro/kernels/chunk_step/kernel.py:chunk_step_multi_batched_kernel
// which share the trip body _trip_body, as the two launchers below share
// chunk_step_kernel.
//
// Bound on the H100: memory. A trip reads the term ids of the selected
// blocks' doc rows (budget x bs x Tmax x 4 B per query: 5.3 MB at 16 x 128
// x 650), a weight only where a term matches, and the query's bound and
// processed rows (5 B per block), and writes the pool, theta and the
// processed row once per launch.
//
// Design. The TPU kernel kept the state in VMEM and double-buffered each
// block's rows by DMA. Here one CTA owns one query and keeps its whole state
// in shared memory across the trips of a launch: the processed row (1 B per
// block), the pool, theta, the candidate tile (budget x bs scores and ids)
// and one buffer of packed 64-bit keys (select_common.cuh) that serves both
// selections: the next power of two of max(n_blocks, k + budget x bs) keys,
// 4,096 (32 KB) at a 276k-doc shard. Selection is a bitonic sort of the
// remaining bounds, whose first key also gives the early-exit test; the
// merge is a second sort of the pool and candidates by position. Scoring is
// sparse_score's warp-per-doc device function (score_common.cuh), so fused
// and split mode agree bit for bit; blocks that are not live and pad docs
// are not read at all. One CTA per query is 64 CTAs for a 64-query batch on
// 132 SMs: that, not the memory, limits this kernel.
#include "score_common.cuh"
#include "select_common.cuh"

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
chunk_step_kernel(const float* __restrict__ ub, const unsigned char* __restrict__ proc_in,
                  const float* __restrict__ pool_s_in, const int* __restrict__ pool_i_in,
                  const float* __restrict__ theta_in, const int* __restrict__ qt,
                  const float* __restrict__ qw, const int* __restrict__ dt,
                  const float* __restrict__ dw, const int* __restrict__ live,
                  const int* __restrict__ trips_left, float* __restrict__ pool_s_out,
                  int* __restrict__ pool_i_out, float* __restrict__ theta_out,
                  unsigned char* __restrict__ proc_out, int* __restrict__ trips_done,
                  int nb, int k, int lq, int tmax, int budget, int bs, int n_live, int trips,
                  int n_keys) {
  extern __shared__ unsigned long long s_key[];  // n_keys, then the arrays below
  const int n_cand = budget * bs;
  float* s_all_s = reinterpret_cast<float*>(s_key + n_keys);  // k + n_cand: pool, candidates
  int* s_all_i = reinterpret_cast<int*>(s_all_s + k + n_cand);
  float* s_pool_s = reinterpret_cast<float*>(s_all_i + k + n_cand);  // k
  int* s_pool_i = reinterpret_cast<int*>(s_pool_s + k);               // k
  int* s_bsel = s_pool_i + k;                                         // budget
  unsigned char* s_proc = reinterpret_cast<unsigned char*>(s_bsel + budget);  // nb
  unsigned char* s_blive = s_proc + nb;                                       // budget
  __shared__ int s_qt[repro_torch::MAX_LQ];
  __shared__ float s_qw[repro_torch::MAX_LQ];
  __shared__ unsigned char s_flag[repro_torch::MAX_LQ];
  __shared__ int s_terms[repro_torch::MAX_LQ];
  __shared__ float s_vals[repro_torch::MAX_LQ];
  __shared__ int s_n;
  __shared__ float s_theta;

  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const float neg_inf = __int_as_float(0xff800000);
  repro_torch::load_query_table(qt + row * lq, qw + row * lq, lq, s_qt, s_qw, s_flag, s_terms,
                                s_vals, &s_n);
  const int n_q = s_n;
  for (int j = tid; j < nb; j += blockDim.x) s_proc[j] = proc_in[row * nb + j];
  for (int r = tid; r < k; r += blockDim.x) {
    s_pool_s[r] = pool_s_in[row * k + r];
    s_pool_i[r] = pool_i_in[row * k + r];
  }
  if (tid == 0) s_theta = theta_in[row];
  const int n_trips = trips_left == nullptr ? trips : min(trips, trips_left[row]);
  __syncthreads();

  int done = 0;
  for (int t = 0; t < n_trips; ++t) {
    const float theta = s_theta;
    // select: the budget highest remaining bounds
    for (int j = tid; j < n_keys; j += blockDim.x) {
      s_key[j] = j < nb ? repro_torch::select_key(s_proc[j] ? neg_inf : __ldg(ub + row * nb + j), j)
                        : 0ull;
    }
    __syncthreads();
    repro_torch::bitonic_sort_desc(s_key, n_keys);
    // multi-trip early exit: the highest remaining bound is no longer above theta
    if (trips_left != nullptr && !(repro_torch::key_score(s_key[0]) > theta)) break;
    for (int c = tid; c < budget; c += blockDim.x) {
      const unsigned long long key = s_key[c];
      s_bsel[c] = repro_torch::key_index(key);
      s_blive[c] = repro_torch::key_score(key) > theta;
    }
    __syncthreads();

    // score: one warp per candidate doc
    for (int d = tid >> 5; d < n_cand; d += blockDim.x >> 5) {
      const int c = d / bs;
      const int gid = s_bsel[c] * bs + (d - c * bs);
      float s = neg_inf;
      if (s_blive[c] && gid < n_live && (live == nullptr || __ldg(live + gid) != 0)) {
        const size_t off = static_cast<size_t>(gid) * tmax;
        s = repro_torch::warp_doc_score(dt + off, dw + off, tmax, s_terms, s_vals, n_q);
      }
      if ((tid & 31) == 0) {
        s_all_s[k + d] = s;
        s_all_i[k + d] = gid;
      }
    }
    for (int r = tid; r < k; r += blockDim.x) {
      s_all_s[r] = s_pool_s[r];
      s_all_i[r] = s_pool_i[r];
    }
    __syncthreads();

    // merge: pool first, then candidates, by position among equal scores
    for (int j = tid; j < n_keys; j += blockDim.x) {
      s_key[j] = j < k + n_cand ? repro_torch::select_key(s_all_s[j], j) : 0ull;
    }
    __syncthreads();
    repro_torch::bitonic_sort_desc(s_key, n_keys);
    for (int r = tid; r < k; r += blockDim.x) {
      const int pos = repro_torch::key_index(s_key[r]);
      s_pool_s[r] = s_all_s[pos];
      s_pool_i[r] = s_all_i[pos];
    }
    for (int c = tid; c < budget; c += blockDim.x) {
      if (s_blive[c]) s_proc[s_bsel[c]] = 1;
    }
    __syncthreads();
    if (tid == 0) s_theta = s_pool_s[k - 1];
    ++done;
    __syncthreads();
  }

  for (int j = tid; j < nb; j += blockDim.x) proc_out[row * nb + j] = s_proc[j];
  for (int r = tid; r < k; r += blockDim.x) {
    pool_s_out[row * k + r] = s_pool_s[r];
    pool_i_out[row * k + r] = s_pool_i[r];
  }
  if (tid == 0) {
    theta_out[row] = s_theta;
    if (trips_done != nullptr) trips_done[row] = done;
  }
}

int launch(const void* ub, const void* proc_in, const void* pool_s_in, const void* pool_i_in,
           const void* theta_in, const void* qt, const void* qw, const void* dt, const void* dw,
           const void* live, const void* trips_left, void* pool_s_out, void* pool_i_out,
           void* theta_out, void* proc_out, void* trips_done, int B, int nb, int k, int lq,
           int tmax, int budget, int bs, int n_live, int trips, int n_keys, void* stream) {
  const int n_cand = budget * bs;
  const size_t smem = static_cast<size_t>(n_keys) * sizeof(unsigned long long) +
                      static_cast<size_t>(k + n_cand) * 8 + static_cast<size_t>(k) * 8 +
                      static_cast<size_t>(budget) * 4 + nb + budget;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_step_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ub), static_cast<const unsigned char*>(proc_in),
      static_cast<const float*>(pool_s_in), static_cast<const int*>(pool_i_in),
      static_cast<const float*>(theta_in), static_cast<const int*>(qt),
      static_cast<const float*>(qw), static_cast<const int*>(dt), static_cast<const float*>(dw),
      static_cast<const int*>(live), static_cast<const int*>(trips_left),
      static_cast<float*>(pool_s_out), static_cast<int*>(pool_i_out),
      static_cast<float*>(theta_out), static_cast<unsigned char*>(proc_out),
      static_cast<int*>(trips_done), nb, k, lq, tmax, budget, bs, n_live, trips, n_keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One trip for every row. ub f32[B, nb], proc bool[B, nb], pool f32/i32[B, k],
// theta f32[B], qt i32/qw f32[B, lq] (lq <= MAX_LQ, weight-0 slots add
// nothing), doc store i32/f32[nb * bs, tmax], live i32[nb * bs] or null ->
// the new pool, theta and processed row. budget <= nb; n_keys the next power
// of two of max(nb, k + budget * bs).
extern "C" int chunk_step_launch(const void* ub, const void* proc_in, const void* pool_s_in,
                                 const void* pool_i_in, const void* theta_in, const void* qt,
                                 const void* qw, const void* dt, const void* dw,
                                 const void* live, void* pool_s_out, void* pool_i_out,
                                 void* theta_out, void* proc_out, int B, int nb, int k, int lq,
                                 int tmax, int budget, int bs, int n_live, int n_keys,
                                 void* stream) {
  return launch(ub, proc_in, pool_s_in, pool_i_in, theta_in, qt, qw, dt, dw, live, nullptr,
                pool_s_out, pool_i_out, theta_out, proc_out, nullptr, B, nb, k, lq, tmax,
                budget, bs, n_live, 1, n_keys, stream);
}

// Up to `trips` trips per row, row b running at most trips_left[b] of them
// and stopping once its highest remaining bound is not above theta; writes
// trips_done i32[B] besides the state.
extern "C" int chunk_step_multi_launch(const void* ub, const void* proc_in,
                                       const void* pool_s_in, const void* pool_i_in,
                                       const void* theta_in, const void* qt, const void* qw,
                                       const void* dt, const void* dw, const void* live,
                                       const void* trips_left, void* pool_s_out,
                                       void* pool_i_out, void* theta_out, void* proc_out,
                                       void* trips_done, int B, int nb, int k, int lq, int tmax,
                                       int budget, int bs, int n_live, int trips, int n_keys,
                                       void* stream) {
  return launch(ub, proc_in, pool_s_in, pool_i_in, theta_in, qt, qw, dt, dw, live, trips_left,
                pool_s_out, pool_i_out, theta_out, proc_out, trips_done, B, nb, k, lq, tmax,
                budget, bs, n_live, trips, n_keys, stream);
}
