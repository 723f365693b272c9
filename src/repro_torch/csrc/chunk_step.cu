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
// Bound on the H100: memory. A trip reads the term ids of the live selected
// blocks' doc rows up to each doc's padding (about 199 of 650 slots a row
// in spladev2), a weight only where a term matches, the live bit of each
// of those docs, and the query's bound and processed rows (5 B per block),
// and writes the pool, theta and the processed row once per launch.
//
// What held the earlier design back (1.059 ms a trip against a 0.102 ms
// bound counted on padded rows; chip_smoke.py on an NVIDIA H100 80GB HBM3,
// 700.00 W): one 1,024-thread CTA per query, so a 64-query batch
// ran on 64 of the 132 SMs; a warp with one 128-B load in flight at a time
// (score_common.cuh); every row read to Tmax, two thirds of it padding;
// and two bitonic sorts of 4,096 keys a trip, one to select 16 blocks and
// one to merge k = 10 pool entries with 2,048 candidates.
//
// Design. The TPU kernel kept the state in VMEM and double-buffered each
// block's rows by DMA. Here a thread-block cluster of C CTAs owns one query
// (C from the batch and the SM count, chosen by the wrapper: 2 at B = 64 on
// 132 SMs, 8 at B = 1) and keeps the state in shared memory across the trips
// of a launch:
// * Every CTA of the cluster holds the query's bound row, its processed row
//   (1 B per block) and theta, and selects the same `budget` blocks with
//   block_select_desc (select_common.cuh), whose first key also gives the
//   multi-trip early exit. The CTAs compute from the same state, so they
//   take the same decisions and leave the loop together; none breaks alone
//   and deadlocks at cluster.sync().
// * The CTAs split the trip's candidate docs (warp g of the cluster takes
//   docs g, g + 32C, ...); a warp reads the live bits of 32 of its docs at
//   once and scores the docs that need it with the shared scorer
//   (score_common.cuh: 8 chunks of term ids in flight, a filter of the query's
//   terms, a stop at the row's padding), and writes each score into the
//   leader CTA's candidate array through distributed shared memory.
// * After cluster.sync() the leader merges: a candidate whose key is not
//   above the pool's lowest key loses to all k pool entries (they come
//   first and score at least as high), so only the candidates above it are
//   packed beside the pool and sorted, k + that count rounded up to a power
//   of two, and not at all when none is above it and the pool is in order.
//   The leader writes the new theta into every CTA; a second cluster.sync()
//   ends the trip.
// Scoring is the same device function as sparse_score's, so fused and split
// mode agree bit for bit; blocks that are not live and pad or tombstoned
// docs are not read at all. A trip of a 64-query spladev2 batch at the
// 276,307-doc shard: 0.194 ms, against a bound of 0.036 ms on the term
// slots its docs need (0.102 ms on whole rows); a trip that scores nothing
// costs 0.025 ms (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W). Neither
// more chunks of term ids in flight per warp nor loading the next doc's ids
// under this doc's weight loads made a trip faster on that card; what holds
// it at 5x its bound is open (PERF.md).
#include <cooperative_groups.h>

#include "launch_plan.cuh"
#include "score_common.cuh"
#include "select_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

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
                  int list_len, int n_keys) {
  extern __shared__ unsigned long long s_key[];  // n_keys: select lists, then merge keys
  const int n_cand = budget * bs;
  unsigned long long* s_sel = s_key + n_keys;                  // budget
  float* s_ub = reinterpret_cast<float*>(s_sel + budget);       // nb
  float* s_cand = s_ub + nb;                                    // n_cand (leader's is read)
  float* s_pool_s = s_cand + n_cand;                            // k (leader only)
  int* s_pool_i = reinterpret_cast<int*>(s_pool_s + k);         // k (leader only)
  int* s_bsel = s_pool_i + k;                                   // budget
  unsigned char* s_proc = reinterpret_cast<unsigned char*>(s_bsel + budget);  // nb
  unsigned char* s_blive = s_proc + nb;                                       // budget
  __shared__ int s_qt[repro_torch::MAX_LQ];
  __shared__ float s_qw[repro_torch::MAX_LQ];
  __shared__ unsigned char s_flag[repro_torch::MAX_LQ];
  __shared__ int s_terms[repro_torch::MAX_LQ];
  __shared__ float s_vals[repro_torch::MAX_LQ];
  __shared__ unsigned s_filter[repro_torch::FILTER_WORDS];
  __shared__ int s_n;
  __shared__ float s_theta;
  __shared__ unsigned s_pool_min;  // ordered bits of the pool's lowest score (leader)
  __shared__ int s_unsorted;       // the pool is out of key order (leader)
  __shared__ int s_count;          // candidates above the pool's lowest key (leader)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const bool leader = rank == 0;
  const size_t row = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float neg_inf = __int_as_float(0xff800000);
  repro_torch::load_query_table(qt + row * lq, qw + row * lq, lq, s_qt, s_qw, s_flag, s_terms,
                                s_vals, &s_n, s_filter);
  const int n_q = s_n;
  for (int j = tid; j < nb; j += blockDim.x) {
    s_ub[j] = __ldg(ub + row * nb + j);
    s_proc[j] = proc_in[row * nb + j];
  }
  if (tid == 0) {
    s_theta = theta_in[row];
    s_pool_min = 0xFFFFFFFFu;
    s_unsorted = 0;
  }
  __syncthreads();
  if (leader) {
    for (int r = tid; r < k; r += blockDim.x) {
      const float s = pool_s_in[row * k + r];
      s_pool_s[r] = s;
      s_pool_i[r] = pool_i_in[row * k + r];
      atomicMin(&s_pool_min, repro_torch::ordered_bits(s));
      if (r + 1 < k &&
          repro_torch::ordered_bits(s) < repro_torch::ordered_bits(pool_s_in[row * k + r + 1])) {
        s_unsorted = 1;
      }
    }
  }
  const int n_trips = trips_left == nullptr ? trips : min(trips, trips_left[row]);
  float* lead_cand = cluster.map_shared_rank(s_cand, 0);
  cluster.sync();  // every CTA of the cluster runs before any reaches another's memory

  int done = 0;
  for (int t = 0; t < n_trips; ++t) {
    const float theta = s_theta;
    // select: the budget highest remaining bounds
    repro_torch::block_select_desc(
        [&](int j) { return repro_torch::select_key(s_proc[j] ? neg_inf : s_ub[j], j); }, nb,
        budget, list_len, s_key, [&](int r, unsigned long long key) { s_sel[r] = key; });
    // multi-trip early exit: the highest remaining bound is no longer above
    // theta; every CTA of the cluster reads the same state and leaves here
    if (trips_left != nullptr && !(repro_torch::key_score(s_sel[0]) > theta)) break;
    for (int c = tid; c < budget; c += blockDim.x) {
      const unsigned long long key = s_sel[c];
      s_bsel[c] = repro_torch::key_index(key);
      s_blive[c] = repro_torch::key_score(key) > theta;
    }
    __syncthreads();
    for (int c = tid; c < budget; c += blockDim.x) {
      if (s_blive[c]) s_proc[s_bsel[c]] = 1;
    }

    // score: warp g of the cluster takes candidates g, g + G, ...; its lanes
    // read the live bits of 32 of them at once
    const int g = rank * WARPS + (tid >> 5);
    const int G = csize * WARPS;
    for (int i0 = 0; g + G * i0 < n_cand; i0 += 32) {
      const int d = g + G * (i0 + lane);
      bool want = false;
      int gid = 0;
      if (d < n_cand) {
        const int c = d / bs;
        gid = s_bsel[c] * bs + (d - c * bs);
        want = s_blive[c] && gid < n_live && (live == nullptr || __ldg(live + gid) != 0);
        if (!want) lead_cand[d] = neg_inf;
      }
      unsigned todo = __ballot_sync(0xffffffffu, want);
      while (todo) {
        const int l = __ffs(todo) - 1;
        todo &= todo - 1;
        const size_t off = static_cast<size_t>(__shfl_sync(0xffffffffu, gid, l)) * tmax;
        const float s = repro_torch::warp_doc_score<true>(dt + off, dw + off, tmax, s_filter,
                                                          s_terms, s_vals, n_q);
        if (lane == 0) lead_cand[g + G * (i0 + l)] = s;
      }
    }
    cluster.sync();

    if (leader) {
      // merge: only candidates above the pool's lowest key can enter
      const unsigned pmin = s_pool_min;
      if (tid == 0) s_count = 0;
      __syncthreads();
      for (int d = tid; d < n_cand; d += blockDim.x) {
        const float s = s_cand[d];
        if (repro_torch::ordered_bits(s) > pmin) {
          s_key[k + atomicAdd(&s_count, 1)] = repro_torch::select_key(s, k + d);
        }
      }
      __syncthreads();
      const int count = s_count;
      if (count > 0 || s_unsorted) {
        int n_sort = 1;
        while (n_sort < k + count) n_sort <<= 1;
        for (int r = tid; r < n_sort; r += blockDim.x) {
          if (r < k) {
            s_key[r] = repro_torch::select_key(s_pool_s[r], r);
          } else if (r >= k + count) {
            s_key[r] = 0ull;
          }
        }
        __syncthreads();
        repro_torch::bitonic_sort_desc(s_key, n_sort);
        // the new pool, packed in place of its key, then written back
        for (int r = tid; r < k; r += blockDim.x) {
          const int pos = repro_torch::key_index(s_key[r]);
          float s;
          int id;
          if (pos < k) {
            s = s_pool_s[pos];
            id = s_pool_i[pos];
          } else {
            const int d = pos - k;
            const int c = d / bs;
            s = s_cand[d];
            id = s_bsel[c] * bs + (d - c * bs);
          }
          s_key[r] = (static_cast<unsigned long long>(__float_as_uint(s)) << 32) |
                     static_cast<unsigned>(id);
        }
        __syncthreads();
        for (int r = tid; r < k; r += blockDim.x) {
          const unsigned long long packed = s_key[r];
          s_pool_s[r] = __uint_as_float(static_cast<unsigned>(packed >> 32));
          s_pool_i[r] = static_cast<int>(static_cast<unsigned>(packed));
        }
        __syncthreads();
        if (tid == 0) {
          s_unsorted = 0;
          s_pool_min = repro_torch::ordered_bits(s_pool_s[k - 1]);
        }
      }
      if (tid < csize) *cluster.map_shared_rank(&s_theta, tid) = s_pool_s[k - 1];
    }
    cluster.sync();
    ++done;
  }

  if (leader) {
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
}

repro_torch::LaunchPlan plan(int B, int cluster, int smem) {
  return {dim3(B * cluster), THREADS, cluster, static_cast<size_t>(smem)};
}

int launch(const void* ub, const void* proc_in, const void* pool_s_in, const void* pool_i_in,
           const void* theta_in, const void* qt, const void* qw, const void* dt, const void* dw,
           const void* live, const void* trips_left, void* pool_s_out, void* pool_i_out,
           void* theta_out, void* proc_out, void* trips_done, int B, int nb, int k, int lq,
           int tmax, int budget, int bs, int n_live, int trips, int list_len, int n_keys,
           int cluster, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(chunk_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const repro_torch::LaunchPlan p = plan(B, cluster, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, chunk_step_kernel, static_cast<const float*>(ub),
      static_cast<const unsigned char*>(proc_in), static_cast<const float*>(pool_s_in),
      static_cast<const int*>(pool_i_in), static_cast<const float*>(theta_in),
      static_cast<const int*>(qt), static_cast<const float*>(qw), static_cast<const int*>(dt),
      static_cast<const float*>(dw), static_cast<const int*>(live),
      static_cast<const int*>(trips_left), static_cast<float*>(pool_s_out),
      static_cast<int*>(pool_i_out), static_cast<float*>(theta_out),
      static_cast<unsigned char*>(proc_out), static_cast<int*>(trips_done), nb, k, lq, tmax,
      budget, bs, n_live, trips, list_len, n_keys);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One trip for every row. ub f32[B, nb], proc bool[B, nb], pool f32/i32[B, k],
// theta f32[B], qt i32/qw f32[B, lq] (lq <= MAX_LQ, weight-0 slots add
// nothing), doc store i32/f32[nb * bs, tmax] (each row its doc's distinct
// terms, then one pad term to its end), live i32[nb * bs] or null -> the new
// pool, theta and processed row. budget <= nb; cluster CTAs per row (1 to 8);
// list_len = min(budget, 32 * ceil(nb / 1024)); n_keys = max(32 * list_len,
// next power of two of k + budget * bs); smem the bytes of the layout at the
// head of chunk_step_kernel.
extern "C" int chunk_step_launch(const void* ub, const void* proc_in, const void* pool_s_in,
                                 const void* pool_i_in, const void* theta_in, const void* qt,
                                 const void* qw, const void* dt, const void* dw,
                                 const void* live, void* pool_s_out, void* pool_i_out,
                                 void* theta_out, void* proc_out, int B, int nb, int k, int lq,
                                 int tmax, int budget, int bs, int n_live, int list_len,
                                 int n_keys, int cluster, int smem, void* stream) {
  return launch(ub, proc_in, pool_s_in, pool_i_in, theta_in, qt, qw, dt, dw, live, nullptr,
                pool_s_out, pool_i_out, theta_out, proc_out, nullptr, B, nb, k, lq, tmax,
                budget, bs, n_live, 1, list_len, n_keys, cluster, smem, stream);
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
                                       int budget, int bs, int n_live, int trips, int list_len,
                                       int n_keys, int cluster, int smem, void* stream) {
  return launch(ub, proc_in, pool_s_in, pool_i_in, theta_in, qt, qw, dt, dw, live, trips_left,
                pool_s_out, pool_i_out, theta_out, proc_out, trips_done, B, nb, k, lq, tmax,
                budget, bs, n_live, trips, list_len, n_keys, cluster, smem, stream);
}

// The launch shapes of the two launchers above for the same ints.
extern "C" int chunk_step_plan(int B, int nb, int k, int lq, int tmax, int budget, int bs,
                               int n_live, int list_len, int n_keys, int cluster, int smem,
                               int* out) {
  return repro_torch::write_plan(plan(B, cluster, smem), out);
}

extern "C" int chunk_step_multi_plan(int B, int nb, int k, int lq, int tmax, int budget, int bs,
                                     int n_live, int trips, int list_len, int n_keys, int cluster,
                                     int smem, int* out) {
  return repro_torch::write_plan(plan(B, cluster, smem), out);
}
