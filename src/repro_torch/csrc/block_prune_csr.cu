// block_prune_csr: DAAT phase 0, the block-max upper bound of every doc
// block straight off the CSR block-max lists,
//   ub[b, blk] = sum over slots l of qw[b, l] * bm_weight[i]
//                for the entries i of slot l's window with bm_block[i] == blk,
// and survive[b, blk] = (ub > theta[b]) && (ub > 0).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/block_prune_csr/kernel.py:block_prune_csr_batched_kernel
//
// Bound on the H100: memory. Each window entry is read once (8 B: a block id
// and a block maximum) and each (ub, survive) pair written once (5 B); the
// arithmetic is one multiply and one add per entry. One 64-query spladev2
// batch on a 276k-doc shard ([64, 35, 2159], 1,827,471 entries): 0.0046 ms.
//
// What held the earlier design back: one CTA per (query, tile of 4,096
// blocks), so 64 CTAs of 256 threads for that batch on 132 SMs, each a
// chain of 35 slots, each slot a round of strided loads and a barrier:
// 0.0938 ms replayed from a CUDA graph (NVIDIA H100 80GB HBM3, 700.00 W).
//
// Design. The TPU kernel densified every slot's window into an [Lq, NB]
// VMEM tile and contracted it with the query weights on the MXU. Here one
// CTA owns a (query, tile of `tile` blocks), so a batch fills the card
// (17 tiles of 128 for 2,159 blocks: 1,088 CTAs at B = 64), and it reads
// only its own entries. Within a term's list the block ids are distinct
// and ascend (the index is built from np.unique over term * n_blocks +
// block): that is the kernel's precondition. So in each slot's window the
// tile's entries are one sub-window [lo, hi), found by a search: one
// thread a bound, all slots' searches at once, each round 7 loads issued
// together (an 8-ary search). The search starts where distinct ids
// in [0, n_blocks) leave the answer: at most key and at least
// c - (n_blocks - key) of a window's c ids lie under key, so the first
// tile's start, the last tile's end and every bound of a window that holds
// (nearly) every block take no (or few) loads. The sub-windows of up to
// `group` slots (all of them, for every Lq the engine sees) are then read
// as one flat range, 4 entries a thread in flight, and each product is
// written to its (slot, block) cell of a dense [group, tile] tile in
// shared memory (a block appears at most once in a slot, so no two
// threads write one cell; the cells of absent entries stay 0). One barrier
// later each thread sums its block's column in slot order. So every bound
// is still summed slot by slot, as the reference's scatter-add and the
// plain version sum it; adding the 0 of an absent entry leaves a sum that
// starts at +0 unchanged in its bits; and the product and the sum are
// rounded separately (no FMA): ub is equal to the plain version bit for
// bit. A window is cut at the end of the lists, so no pad is needed behind
// them, and the last tile may be ragged.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, the
// engine's batch [64, 35, 2159] replayed from a CUDA graph: 0.0170 ms (the
// earlier design 0.0938; this one before the search's start range
// 0.0195), 3.7x the bound; back to back from Python 0.035 ms; B = 1:
// 0.0081 ms replayed. 128 blocks a CTA was the fastest tile of the sweep
// at B = 64, and 256 threads beat 128. What is left is each CTA's chain of
// dependent loads (the slot descriptors, up to 4 search rounds, the
// entries) and the launch.
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // window entries a thread has in flight
constexpr int PROBES = 7;  // loads a search round (an 8-ary search)

// First i in [lo, hi) with a[i] >= key (hi if none); a ascends on [lo, hi).
// Each round issues PROBES loads together and keeps the gap between the
// last probe under the key and the first at or over it.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo, int hi, int key) {
  while (hi - lo > PROBES) {
    const int step = (hi - lo) / (PROBES + 1);
    int v[PROBES];
#pragma unroll
    for (int q = 0; q < PROBES; ++q) v[q] = __ldg(a + lo + step * (q + 1));
    int new_lo = lo, new_hi = hi;
#pragma unroll
    for (int q = 0; q < PROBES; ++q) {
      if (v[q] < key) new_lo = lo + step * (q + 1) + 1;
    }
#pragma unroll
    for (int q = PROBES - 1; q >= 0; --q) {
      if (v[q] >= key) new_hi = lo + step * (q + 1);
    }
    lo = new_lo;
    hi = new_hi;
  }
  int below = 0;
#pragma unroll
  for (int q = 0; q < PROBES; ++q) {
    if (lo + q < hi && __ldg(a + lo + q) < key) ++below;
  }
  return lo + below;
}

__global__ void __launch_bounds__(THREADS)
block_prune_csr_kernel(const int* __restrict__ bm_block, const float* __restrict__ bm_weight,
                       const int* __restrict__ base, const int* __restrict__ cnt,
                       const float* __restrict__ qw, const float* __restrict__ theta,
                       float* __restrict__ ub, unsigned char* __restrict__ survive, int n_bm,
                       int lq, int n_blocks, int tile, int group) {
  extern __shared__ float smem[];
  float* s_dense = smem;                       // [group, tile]: a slot's products
  float* s_ub = s_dense + group * tile;        // [tile]: the bounds so far
  float* s_w = s_ub + tile;                    // [group]: the slots' query weights
  int* s_lo = reinterpret_cast<int*>(s_w + group);  // [group]: sub-window starts
  int* s_hi = s_lo + group;                    // [group]: sub-window ends
  int* s_pre = s_hi + group;                   // [group + 1]: offsets in the flat range
  const size_t row = blockIdx.y;
  const int tile0 = blockIdx.x * tile;
  const int width = min(tile, n_blocks - tile0);
  const int tile1 = tile0 + width;
  const int tid = threadIdx.x;
  for (int j = tid; j < width; j += THREADS) s_ub[j] = 0.0f;
  for (int g0 = 0; g0 < lq; g0 += group) {
    const int ng = min(group, lq - g0);
    // the sub-windows: thread t < ng finds slot t's start, ng <= t < 2 ng
    // slot t - ng's end; the others clear the dense tile meanwhile
    for (int t = tid; t < 2 * ng; t += THREADS) {
      const int l = t < ng ? t : t - ng;
      const size_t slot = row * lq + g0 + l;
      const int s = __ldg(base + slot);
      const int c = max(0, min(__ldg(cnt + slot), n_bm - s));
      // c distinct ids in [0, n_blocks): at most key of them, and at least
      // c - (n_blocks - key), lie under key; so the search starts in that
      // range (none at all at the first tile's start, the last tile's end
      // or a window that holds every block)
      const int key = t < ng ? tile0 : tile1;
      const int pos = lower_bound(bm_block, s + max(0, c - (n_blocks - key)),
                                  s + min(c, key), key);
      if (t < ng) {
        s_w[l] = __ldg(qw + slot);
        s_lo[l] = pos;
      } else {
        s_hi[l] = pos;
      }
    }
    for (int j = tid; j < ng * tile; j += THREADS) s_dense[j] = 0.0f;
    __syncthreads();
    if (tid < 32) {  // one warp: the flat range's offsets, an inclusive scan
      int carry = 0;
      for (int c0 = 0; c0 < ng; c0 += 32) {
        const int l = c0 + tid;
        int v = l < ng ? max(0, s_hi[l] - s_lo[l]) : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += y;
        }
        if (l < ng) s_pre[l + 1] = carry + v;
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
      if (tid == 0) s_pre[0] = 0;
    }
    __syncthreads();
    const int total = s_pre[ng];
    for (int j0 = tid; j0 < total; j0 += THREADS * UNROLL) {
      int slot[UNROLL], blk[UNROLL];
      float w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * THREADS;
        slot[u] = -1;
        blk[u] = -1;
        w[u] = 0.0f;
        if (j < total) {
          int l = 0, n = ng;  // the last slot whose range starts at or before j
          while (n > 0) {
            const int half = n >> 1;
            if (s_pre[l + half] <= j) {
              l += half + 1;
              n -= half + 1;
            } else {
              n = half;
            }
          }
          --l;
          const int i = s_lo[l] + (j - s_pre[l]);
          slot[u] = l;
          blk[u] = __ldg(bm_block + i) - tile0;
          w[u] = __ldg(bm_weight + i);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (slot[u] >= 0 && blk[u] >= 0 && blk[u] < width) {
          s_dense[slot[u] * tile + blk[u]] = __fmul_rn(w[u], s_w[slot[u]]);
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < width; j += THREADS) {
      float acc = s_ub[j];
      for (int l = 0; l < ng; ++l) acc = __fadd_rn(acc, s_dense[l * tile + j]);
      s_ub[j] = acc;
    }
    __syncthreads();
  }
  const float th = __ldg(theta + row);
  for (int j = tid; j < width; j += THREADS) {
    const float v = s_ub[j];
    ub[row * n_blocks + tile0 + j] = v;
    survive[row * n_blocks + tile0 + j] = (v > th) && (v > 0.0f);
  }
}

repro_torch::LaunchPlan plan(int B, int n_blocks, int tile, int group) {
  return {dim3((n_blocks + tile - 1) / tile, B), THREADS, 1,
          sizeof(float) * (static_cast<size_t>(group) * tile + tile + 4 * group + 1)};
}

}  // namespace

// bm_block i32[n_bm] (distinct ids in [0, n_blocks), ascending within each
// window), bm_weight f32[n_bm], base/cnt i32[B, lq] (windows [base, base +
// cnt), cnt already clamped to the per-term bound), qw f32[B, lq], theta
// f32[B] -> ub f32[B, n_blocks], survive bool[B, n_blocks]. tile blocks a
// CTA, group slots a round (ops.py: prune_csr_layout); smem =
// 4 * (group * tile + tile + 4 * group + 1).
extern "C" int block_prune_csr_plan(int B, int n_bm, int lq, int n_blocks, int tile, int group,
                                    int* out) {
  return repro_torch::write_plan(plan(B, n_blocks, tile, group), out);
}

extern "C" int block_prune_csr_launch(const void* bm_block, const void* bm_weight,
                                      const void* base, const void* cnt, const void* qw,
                                      const void* theta, void* ub, void* survive, int B,
                                      int n_bm, int lq, int n_blocks, int tile, int group,
                                      void* stream) {
  const repro_torch::LaunchPlan p = plan(B, n_blocks, tile, group);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_prune_csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  block_prune_csr_kernel<<<p.grid, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bm_block), static_cast<const float*>(bm_weight),
      static_cast<const int*>(base), static_cast<const int*>(cnt),
      static_cast<const float*>(qw), static_cast<const float*>(theta),
      static_cast<float*>(ub), static_cast<unsigned char*>(survive), n_bm, lq, n_blocks, tile,
      group);
  return static_cast<int>(cudaGetLastError());
}
