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
// arithmetic is one multiply and one add per entry.
//
// Design. The TPU kernel densified every slot's window into an [Lq, NB]
// VMEM tile and contracted it with the query weights on the MXU. Here one
// CTA owns a (query, tile of TILE blocks) and keeps that tile's bounds in
// shared memory (16 KB; one tile covers a 276k-doc shard's 2,159 blocks).
// It walks the slots in order; within a slot the threads stride over the
// window, which is coalesced, and each adds its entry into its block's
// bound. A block id appears at most once in a term's list, so no two
// threads of one slot touch one bound, and a __syncthreads() between slots
// fixes the order: every bound is summed slot by slot, as the reference's
// scatter-add and the plain version sum it, and the product and sum are
// rounded separately (no FMA), so ub is equal bit for bit. A window is cut
// at the end of the lists, so no pad is needed behind them.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
block_prune_csr_kernel(const int* __restrict__ bm_block, const float* __restrict__ bm_weight,
                       const int* __restrict__ base, const int* __restrict__ cnt,
                       const float* __restrict__ qw, const float* __restrict__ theta,
                       float* __restrict__ ub, unsigned char* __restrict__ survive, int n_bm,
                       int lq, int n_blocks) {
  __shared__ float s_ub[TILE];
  const size_t row = blockIdx.y;
  const int tile0 = blockIdx.x * TILE;
  const int width = min(TILE, n_blocks - tile0);
  for (int j = threadIdx.x; j < width; j += blockDim.x) s_ub[j] = 0.0f;
  __syncthreads();
  for (int l = 0; l < lq; ++l) {
    const int start = __ldg(base + row * lq + l);
    const int end = min(start + __ldg(cnt + row * lq + l), n_bm);
    const float w = __ldg(qw + row * lq + l);
    for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
      const int blk = __ldg(bm_block + i) - tile0;
      if (blk >= 0 && blk < width) {
        s_ub[blk] = __fadd_rn(s_ub[blk], __fmul_rn(__ldg(bm_weight + i), w));
      }
    }
    __syncthreads();
  }
  const float th = __ldg(theta + row);
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    const float v = s_ub[j];
    ub[row * n_blocks + tile0 + j] = v;
    survive[row * n_blocks + tile0 + j] = (v > th) && (v > 0.0f);
  }
}

}  // namespace

// bm_block i32[n_bm], bm_weight f32[n_bm], base/cnt i32[B, lq] (windows
// [base, base + cnt), cnt already clamped to the per-term bound), qw f32[B, lq],
// theta f32[B] -> ub f32[B, n_blocks], survive bool[B, n_blocks].
extern "C" int block_prune_csr_launch(const void* bm_block, const void* bm_weight,
                                      const void* base, const void* cnt, const void* qw,
                                      const void* theta, void* ub, void* survive, int B,
                                      int n_bm, int lq, int n_blocks, void* stream) {
  const dim3 grid((n_blocks + TILE - 1) / TILE, B);
  block_prune_csr_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bm_block), static_cast<const float*>(bm_weight),
      static_cast<const int*>(base), static_cast<const int*>(cnt),
      static_cast<const float*>(qw), static_cast<const float*>(theta),
      static_cast<float*>(ub), static_cast<unsigned char*>(survive), n_bm, lq, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
