// block_topk: stage 1 of the two-stage exact top-k. For each (query b,
// tile of `tile` scores) it emits the tile's k best (score, index) pairs,
// highest score first and the lowest index first among equal scores, -inf
// included; indices are global (offset by the tile start). A merge over the
// [B, n_tiles, k] finalists outside the kernel gives the exact top-k.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/block_topk/kernel.py:block_topk_batched_kernel
// (and its single-query block_topk_kernel, which the Python wrapper runs as
// a batch of one).
//
// Bound on the H100: memory. Each score is read once (4 B) and 8 B x k are
// written per tile: 0.00017 ms for the DAAT engine's [64, 2159] bounds. So
// small a kernel is bound in practice by its launch and its barriers.
//
// What held the earlier design back: one CTA per (query, tile) padded the
// tile to the next power of two of packed keys and sorted them all, 78
// barrier-separated stages for 2,159 bounds, to keep k = 8 or 16: 0.054 ms
// against torch.topk's 0.030 (chip_smoke.py on an NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// Design. The TPU kernel ran lax.top_k over a VMEM tile. Here one CTA owns
// a (query, tile): it reads the tile once, coalesced, into shared memory,
// and keeps the k best packed keys (select_common.cuh: the score's
// order-preserving bits above 0xFFFFFFFF - index, so ties go to the lowest
// index) with block_select_desc: each warp keeps the k best of its strided
// slice by k rounds of a warp-wide max, and one warp merges the warps'
// lists; two barriers in all. The DAAT engine's tile is its whole ub row,
// so the grid is one CTA per query; a row of 2,159 bounds is 2 or 3 keys
// per thread. At [64, 2159], k = 16: 0.014 ms a launch replayed from a CUDA
// graph, against 0.027 for torch.topk replayed the same way (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700.00 W).
#include "launch_plan.cuh"
#include "select_common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
block_topk_kernel(const float* __restrict__ scores, float* __restrict__ out_s,
                  int* __restrict__ out_i, int n, int tile, int k, int list_len) {
  extern __shared__ unsigned long long s_list[];  // (blockDim.x / 32) * list_len
  float* s_score = reinterpret_cast<float*>(s_list + (blockDim.x >> 5) * list_len);  // tile
  const size_t row = blockIdx.y;
  const int tile0 = blockIdx.x * tile;
  const float* src = scores + row * n + tile0;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) s_score[j] = __ldg(src + j);
  __syncthreads();
  const size_t o = (row * gridDim.x + blockIdx.x) * k;
  repro_torch::block_select_desc(
      [&](int j) { return repro_torch::select_key(s_score[j], j); }, tile, k, list_len, s_list,
      [&](int r, unsigned long long key) {
        out_s[o + r] = repro_torch::key_score(key);
        out_i[o + r] = tile0 + repro_torch::key_index(key);
      });
}

repro_torch::LaunchPlan plan(int B, int n, int tile, int threads, int smem) {
  return {dim3(n / tile, B), threads, 1, static_cast<size_t>(smem)};
}

}  // namespace

// scores f32[B, n] with n % tile == 0 -> out_s f32[B, n / tile, k],
// out_i i32[B, n / tile, k]. 0 < k <= tile; threads a multiple of 32 up to
// 1024; list_len = min(k, 32 * ceil(tile / threads)); smem =
// 8 * (threads / 32) * list_len + 4 * tile bytes within the block's shared
// memory.
extern "C" int block_topk_plan(int B, int n, int tile, int k, int threads, int list_len,
                               int smem, int* out) {
  return repro_torch::write_plan(plan(B, n, tile, threads, smem), out);
}

extern "C" int block_topk_launch(const void* scores, void* out_s, void* out_i, int B, int n,
                                 int tile, int k, int threads, int list_len, int smem,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const repro_torch::LaunchPlan p = plan(B, n, tile, threads, smem);
  block_topk_kernel<<<p.grid, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_s), static_cast<int*>(out_i),
      n, tile, k, list_len);
  return static_cast<int>(cudaGetLastError());
}
