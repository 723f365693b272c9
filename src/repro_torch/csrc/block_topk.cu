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
// written per tile.
//
// Design. The TPU kernel ran lax.top_k over a VMEM tile. Here one CTA owns a
// (query, tile), reads the tile once, coalesced, into packed 64-bit keys in
// shared memory (select_common.cuh: the score's order-preserving bits above
// 0xFFFFFFFF - index, so ties go to the lowest index), pads them with the
// zero key up to the next power of two, sorts them descending with one
// bitonic sort, and writes the first k. The tile of the DAAT engine's ub row
// is the whole row (2,159 blocks at a 276k-doc shard): 4,096 keys, 32 KB.
// The score is recovered from its key, so no second array is kept.
#include "select_common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
block_topk_kernel(const float* __restrict__ scores, float* __restrict__ out_s,
                  int* __restrict__ out_i, int n, int tile, int n_keys, int k) {
  extern __shared__ unsigned long long s_key[];  // n_keys
  const size_t row = blockIdx.y;
  const int tile0 = blockIdx.x * tile;
  const float* src = scores + row * n + tile0;
  for (int j = threadIdx.x; j < n_keys; j += blockDim.x) {
    s_key[j] = j < tile ? repro_torch::select_key(__ldg(src + j), j) : 0ull;
  }
  __syncthreads();
  repro_torch::bitonic_sort_desc(s_key, n_keys);
  const size_t o = (row * gridDim.x + blockIdx.x) * k;
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const unsigned long long key = s_key[r];
    out_s[o + r] = repro_torch::key_score(key);
    out_i[o + r] = tile0 + repro_torch::key_index(key);
  }
}

}  // namespace

// scores f32[B, n] with n % tile == 0 -> out_s f32[B, n / tile, k],
// out_i i32[B, n / tile, k]. 0 < k <= tile <= n_keys; n_keys a power of two
// with n_keys * 8 B within the block's shared memory.
extern "C" int block_topk_launch(const void* scores, void* out_s, void* out_i, int B, int n,
                                 int tile, int n_keys, int k, void* stream) {
  const size_t smem = static_cast<size_t>(n_keys) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      block_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / tile, B);
  const int threads = n_keys < 1024 ? n_keys : 1024;
  block_topk_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_s), static_cast<int*>(out_i),
      n, tile, n_keys, k);
  return static_cast<int>(cudaGetLastError());
}
