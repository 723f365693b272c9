// block_prune: the dense block-max upper bound and threshold prune,
//   ub[b, j] = sum over slots l of qw[b, l] * bm[b, l, j],
//   survive[b, j] = (ub > theta[b]) && (ub > 0),
// for bm f32[B, Lq, NB] (each slot's raw block maxima, dense), qw f32[B, Lq]
// and theta f32[B].
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/block_prune/kernel.py:block_prune_batched_kernel
// (and, through a B=1 wrapper, block_prune_kernel).
//
// Bound on the H100: memory. Every entry of bm is read once (4 B) and each
// (ub, survive) pair written once (5 B); the arithmetic is one multiply and
// one add per entry, far below the card's rate.
//
// Design. The TPU kernel contracted a [1, Lq] x [Lq, NBt] tile on the MXU.
// Here one CTA owns a (query, tile of TILE blocks) and one thread one block:
// the query's weights sit in shared memory, and the thread walks the slots
// in order, reading bm[b, l, j] for its j; neighbouring threads read
// neighbouring blocks of one slot, so every load is coalesced. The sum
// starts at 0 and adds slot by slot, the product and the sum rounded
// separately (no FMA), so ub is equal bit for bit to the CSR kernel's
// (block_prune_csr.cu) on the rows that _dense_blockmax_rows densifies, and
// to a plain version that adds one slot at a time: a slot that lists no
// entry for the block holds 0 there and adds exactly 0. The ragged last
// tile is masked here, so the block axis needs no padding.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;

__global__ void __launch_bounds__(TILE)
block_prune_kernel(const float* __restrict__ bm, const float* __restrict__ qw,
                   const float* __restrict__ theta, float* __restrict__ ub,
                   unsigned char* __restrict__ survive, int lq, int nb) {
  extern __shared__ float s_qw[];
  const size_t row = blockIdx.y;
  for (int l = threadIdx.x; l < lq; l += blockDim.x) s_qw[l] = __ldg(qw + row * lq + l);
  __syncthreads();
  const int j = blockIdx.x * TILE + threadIdx.x;
  if (j >= nb) return;
  const float* col = bm + row * lq * static_cast<size_t>(nb) + j;
  float acc = 0.0f;
  for (int l = 0; l < lq; ++l) {
    acc = __fadd_rn(acc, __fmul_rn(s_qw[l], __ldg(col + static_cast<size_t>(l) * nb)));
  }
  const float th = __ldg(theta + row);
  ub[row * nb + j] = acc;
  survive[row * nb + j] = (acc > th) && (acc > 0.0f);
}

}  // namespace

// bm f32[B, lq, nb], qw f32[B, lq], theta f32[B] -> ub f32[B, nb],
// survive bool[B, nb]. Shared memory: lq floats.
extern "C" int block_prune_launch(const void* bm, const void* qw, const void* theta, void* ub,
                                  void* survive, int B, int lq, int nb, void* stream) {
  const dim3 grid((nb + TILE - 1) / TILE, B);
  block_prune_kernel<<<grid, TILE, lq * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bm), static_cast<const float*>(qw),
      static_cast<const float*>(theta), static_cast<float*>(ub),
      static_cast<unsigned char*>(survive), lq, nb);
  return static_cast<int>(cudaGetLastError());
}
