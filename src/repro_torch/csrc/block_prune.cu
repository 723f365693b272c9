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
// Here one CTA owns a (query, tile of TILE blocks), a thread a block. An
// earlier design gave a CTA 256 blocks and walked the slots with a load a
// slot, so a CTA was a chain of load latencies, and at B = 1 it left 9 CTAs
// for 132 SMs. Now:
//   - Each thread copies its block's maxima of a slab of slots, and the
//     slots' weights, into shared memory with asynchronous copies
//     (cp.async), every copy issued before the first add: one memory round
//     trip a slab of SLAB / TILE slots (all 35 of the main path's in one).
//     Neighbouring threads copy neighbouring blocks of one slot, so the
//     reads coalesce.
//   - Then each thread sums its block's column slot by slot from 0, the
//     product and the sum rounded separately (no FMA), so ub is equal bit
//     for bit to the CSR kernel's (block_prune_csr.cu) on the rows that
//     _dense_blockmax_rows densifies, to block_upper_bounds, and to a plain
//     version that adds one slot at a time: a slot that lists no entry for
//     the block holds 0 there and adds exactly 0. A query of more slots
//     than a slab is summed a slab at a time, still in slot order.
//   - A tile of 64 blocks gives a batch of one 34 CTAs on the main path;
//     the wrapper's tile is the fastest of a sweep at B = 1 and 64. The
//     ragged last tile is masked here, so the block axis needs no padding.
// Shared memory is dynamic and under 48 KB, so no attribute is set. At
// [64, 35, 2159] it takes 0.0093 ms with inputs the L2 cannot hold, against
// a 0.0060 ms bound (the earlier design: 0.0095), and 0.0055 replayed with
// the L2 holding its 19.9 MB (0.0048); at B = 1 0.0023 replayed (0.0029);
// scripts/ab_scatter_prune.py on an NVIDIA H100 80GB HBM3, 700.00 W.
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr int SLAB = 8192;  // block maxima a CTA holds at once (32 KB)

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int TILE>
__global__ void __launch_bounds__(TILE)
block_prune_kernel(const float* __restrict__ bm, const float* __restrict__ qw,
                   const float* __restrict__ theta, float* __restrict__ ub,
                   unsigned char* __restrict__ survive, int lq, int nb) {
  constexpr int SLOTS = SLAB / TILE;  // slots a slab
  extern __shared__ float s_bm[];     // [min(lq, SLOTS), TILE], then the slots' weights
  float* s_qw = s_bm + min(lq, SLOTS) * TILE;
  const size_t row = blockIdx.y;
  const int j0 = blockIdx.x * TILE;
  const int width = min(TILE, nb - j0);
  const float* slab = bm + row * lq * static_cast<size_t>(nb) + j0;
  const float* w = qw + row * lq;
  const int j = threadIdx.x;
  float acc = 0.0f;
  for (int l0 = 0; l0 < lq; l0 += SLOTS) {
    const int n = min(SLOTS, lq - l0);
    if (j < width) {
      for (int l = 0; l < n; ++l) {
        copy_async4(s_bm + l * TILE + j, slab + static_cast<size_t>(l0 + l) * nb + j);
      }
    }
    for (int l = j; l < n; l += TILE) copy_async4(s_qw + l, w + l0 + l);
    wait_copies();
    __syncthreads();
    if (j < width) {
      for (int l = 0; l < n; ++l) acc = __fadd_rn(acc, __fmul_rn(s_qw[l], s_bm[l * TILE + j]));
    }
    __syncthreads();  // the next slab overwrites this one
  }
  if (j < width) {
    const float th = __ldg(theta + row);
    ub[row * nb + j0 + j] = acc;
    survive[row * nb + j0 + j] = (acc > th) && (acc > 0.0f);
  }
}

repro_torch::LaunchPlan plan(int B, int lq, int nb, int tile) {
  const int slots = min(lq, SLAB / tile);
  return {dim3((nb + tile - 1) / tile, B), tile, 1,
          (static_cast<size_t>(slots) * tile + slots) * sizeof(float)};
}

template <int TILE>
int launch(const float* bm, const float* qw, const float* theta, float* ub,
           unsigned char* survive, int B, int lq, int nb, cudaStream_t stream) {
  const repro_torch::LaunchPlan p = plan(B, lq, nb, TILE);
  block_prune_kernel<TILE><<<p.grid, p.threads, p.smem, stream>>>(bm, qw, theta, ub, survive, lq,
                                                                   nb);
  return static_cast<int>(cudaGetLastError());
}

bool valid_tile(int tile) { return tile == 32 || tile == 64 || tile == 128 || tile == 256; }

}  // namespace

// The launch shape of block_prune_launch for the same ints.
extern "C" int block_prune_plan(int B, int lq, int nb, int tile, int* out) {
  if (!valid_tile(tile)) return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::write_plan(plan(B, lq, nb, tile), out);
}

// bm f32[B, lq, nb], qw f32[B, lq], theta f32[B] -> ub f32[B, nb],
// survive bool[B, nb]; tile (blocks a CTA) one of 32, 64, 128, 256;
// B <= 65535.
extern "C" int block_prune_launch(const void* bm, const void* qw, const void* theta, void* ub,
                                  void* survive, int B, int lq, int nb, int tile, void* stream) {
  const auto* b = static_cast<const float*>(bm);
  const auto* q = static_cast<const float*>(qw);
  const auto* th = static_cast<const float*>(theta);
  auto* u = static_cast<float*>(ub);
  auto* sv = static_cast<unsigned char*>(survive);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 32: return launch<32>(b, q, th, u, sv, B, lq, nb, s);
    case 64: return launch<64>(b, q, th, u, sv, B, lq, nb, s);
    case 128: return launch<128>(b, q, th, u, sv, B, lq, nb, s);
    case 256: return launch<256>(b, q, th, u, sv, B, lq, nb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
