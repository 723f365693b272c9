// Shared device code of the kernels that select inside themselves
// (impact_scatter_topk.cu, block_topk.cu, chunk_step.cu): packed 64-bit
// selection keys and a descending bitonic sort over them, so every kernel
// orders by score and breaks ties toward the lowest index, -inf included,
// as lax.top_k does in the reference.
//
// A key packs ordered_bits(score) above 0xFFFFFFFF - index. Keys of
// distinct indices are unique, so any correct sort gives one result. The
// key 0 lies below every real key (ordered_bits(-inf) is 0x007FFFFF), so it
// pads a sort up to a power of two without ever surfacing ahead of a real
// entry.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// An unsigned integer with the same order as the float (-inf lowest).
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ordered_float(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ unsigned long long select_key(float score, uint32_t index) {
  return (static_cast<unsigned long long>(ordered_bits(score)) << 32) | (0xFFFFFFFFu - index);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  return ordered_float(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

// Sorts keys[0, n) in shared memory, descending. n is a power of two and
// every thread of the block calls it after the keys are written and made
// visible (__syncthreads()); it returns after a final __syncthreads().
// With one key per thread (impact_scatter_topk) each stage is one
// compare-exchange per thread and no loop: the loop over keys cost that
// kernel 20% on the H100.
__device__ __forceinline__ void bitonic_sort_desc(unsigned long long* keys, int n) {
  if (static_cast<int>(blockDim.x) == n) {
    const int i = threadIdx.x;
    for (int size = 2; size <= n; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int partner = i ^ stride;
        if (partner > i) {
          const unsigned long long a = keys[i];
          const unsigned long long b = keys[partner];
          const bool descending = (i & size) == 0;
          if (descending ? a < b : a > b) {
            keys[i] = b;
            keys[partner] = a;
          }
        }
        __syncthreads();
      }
    }
    return;
  }
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int partner = i ^ stride;
        if (partner > i) {
          const unsigned long long a = keys[i];
          const unsigned long long b = keys[partner];
          const bool descending = (i & size) == 0;
          if (descending ? a < b : a > b) {
            keys[i] = b;
            keys[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace repro_torch
