// Shared device code of the kernels that select inside themselves
// (impact_scatter_topk.cu, block_topk.cu, chunk_step.cu): packed 64-bit
// selection keys, a descending bitonic sort over them, and a top-n select,
// so every kernel orders by score and breaks ties toward the lowest index,
// -inf included, as lax.top_k does in the reference.
//
// A key packs ordered_bits(score) above 0xFFFFFFFF - index. Keys of
// distinct indices are unique, so any correct sort or select gives one
// result. The key 0 lies below every real key (ordered_bits(-inf) is
// 0x007FFFFF), so it pads a sort up to a power of two, or a select's list
// past its last real key, without ever surfacing ahead of a real entry.
//
// Bound and design of the select. Keeping the n best of m keys is bound by
// reading the m keys once; what held the earlier kernels back was not the
// bytes but a full bitonic sort of next_pow2(m) keys to keep n of them: 78
// stages, each ending in __syncthreads(), at m = 2,159 (4,096 keys) for
// n = 8 or 16 (block_topk at 0.054 ms; chip_smoke.py on an NVIDIA H100
// 80GB HBM3, 700.00 W). block_select_desc needs two barriers: each warp
// keeps the n best keys of its strided slice by n rounds of a warp-wide
// 64-bit max (two warp reductions; only the lane that gave up its key
// rescans its few keys, for the best one below the key just taken, so
// nothing is marked or written back), then one warp merges the warps'
// sorted lists by n more rounds of the same max over the lists' heads.
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

// The largest key of the warp, given to every lane: the largest high word
// (the score's bits), then the largest low word among the lanes that hold
// it (the lowest index). Two warp-wide reductions (sm_80 and later), in
// place of five dependent rounds of 64-bit shuffles.
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const unsigned top = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lo = __reduce_max_sync(0xffffffffu, hi == top ? static_cast<unsigned>(key) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | lo;
}

// The best key below `below` among this thread's keys key_at(i), i = tid,
// tid + blockDim.x, ... < m; 0 if there is none.
template <typename KeyAt>
__device__ __forceinline__ unsigned long long lane_best_below(const KeyAt& key_at, int m,
                                                              unsigned long long below) {
  unsigned long long best = 0ull;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const unsigned long long key = key_at(i);
    if (key < below && key > best) best = key;
  }
  return best;
}

// The n best of the keys key_at(0), ..., key_at(m - 1), highest first:
// emit(r, key) is called for r = 0, ..., n - 1 by one thread (lane 0 of
// warp 0), with the zero key past the m-th. key_at must give unique nonzero
// keys and be readable by every thread. lists holds (blockDim.x / 32) *
// list_len keys of shared scratch, list_len = min(n, the most keys one warp
// owns: 32 * ceil(m / blockDim.x)). Every thread of the block calls it; it
// returns after a __syncthreads(), so emitted shared entries are visible.
template <typename KeyAt, typename Emit>
__device__ __forceinline__ void block_select_desc(const KeyAt& key_at, int m, int n,
                                                  int list_len, unsigned long long* lists,
                                                  const Emit& emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned long long* list = lists + static_cast<size_t>(warp) * list_len;
  unsigned long long mine = lane_best_below(key_at, m, ~0ull);
  for (int r = 0; r < list_len; ++r) {
    const unsigned long long best = warp_max_key(mine);
    if (lane == 0) list[r] = best;
    if (best == 0ull) {  // the warp's keys are spent: the rest of its list is padding
      for (int q = r + 1 + lane; q < list_len; q += 32) list[q] = 0ull;
      break;
    }
    if (mine == best) mine = lane_best_below(key_at, m, best);
  }
  __syncthreads();
  if (warp == 0) {
    int pos = 0;
    unsigned long long head = lane < n_warps ? lists[static_cast<size_t>(lane) * list_len] : 0ull;
    for (int r = 0; r < n; ++r) {
      const unsigned long long best = warp_max_key(head);
      if (lane == 0) emit(r, best);
      if (best != 0ull && head == best) {
        ++pos;
        head = pos < list_len ? lists[static_cast<size_t>(lane) * list_len + pos] : 0ull;
      }
    }
  }
  __syncthreads();
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
