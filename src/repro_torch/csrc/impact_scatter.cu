// impact_scatter: the SAAT accumulator, acc[b, d] = sum of contribs[b, p]
// over the postings p of row b with docs[b, p] == d.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/impact_scatter/kernel.py:impact_scatter_batched_kernel
// (and its single-query impact_scatter_kernel, which the Python wrapper
// runs as a batch of one).
//
// Bound on the H100: memory. Each real posting slot is read once (8 B: a
// doc id and a contribution) and each accumulator entry written once (4 B);
// the arithmetic is one add per posting.
//
// Input layout (repro_torch.kernels.common.sorted_posting_tiles): row b of
// docs i32[B, P] is sorted ascending by doc id and contribs f32[B, P] rides
// with it. The doc id n_docs is a sentinel: such slots carry nothing and
// form the row's tail.
//
// Design. The TPU kernel built each doc block's sum as a one-hot matmul on
// the MXU over a (block x posting tile) grid. An earlier design here gave a
// CTA a block of docs, found the block's postings with two searches of the
// row and summed them in stages; each CTA was a chain of dependent loads,
// and at B = 1 its 540 CTAs were one thin wave. This kernel partitions the
// row by posting slots instead:
//   - A CTA owns `stages` consecutive ranges of R = THREADS * SPT slots of
//     one row and takes them in order. Each range is staged in shared
//     memory by asynchronous copies (cp.async, 16 B each where the row
//     allows), with the slots just before it and EXTRA slots after it; the
//     next range's copies are in flight while the current one is summed
//     (two buffers). A CTA of several ranges first reads its first slot,
//     and stops there if it lies in the row's sentinel tail, so the tail is
//     not read in bulk; a CTA stops after the range where the row's real
//     postings end.
//   - Each warp of the CTA owns a unit of U = 32 * SPT slots of the range,
//     and works on it alone: no barrier of the CTA falls inside a range. A
//     lane takes SPT consecutive slots in order, from registers. A doc's
//     run belongs to the lane that holds its first posting, which adds the
//     run one by one in row order from 0, reading on past its slots (the
//     next lanes', the range's later units, its EXTRA slots, then device
//     memory) until the run ends. So each sum has the bits of a plain
//     sequential sum, as every scatter of the port adds them, with no
//     atomics; and a warp's lanes walk about SPT slots each, however long
//     the runs, where a lane a run would wait on the longest run in its
//     warp.
//   - A unit's doc span runs from after the previous slot's doc up to its
//     own last slot's doc (up to n_docs - 1 where the row's real postings
//     end in it); every doc of a row lies in the span of exactly one unit.
//     The warp writes its span's zeros with coalesced 16 B stores, then,
//     after __syncwarp, each run's sum over its zero (a sum lands on a line
//     its zeros have just written, in the L2).
// There is no search. A batch of one gets one range a CTA, enough CTAs to
// fill the card; a large batch gets several ranges a CTA, so that the
// copies stay in flight. Shared memory is static and under 48 KB, so no
// attribute is set at launch. At rho = 1M and B = 64 (39.06M postings over
// 276,480 docs) it takes 0.160 ms replayed from a CUDA graph, 1.4x its
// 0.114 ms bound (the doc-block design: 0.239), and 0.0066 ms at B = 1
// (0.0127); scripts/ab_scatter_prune.py on an NVIDIA H100 80GB HBM3,
// 700.00 W.
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HEAD = 4;    // slots staged before a range (the previous slot's doc)
constexpr int EXTRA = 64;  // slots staged after a range, for a run that goes on past it

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Slots [r0 - HEAD, r0 + W - HEAD) of a row into s_doc/s_val: copies for
// the slots in [0, P), the sentinel (and 0) past P. 16 B copies where P is a
// multiple of 4 (r0 always is), 4 B copies otherwise.
template <int W>
__device__ __forceinline__ void stage_range(const int* d_row, const float* c_row, int P,
                                            int n_docs, int r0, int* s_doc, float* s_val) {
  const int g0 = r0 - HEAD;
  if ((P & 3) == 0) {
    for (int q = threadIdx.x; q < W / 4; q += THREADS) {
      const int g = g0 + 4 * q;
      if (g < 0) continue;  // before the row: the range at slot 0 has no previous slot
      if (g < P) {
        copy16(s_doc + 4 * q, d_row + g);
        copy16(s_val + 4 * q, c_row + g);
      } else {
        reinterpret_cast<int4*>(s_doc)[q] = make_int4(n_docs, n_docs, n_docs, n_docs);
        reinterpret_cast<float4*>(s_val)[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < W; i += THREADS) {
      const int g = g0 + i;
      if (g < 0) continue;
      if (g < P) {
        copy4(s_doc + i, d_row + g);
        copy4(s_val + i, c_row + g);
      } else {
        s_doc[i] = n_docs;
        s_val[i] = 0.0f;
      }
    }
  }
  commit_copies();
}

// Zeros for docs [lo, hi] of a row by one warp, four a store where aligned.
__device__ __forceinline__ void zero_span(float* o_row, int lo, int hi, int lane) {
  if (lo > hi) return;
  const int a0 = min(hi + 1, (lo + 3) & ~3);
  const int a1 = max(a0, (hi + 1) & ~3);
  for (int d = lo + lane; d < a0; d += 32) o_row[d] = 0.0f;
  float4* o4 = reinterpret_cast<float4*>(o_row);
  for (int q = a0 / 4 + lane; q < a1 / 4; q += 32) o4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int d = a1 + lane; d <= hi; d += 32) o_row[d] = 0.0f;
}

// The calling warp's unit of U = 32 * SPT slots of the range at r0, staged
// at s (slot r0 + i at s[i], s[-1] the previous slot, s[R .. R + EXTRA) the
// slots after): zeros over its doc span, then each run's sum. A lane takes
// SPT consecutive slots in order from registers: a slot whose doc differs
// from the slot before starts a run, which the lane adds up slot by slot
// and writes when the next run starts; slots at the head of the lane that
// go on with a run begun before them are an earlier lane's. The lane's last
// run may go on past its slots: it reads on from shared memory.
template <int SPT>
__device__ __forceinline__ void sum_unit(const int* d_row, const float* c_row, float* o_row,
                                         int P, int n_docs, int r0, const int* s,
                                         const float* v) {
  constexpr int R = THREADS * SPT;
  constexpr int U = 32 * SPT;
  const int lane = threadIdx.x & 31;
  const int u0 = (threadIdx.x >> 5) * U;  // the unit's first slot in the range
  const int end = min(U, P - r0 - u0);    // slots of the unit in the row
  if (end <= 0) return;
  const int first = s[u0];
  if (first >= n_docs && r0 + u0 > 0) return;  // the unit lies in the sentinel tail
  const int prev = r0 + u0 == 0 ? -1 : s[u0 - 1];
  const int next = r0 + u0 + end < P ? s[u0 + end] : n_docs;
  zero_span(o_row, prev + 1, next >= n_docs ? n_docs - 1 : s[u0 + end - 1], lane);
  __syncwarp();  // each sum lands on its zero
  const int a = u0 + lane * SPT;  // the lane's slots: a .. a + SPT (past P: the sentinel)
  int d[SPT];
  float x[SPT];
  if constexpr (SPT % 4 == 0) {
#pragma unroll
    for (int k = 0; k < SPT; k += 4) {
      const int4 dq = *reinterpret_cast<const int4*>(s + a + k);
      const float4 xq = *reinterpret_cast<const float4*>(v + a + k);
      d[k] = dq.x, d[k + 1] = dq.y, d[k + 2] = dq.z, d[k + 3] = dq.w;
      x[k] = xq.x, x[k + 1] = xq.y, x[k + 2] = xq.z, x[k + 3] = xq.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < SPT; ++k) d[k] = s[a + k], x[k] = v[a + k];
  }
  int cur = -1;  // the doc of the lane's open run
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int before = k > 0 ? d[k - 1] : (r0 + a == 0 ? -1 : s[a - 1]);
    if (d[k] >= n_docs) break;  // the sentinel: no posting from here on
    if (d[k] != before) {
      if (cur >= 0) o_row[cur] = acc;
      cur = d[k];
      acc = 0.0f;
    }
    if (cur >= 0) acc += x[k];
  }
  if (cur < 0) return;
  if (d[SPT - 1] == cur) {  // the open run may go on past the lane's slots
    int p = a + SPT;
    while (p < R + EXTRA && s[p] == cur) acc += v[p++];
    if (p == R + EXTRA) {  // a run longer than the slots staged past the range
      for (int q = r0 + R + EXTRA; q < P && __ldg(d_row + q) == cur; ++q) acc += __ldg(c_row + q);
    }
  }
  o_row[cur] = acc;
}

template <int SPT>
__global__ void __launch_bounds__(THREADS)
impact_scatter_kernel(const int* __restrict__ docs, const float* __restrict__ contribs,
                      float* __restrict__ out, int P, int n_docs, int stages) {
  constexpr int R = THREADS * SPT;
  constexpr int W = HEAD + R + EXTRA;
  __shared__ __align__(16) int s_doc[2][W];
  __shared__ __align__(16) float s_val[2][W];
  const size_t row = blockIdx.y;
  const int* d_row = docs + row * P;
  const float* c_row = contribs + row * P;
  float* o_row = out + row * static_cast<size_t>(n_docs);
  if (P == 0) {  // a row of no slots: all zeros
    if (blockIdx.x == 0 && threadIdx.x < 32) zero_span(o_row, 0, n_docs - 1, threadIdx.x);
    return;
  }
  const int j0 = blockIdx.x * stages;
  const int j1 = min(j0 + stages, (P + R - 1) / R);
  if (stages > 1 && j0 > 0 && __ldg(d_row + j0 * R) >= n_docs) return;  // wholly in the tail
  stage_range<W>(d_row, c_row, P, n_docs, j0 * R, s_doc[0], s_val[0]);
  for (int j = j0; j < j1; ++j) {
    const int b = (j - j0) & 1;
    if (j + 1 < j1) {
      stage_range<W>(d_row, c_row, P, n_docs, (j + 1) * R, s_doc[b ^ 1], s_val[b ^ 1]);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const int r0 = j * R;
    sum_unit<SPT>(d_row, c_row, o_row, P, n_docs, r0, s_doc[b] + HEAD, s_val[b] + HEAD);
    // The row's real postings end in this range (or it is all tail): the
    // CTA's later ranges are tail.
    const int end = min(R, P - r0);
    const bool stop = r0 + end >= P || s_doc[b][HEAD + end] >= n_docs;
    __syncthreads();  // the next range's copies go to this buffer
    if (stop) break;
  }
  wait_copies<0>();  // no copy in flight at exit
}

repro_torch::LaunchPlan plan(int B, int P, int spt, int stages) {
  const int R = THREADS * spt;
  const int n_ranges = (P + R - 1) / R;
  return {dim3(max(1, (n_ranges + stages - 1) / stages), B), THREADS, 1, 0};
}

template <int SPT>
int launch(const int* docs, const float* contribs, float* out, int B, int P, int n_docs,
           int stages, cudaStream_t stream) {
  const repro_torch::LaunchPlan p = plan(B, P, SPT, stages);
  impact_scatter_kernel<SPT><<<p.grid, p.threads, p.smem, stream>>>(docs, contribs, out, P, n_docs,
                                                                     stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch shape of impact_scatter_launch for the same ints.
extern "C" int impact_scatter_plan(int B, int P, int n_docs, int spt, int stages, int* out) {
  if (stages < 1 || (spt != 2 && spt != 4 && spt != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return repro_torch::write_plan(plan(B, P, spt, stages), out);
}

// docs i32[B, P] (rows sorted, the sentinel n_docs on empty slots),
// contribs f32[B, P] -> out f32[B, n_docs]. n_docs % 4 == 0, B <= 65535;
// slots a range = 256 * spt, spt one of 2, 4, 8; stages >= 1 ranges a CTA.
extern "C" int impact_scatter_launch(const void* docs, const void* contribs, void* out, int B,
                                     int P, int n_docs, int spt, int stages, void* stream) {
  const auto* d = static_cast<const int*>(docs);
  const auto* c = static_cast<const float*>(contribs);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (spt) {
    case 2: return launch<2>(d, c, o, B, P, n_docs, stages, s);
    case 4: return launch<4>(d, c, o, B, P, n_docs, stages, s);
    case 8: return launch<8>(d, c, o, B, P, n_docs, stages, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
