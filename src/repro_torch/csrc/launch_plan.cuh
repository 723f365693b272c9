// The launch shape of a kernel: grid, threads, cluster and dynamic shared
// memory. Each launcher computes it with one helper, and each source
// exports that helper as <launcher stem>_plan(the launcher's ints..., out),
// so the Python plan a launch is made from can be held against it.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace repro_torch {

struct LaunchPlan {
  dim3 grid;
  int threads;
  int cluster;  // CTAs a cluster, along x
  size_t smem;  // dynamic shared memory, bytes
};

// out[0..5]: grid x, y, z, threads, cluster, dynamic shared memory.
inline int write_plan(const LaunchPlan& p, int* out) {
  out[0] = static_cast<int>(p.grid.x);
  out[1] = static_cast<int>(p.grid.y);
  out[2] = static_cast<int>(p.grid.z);
  out[3] = p.threads;
  out[4] = p.cluster;
  out[5] = static_cast<int>(p.smem);
  return 0;
}

}  // namespace repro_torch
