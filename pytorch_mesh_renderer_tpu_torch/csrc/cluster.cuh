// Thread-block cluster helpers shared by the cluster kernels: K1 and K3
// (rasterize_cluster_fwd.cuh) and K7/K5 (soft_cluster_fwd.cuh).

#pragma once

#include <cuda_runtime.h>

namespace {

// The two halves of a cluster barrier (cluster.sync() is both).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// Launches `kernel` on a `grid` of `block`s with `smem` bytes of dynamic
// shared memory in clusters of (1, 1, split) CTAs on `stream`, and returns
// the launch's CUDA error (0 on success). A launch the card refuses
// returns its error; nothing retries another shape.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 block,
                   int smem, int split, void* stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = static_cast<unsigned>(split);
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t error = cudaLaunchKernelEx(&config, kernel, args...);
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
