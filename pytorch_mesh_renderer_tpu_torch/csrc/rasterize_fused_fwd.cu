// Fused forward hard rasterizer with attribute interpolation, for Hopper.
//
// Replaces the TPU kernel K1 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py `_kernel_fused` /
//   `_kernel_fused_body` (:1059-1196), launched by `_forward_fused` (:1258).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/rasterize_cuda.py
//   `rasterize_interpolate_torch`.
//
// What bounds it and the design are those of its body,
// rasterize_cluster_fwd.cuh (shared with K3, which takes no attributes):
// a thread-block cluster of kFusedSplit CTAs covers a group of 2x2 pixel
// blocks, each CTA culls and tests every kFusedSplit-th row, and the partial
// winners merge in any order through distributed shared memory. On the
// H100 (PERF.md) the group takes the sphere72 stress mesh from 0.82 to
// 0.50 ms; at the teapot the busiest group's chain of tests (four pixels a
// thread) costs what the smaller stream saves.

#include "rasterize_cluster_fwd.cuh"

namespace {

// Pixel blocks per side of the group that a cluster covers, and CTAs per
// cluster: chosen from the device times at groups of 1 and 2 and splits of
// 2, 4 and 8 on the H100 (PERF.md).
constexpr int kFusedGroup = 2;
constexpr int kFusedSplit = 4;

__global__ void __launch_bounds__(kThreads) rasterize_fused_fwd_kernel(
    const float4* __restrict__ tri_rows,      // [B, T, 16]
    const float* __restrict__ corner_attrs,   // [B, T, 3, A]
    int* __restrict__ ids,                    // [B, H, W]
    float* __restrict__ bc,                   // [B, H, W, 3]
    float* __restrict__ z_out,                // [B, H, W] or null
    float* __restrict__ attrs,                // [B, H, W, A]
    int num_tris, int num_attrs, int width, int height, int row_offset,
    float scale_x, float scale_y) {
  rasterize_cluster<kFusedGroup, true>(tri_rows, corner_attrs, ids, bc,
                                       z_out, attrs, num_tris, num_attrs,
                                       width, height, row_offset, scale_x,
                                       scale_y);
}

}  // namespace

// Launches the kernel in clusters of `split` CTAs per group of pixel
// blocks (0 for kFusedSplit, the kernel's own; 1, 2, 4 or 8; other values
// serve only to measure that choice) on `stream` and returns the launch's
// CUDA error (0 on success). Pointers are device pointers to
// contiguous tensors; `z` may be null. The caller checks shapes, types and
// alignment.
extern "C" int rasterize_fused_fwd(const void* tri_rows,
                                   const void* corner_attrs, void* ids,
                                   void* bc, void* z, void* attrs, int batch,
                                   int num_tris, int num_attrs, int width,
                                   int height, int row_offset, float scale_x,
                                   float scale_y, int split, void* stream) {
  return launch_group<kFusedGroup>(
      rasterize_fused_fwd_kernel, batch, width, height,
      split == 0 ? kFusedSplit : split, stream,
      static_cast<const float4*>(tri_rows),
      static_cast<const float*>(corner_attrs), static_cast<int*>(ids),
      static_cast<float*>(bc), static_cast<float*>(z),
      static_cast<float*>(attrs), num_tris, num_attrs, width, height,
      row_offset, scale_x, scale_y);
}

// Resident CTAs of rasterize_fused_fwd_kernel per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int rasterize_fused_fwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rasterize_fused_fwd_kernel, kThreads, 0);
  return error == cudaSuccess ? blocks : -static_cast<int>(error);
}

extern "C" const char* cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}
