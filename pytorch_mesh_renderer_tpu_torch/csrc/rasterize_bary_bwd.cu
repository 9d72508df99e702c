// Barycentric-only analytic backward of the hard rasterizer, for Hopper.
//
// Replaces the TPU kernel K4 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py `_bwd_kernel`
//   (:676-752), launched by `_backward_pallas` (:814).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/rasterize_barycentric_cuda.py
//   `rasterize_barycentric_backward_torch`.
//
// Output: the per-triangle table [B, T, 9], zeroed by the caller; column
// c*3 + k is corner k's coordinate-c clip gradient (c in x, y, w), the
// JAX package's coordinate-major layout.
//
// The design: K2's body without attributes. The math, what bounds it and
// the warp body (`warp_gradients`: 8x4-pixel warps, two to a 64-thread CTA
// of 8x8 pixels, no block barrier; a warp with no active pixel leaves
// after one ballot, a busy one sorts its lanes by winner and adds one
// global atomic per (warp, winner, column)) are in rasterize_bwd_common.cuh;
// at A = 0 the attribute rounds and the fused part compile away. A one-
// thread-per-pixel row layout, where every warp of 32 pixels of a row ran
// its run reduction whether or not it held an active pixel and added one
// atomic per run of equal winner, was the first design; on the 256x256
// batch-4 teapot only 1,494 of its 8,192 row warps held an active pixel.
// The kernel keeps its own symbol, so that profiles and build reports
// tell it from K2. The atomic order makes the table's last bits vary from
// run to run.

#include "rasterize_bwd_common.cuh"

namespace {

__global__ void __launch_bounds__(kBwdCtaThreads) rasterize_bary_bwd_kernel(
    const int* __restrict__ ids, const float* __restrict__ bc,
    const float* __restrict__ g_bc, const float4* __restrict__ tri_rows,
    const float* __restrict__ inv_abs_det, float* __restrict__ dtab,
    int num_tris, int width, int height) {
  warp_gradients<false>(ids, bc, g_bc, nullptr, tri_rows, inv_abs_det,
                        nullptr, dtab, num_tris, 0, width, height);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors: ids
// [B, H, W], bc and g_bc [B, H, W, 3], `dtab` [B, T, 9] zeroed. H is the
// row strip's height where the caller renders strips. The caller checks
// shapes, types and alignment.
extern "C" int rasterize_bary_bwd(const void* ids, const void* bc,
                                  const void* g_bc, const void* tri_rows,
                                  const void* inv_abs_det, void* dtab,
                                  int batch, int num_tris, int width,
                                  int height, void* stream) {
  const dim3 grid((width + kBwdCtaW - 1) / kBwdCtaW,
                  (height + kBwdCtaH - 1) / kBwdCtaH, batch);
  rasterize_bary_bwd_kernel<<<grid, kBwdCtaThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(bc),
      static_cast<const float*>(g_bc), static_cast<const float4*>(tri_rows),
      static_cast<const float*>(inv_abs_det), static_cast<float*>(dtab),
      num_tris, width, height);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs of rasterize_bary_bwd_kernel per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int rasterize_bary_bwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rasterize_bary_bwd_kernel, kBwdCtaThreads, 0);
  return error == cudaSuccess ? blocks : -static_cast<int>(error);
}
