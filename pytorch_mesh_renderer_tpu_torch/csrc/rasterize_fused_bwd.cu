// Fused analytic backward of the hard rasterizer with attribute
// interpolation, for Hopper.
//
// Replaces the TPU kernel K2 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py `_bwd_kernel_fused`
//   (:1282-1402), launched by `_backward_fused` (:1474).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/rasterize_cuda.py
//   `triangle_gradients_torch` (inside
//   `rasterize_interpolate_backward_torch`).
//
// Output: the per-triangle table [B, T, 9 + 3A], zeroed by the caller.
// Columns c*3 + k hold corner k's coordinate-c clip gradient (c in x, y, w:
// the JAX package's coordinate-major layout), columns 9 + k*A + a corner
// k's attribute-a gradient. The math is rasterize_bwd_common.cuh's, shared
// with the barycentric-only backward K4.
//
// What bounds it and the design (warps of 8x4 pixels, two to a CTA, no
// block barrier; idle warps leave after one ballot, busy ones sort their
// lanes by winner and add one global atomic per (warp, winner, column))
// are in rasterize_bwd_common.cuh, whose body `warp_gradients` this
// kernel runs with attributes and K4 (rasterize_bary_bwd.cu) without.
//
// Rounding: per-pixel values in the plain version's operation order
// (--fmad=false); the atomic order makes the table's last bits vary from
// run to run.

#include "rasterize_bwd_common.cuh"

namespace {

__global__ void __launch_bounds__(kBwdCtaThreads) rasterize_fused_bwd_kernel(
    const int* __restrict__ ids, const float* __restrict__ bc,
    const float* __restrict__ g_bc, const float* __restrict__ g_attr,
    const float4* __restrict__ tri_rows,
    const float* __restrict__ inv_abs_det, const float* __restrict__ corner,
    float* __restrict__ dtab, int num_tris, int num_attrs, int width,
    int height) {
  warp_gradients<true>(ids, bc, g_bc, g_attr, tri_rows, inv_abs_det, corner,
                       dtab, num_tris, num_attrs, width, height);
}

}  // namespace

// Launches the kernel on `stream` and returns the launch's CUDA error (0 on
// success). Pointers are device pointers to contiguous tensors; `dtab` is
// zeroed. The caller checks shapes, types and alignment.
extern "C" int rasterize_fused_bwd(const void* ids, const void* bc,
                                   const void* g_bc, const void* g_attr,
                                   const void* tri_rows,
                                   const void* inv_abs_det,
                                   const void* corner, void* dtab, int batch,
                                   int num_tris, int num_attrs, int width,
                                   int height, void* stream) {
  const dim3 grid((width + kBwdCtaW - 1) / kBwdCtaW,
                  (height + kBwdCtaH - 1) / kBwdCtaH, batch);
  rasterize_fused_bwd_kernel<<<grid, kBwdCtaThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(bc),
      static_cast<const float*>(g_bc), static_cast<const float*>(g_attr),
      static_cast<const float4*>(tri_rows),
      static_cast<const float*>(inv_abs_det),
      static_cast<const float*>(corner), static_cast<float*>(dtab),
      num_tris, num_attrs, width, height);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs of rasterize_fused_bwd_kernel per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int rasterize_fused_bwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rasterize_fused_bwd_kernel, kBwdCtaThreads, 0);
  return error == cudaSuccess ? blocks : -static_cast<int>(error);
}
