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
// JAX package's coordinate-major layout. The math, what bounds it and
// its warp run reduction are in rasterize_bwd_common.cuh (the closed form
// is K2's). The atomic order makes the table's last bits
// vary from run to run.

#include "rasterize_bwd_common.cuh"

namespace {

__global__ void __launch_bounds__(kBwdThreads) rasterize_bary_bwd_kernel(
    const int* __restrict__ ids, const float* __restrict__ bc,
    const float* __restrict__ g_bc, const float4* __restrict__ tri_rows,
    const float* __restrict__ inv_abs_det, float* __restrict__ dtab,
    int num_tris, int pixels) {
  accumulate_triangle_gradients(ids, bc, g_bc, tri_rows, inv_abs_det, dtab,
                                num_tris, pixels);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors; `dtab` is
// zeroed. The caller checks shapes, types and alignment.
extern "C" int rasterize_bary_bwd(const void* ids, const void* bc,
                                  const void* g_bc, const void* tri_rows,
                                  const void* inv_abs_det, void* dtab,
                                  int batch, int num_tris, int pixels,
                                  void* stream) {
  const dim3 grid((pixels + kBwdThreads - 1) / kBwdThreads, batch);
  rasterize_bary_bwd_kernel<<<grid, kBwdThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(bc),
      static_cast<const float*>(g_bc), static_cast<const float4*>(tri_rows),
      static_cast<const float*>(inv_abs_det), static_cast<float*>(dtab),
      num_tris, pixels);
  return static_cast<int>(cudaGetLastError());
}
