// Barycentric-only forward hard rasterizer (the reference kernel's
// contract: ids, barycentrics, z), for Hopper.
//
// Replaces the TPU kernel K3 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py `_kernel` (:348-412),
//   launched by `_forward_from_packed` (:582).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/rasterize_barycentric_cuda.py
//   `rasterize_barycentric_torch`.
//
// It computes K1's z-buffer without the attribute columns: the loop, what
// bounds it and the per-block cull are rasterize_common.cuh's, shared with
// K1 as the TPU pair shares `_rasterize_chunk_core`. The epilogue writes
// ids, bc and z (background: id 0, bc 0, z 1; the carry starts at z = 1,
// so no clamp is needed).

#include "rasterize_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) rasterize_bary_fwd_kernel(
    const float4* __restrict__ tri_rows,  // [B, T, 16]
    int* __restrict__ ids,                // [B, H, W]
    float* __restrict__ bc,               // [B, H, W, 3]
    float* __restrict__ z_out,            // [B, H, W]
    int num_tris, int width, int height, int row_offset, float scale_x,
    float scale_y) {
  const Winner best = rasterize_pixel(tri_rows, num_tris, width, height,
                                      row_offset, scale_x, scale_y);
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;

  const size_t pixel = (static_cast<size_t>(blockIdx.z) * height + y) *
                           static_cast<size_t>(width) + x;
  const float sum_e = best.we0 + best.we1 + best.we2;
  const float inv_sum = 1.0f / (sum_e != 0.0f ? sum_e : 1.0f);
  ids[pixel] = best.id > 0 ? best.id : 0;
  bc[pixel * 3 + 0] = best.we0 * inv_sum;
  bc[pixel * 3 + 1] = best.we1 * inv_sum;
  bc[pixel * 3 + 2] = best.we2 * inv_sum;
  z_out[pixel] = best.z;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors. The caller
// checks shapes, types and alignment.
extern "C" int rasterize_bary_fwd(const void* tri_rows, void* ids, void* bc,
                                  void* z, int batch, int num_tris,
                                  int width, int height, int row_offset,
                                  float scale_x, float scale_y,
                                  void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY, batch);
  rasterize_bary_fwd_kernel<<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tri_rows), static_cast<int*>(ids),
      static_cast<float*>(bc), static_cast<float*>(z), num_tris, width,
      height, row_offset, scale_x, scale_y);
  return static_cast<int>(cudaGetLastError());
}
