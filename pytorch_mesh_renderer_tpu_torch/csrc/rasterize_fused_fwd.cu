// Fused forward hard rasterizer with attribute interpolation, for Hopper.
//
// Replaces the TPU kernel K1 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py `_kernel_fused` /
//   `_kernel_fused_body` (:1059-1196), launched by `_forward_fused` (:1258).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/rasterize_cuda.py
//   `rasterize_interpolate_torch`.
//
// The z-buffer loop, what bounds it and the design of its per-block cull
// are in rasterize_common.cuh, shared with the barycentric-only forward K3.
// After the loop each thread normalises its winner's barycentrics once and
// reads the winner's three corner-attribute rows from device memory once.
//
// Outputs (rasterize_pallas.py:1190-1196):
//   Uncovered pixels: id 0, bc 0, z 1, attributes 0.
//   bc_k = we_k * (1 / sum(we)); attr = a_0*bc_0 + a_1*bc_1 + a_2*bc_2.

#include "rasterize_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) rasterize_fused_fwd_kernel(
    const float4* __restrict__ tri_rows,      // [B, T, 16]
    const float* __restrict__ corner_attrs,   // [B, T, 3, A]
    int* __restrict__ ids,                    // [B, H, W]
    float* __restrict__ bc,                   // [B, H, W, 3]
    float* __restrict__ z_out,                // [B, H, W] or null
    float* __restrict__ attrs,                // [B, H, W, A]
    int num_tris, int num_attrs, int width, int height, int row_offset,
    float scale_x, float scale_y) {
  const Winner best = rasterize_pixel(tri_rows, num_tris, width, height,
                                      row_offset, scale_x, scale_y);
  const int b = blockIdx.z;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;

  const size_t pixel =
      (static_cast<size_t>(b) * height + y) * static_cast<size_t>(width) + x;
  const float sum_e = best.we0 + best.we1 + best.we2;
  const float inv_sum = 1.0f / (sum_e != 0.0f ? sum_e : 1.0f);
  const float b0 = best.we0 * inv_sum;
  const float b1 = best.we1 * inv_sum;
  const float b2 = best.we2 * inv_sum;
  ids[pixel] = best.id > 0 ? best.id : 0;
  bc[pixel * 3 + 0] = b0;
  bc[pixel * 3 + 1] = b1;
  bc[pixel * 3 + 2] = b2;
  if (z_out != nullptr) z_out[pixel] = best.z;

  float* out = attrs + pixel * num_attrs;
  if (best.id < 0) {
    for (int a = 0; a < num_attrs; ++a) out[a] = 0.0f;
    return;
  }
  const float* corner = corner_attrs +
      (static_cast<size_t>(b) * num_tris + best.id) * 3 * num_attrs;
  for (int a = 0; a < num_attrs; ++a) {
    out[a] = corner[a] * b0 + corner[num_attrs + a] * b1 +
             corner[2 * num_attrs + a] * b2;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors; `z` may be
// null. The caller checks shapes, types and alignment.
extern "C" int rasterize_fused_fwd(const void* tri_rows,
                                   const void* corner_attrs, void* ids,
                                   void* bc, void* z, void* attrs, int batch,
                                   int num_tris, int num_attrs, int width,
                                   int height, int row_offset, float scale_x,
                                   float scale_y, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY, batch);
  rasterize_fused_fwd_kernel<<<grid, block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tri_rows),
      static_cast<const float*>(corner_attrs), static_cast<int*>(ids),
      static_cast<float*>(bc), static_cast<float*>(z),
      static_cast<float*>(attrs), num_tris, num_attrs, width, height,
      row_offset, scale_x, scale_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}
