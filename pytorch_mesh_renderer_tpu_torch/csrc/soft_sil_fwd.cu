// Silhouette-only SoftRas forward, for Hopper: alpha = 1 - prod(1 - cov).
//
// Replaces the TPU kernel K5 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/soft_rasterize_pallas.py
//   `_fwd_kernel_sil` (:835-878), launched by `_run_forward_sil` (:989).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/soft_rasterize_cuda.py
//   `soft_forward_torch_packed(..., silhouette_only=True)`.
//
// Only the geometry phase runs per (pixel, triangle): no shading, no
// softmax. It is the full forward K7 (soft_fwd.cu) without those, over the
// same staged triangles in the same order with the same geometry code, so
// its alpha equals K7's bit for bit. What bounds it and the block cull are
// in soft_common.cuh.

#include "soft_common.cuh"

namespace {

__global__ void __launch_bounds__(kSoftThreads) soft_sil_fwd_kernel(
    const float* __restrict__ table,   // [B, T, 59]
    const float* __restrict__ params,  // sigma, gamma, blur^2, row offset
    float* __restrict__ alpha,         // [B, H, W]
    int num_tris, int width, int height, int full_height) {
  __shared__ float slab[kSlabRows * kCols];
  __shared__ int kept_ids[kSlabRows];
  __shared__ int warp_kept[kSlabWarps];

  const int b = blockIdx.z;
  const int x = blockIdx.x * kSoftBlockX + threadIdx.x;
  const int y = blockIdx.y * kSoftBlockY + threadIdx.y;
  const bool in_image = x < width && y < height;
  const SoftParams p = load_params(params);
  const float px = pixel_x(x, width);
  const float py = pixel_y(y, p.row_off, full_height);
  const BlockExtent extent = block_extent(width, height, p.row_off,
                                          full_height);
  const float* rows_b = table + static_cast<size_t>(b) * num_tris * kCols;

  float sil = 1.0f;
  for (int t0 = 0; t0 < num_tris; t0 += kSlabRows) {
    const int n_kept = stage_rows(rows_b, t0, min(kSlabRows, num_tris - t0),
                                  1, extent, slab, kept_ids, warp_kept);
    if (!in_image) continue;
    for (int k = 0; k < n_kept; ++k) {
      const SoftGeometry g =
          soft_geometry(slab + k * kCols, px, py, p.sigma, p.sq_blur);
      if (!g.valid) continue;
      sil = sil * (1.0f - g.coverage);
    }
  }
  if (!in_image) return;
  alpha[(static_cast<size_t>(b) * height + y) * static_cast<size_t>(width) +
        x] = 1.0f - sil;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors. The caller
// checks shapes and types.
extern "C" int soft_sil_fwd(const void* table, const void* params,
                            void* alpha, int batch, int num_tris, int width,
                            int height, int full_height, void* stream) {
  const dim3 block(kSoftBlockX, kSoftBlockY);
  const dim3 grid((width + kSoftBlockX - 1) / kSoftBlockX,
                  (height + kSoftBlockY - 1) / kSoftBlockY, batch);
  soft_sil_fwd_kernel<<<grid, block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(params),
      static_cast<float*>(alpha), num_tris, width, height, full_height);
  return static_cast<int>(cudaGetLastError());
}
