// Full SoftRas forward (shaded RGB + silhouette alpha), for Hopper.
//
// Replaces the TPU kernel K7 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/soft_rasterize_pallas.py `_fwd_kernel`
//   (:422-493), launched by `_run_forward` (:1185).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/soft_rasterize_cuda.py
//   `soft_forward_torch_packed`.
//
// Per pixel, over every triangle in index order (what bounds the kernel,
// the block cull and the rounding rules are in soft_common.cuh):
//   the geometry phase (barycentrics, nearest edge, perspective-correct L1
//   barycentrics, depth, validity, sigmoid coverage), Phong diffuse shading
//   over L lights, and the online-softmax update applied per triangle:
//     m' = max(m, z / gamma), w = cov * exp(z / gamma - m'),
//     S <- S * exp(m - m') + w (and each colour sum with w * shade),
//     sil <- sil * (1 - cov).
//   Invalid pairs are skipped: for them the update is an exact no-op.
// Epilogue (:486-493): rgb = S_c / (S_w + max(exp(EPS/gamma - m), EPS)),
// alpha = 1 - sil; m and S_w are written as the backward's residuals.
// Alpha equals the silhouette kernel K5's bit for bit: same geometry code,
// same triangles in the same order, same product.

#include "soft_common.cuh"

namespace {

__global__ void __launch_bounds__(kSoftThreads) soft_fwd_kernel(
    const float* __restrict__ table,    // [B, T, 59]
    const float4* __restrict__ lights,  // [B, L] (x, y, z, intensity)
    const float* __restrict__ params,   // sigma, gamma, blur^2, row offset
    float4* __restrict__ rgba,          // [B, H, W]
    float* __restrict__ m_out,          // [B, H, W]
    float* __restrict__ sumw_out,       // [B, H, W]
    int num_tris, int num_lights, int width, int height, int full_height) {
  __shared__ float slab[kSlabRows * kCols];
  __shared__ int kept_ids[kSlabRows];
  __shared__ int warp_kept[kSlabWarps];
  __shared__ float4 s_lights[kMaxLights];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int x = blockIdx.x * kSoftBlockX + threadIdx.x;
  const int y = blockIdx.y * kSoftBlockY + threadIdx.y;
  const bool in_image = x < width && y < height;
  const SoftParams p = load_params(params);
  for (int l = tid; l < num_lights; l += kSoftThreads) {
    s_lights[l] = lights[static_cast<size_t>(b) * num_lights + l];
  }
  const float px = pixel_x(x, width);
  const float py = pixel_y(y, p.row_off, full_height);
  const BlockExtent extent = block_extent(width, height, p.row_off,
                                          full_height);
  const float* rows_b = table + static_cast<size_t>(b) * num_tris * kCols;

  float m = kEps / p.gamma;
  float sum_w = 0.0f, sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;
  float sil = 1.0f;
  for (int t0 = 0; t0 < num_tris; t0 += kSlabRows) {
    const int n_kept = stage_rows(rows_b, t0, min(kSlabRows, num_tris - t0),
                                  extent, slab, kept_ids, warp_kept);
    if (!in_image) continue;
    for (int k = 0; k < n_kept; ++k) {
      const float* r = slab + k * kCols;
      const SoftGeometry g = soft_geometry(r, px, py, p.sigma, p.sq_blur);
      if (!g.valid) continue;
      const SoftShade s = soft_shade(r, g, s_lights, num_lights);
      const float logit = g.z / p.gamma;
      const float new_max = fmaxf(m, logit);
      const float scale = expf(m - new_max);
      const float w = g.coverage * expf(logit - new_max);
      sum_w = sum_w * scale + w;
      sum_r = sum_r * scale + w * (s.cr * s.light_sum);
      sum_g = sum_g * scale + w * (s.cg * s.light_sum);
      sum_b = sum_b * scale + w * (s.cb * s.light_sum);
      m = new_max;
      sil = sil * (1.0f - g.coverage);
    }
  }
  if (!in_image) return;
  const size_t pixel =
      (static_cast<size_t>(b) * height + y) * static_cast<size_t>(width) + x;
  const float bg = fmaxf(expf(kEps / p.gamma - m), kEps);
  const float inv_total = 1.0f / (sum_w + bg);
  rgba[pixel] = make_float4(sum_r * inv_total, sum_g * inv_total,
                            sum_b * inv_total, 1.0f - sil);
  m_out[pixel] = m;
  sumw_out[pixel] = sum_w;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors. The caller
// checks shapes, types, alignment and num_lights <= 64.
extern "C" int soft_fwd(const void* table, const void* lights,
                        const void* params, void* rgba, void* m, void* sumw,
                        int batch, int num_tris, int num_lights, int width,
                        int height, int full_height, void* stream) {
  const dim3 block(kSoftBlockX, kSoftBlockY);
  const dim3 grid((width + kSoftBlockX - 1) / kSoftBlockX,
                  (height + kSoftBlockY - 1) / kSoftBlockY, batch);
  soft_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float4*>(lights),
      static_cast<const float*>(params), static_cast<float4*>(rgba),
      static_cast<float*>(m), static_cast<float*>(sumw), num_tris,
      num_lights, width, height, full_height);
  return static_cast<int>(cudaGetLastError());
}
