// Full SoftRas forward (shaded RGB + silhouette alpha), for Hopper.
//
// Replaces the TPU kernel K7 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/soft_rasterize_pallas.py `_fwd_kernel`
//   (:422-493), launched by `_run_forward` (:1185).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/soft_rasterize_cuda.py
//   `soft_forward_torch_packed`.
//
// Per pixel, over every triangle in index order (the rounding rules are in
// soft_common.cuh):
//   the geometry phase (barycentrics, nearest edge, perspective-correct L1
//   barycentrics, depth, validity, sigmoid coverage), Phong diffuse shading
//   over L lights, and the online-softmax update applied per triangle:
//     m' = max(m, z / gamma), w = cov * exp(z / gamma - m'),
//     S <- S * exp(m - m') + w (and each colour sum with w * shade),
//     sil <- sil * (1 - cov).
//   Invalid pairs are skipped: for them the update is an exact no-op.
// Epilogue (:486-493): rgb = S_c / (S_w + max(exp(EPS/gamma - m), EPS)),
// alpha = 1 - sil; m and S_w are written as the backward's residuals.
//
// What bounds it: the busy pixel blocks' pairs. Geometry and shading cost
// ~215 + 23 L fp32 operations per pair (IEEE divisions, square roots,
// expf), the fold ~10 and two expf. On the 256x256 batch-4 teapot 208 of
// 1,024 pixel blocks hold a valid pair and the busiest stages 191
// triangles; with one CTA per block each thread ran all of them in
// sequence. Split over a cluster, a busy block holds kSplit CTA slots for
// all its rounds, and at 3 CTAs per SM (80 registers, 48 KB of shared
// memory) the H100 holds 396 CTAs: the split pays where the busy blocks
// times kSplit about fit (67 x 8 at 128x128: 2.1x) and little where they
// take several waves (208 x 8 at 256x256: 5-13%; PERF.md).
//
// The design (a thread-block cluster of kSplit CTAs per pixel block, each
// pixel folding the cluster's records in index order through distributed
// shared memory) is in soft_cluster_fwd.cuh, whose body K7 shares with the
// silhouette forward K5 (soft_sil_fwd.cu): K7 is its instance with
// shading, so rgba, m and sum_w do not depend on kSplit and alpha equals
// K5's bit for bit.

#include "soft_cluster_fwd.cuh"

namespace {

// CTAs per pixel block (the cluster's size). Chosen from the device times
// at 4 and 8 on the H100 (PERF.md).
constexpr int kSplit = 8;

__global__ void __launch_bounds__(kSoftThreads, 3) soft_fwd_kernel(
    const float* __restrict__ table,    // [B, T, 59]
    const float4* __restrict__ lights,  // [B, L] (x, y, z, intensity)
    const float* __restrict__ params,   // sigma, gamma, blur^2, row offset
    float4* __restrict__ rgba,          // [B, H, W]
    float* __restrict__ m_out,          // [B, H, W]
    float* __restrict__ sumw_out,       // [B, H, W]
    int num_tris, int num_lights, int width, int height, int full_height) {
  soft_cluster_forward<true>(table, lights, params, rgba, m_out, sumw_out,
                             nullptr, num_tris, num_lights, width, height,
                             full_height);
}

}  // namespace

// Launches the kernel in clusters of `split` CTAs per pixel block (0 for
// kSplit, the kernel's own; 1, 2, 4 or 8; other values than kSplit serve
// only to measure that choice) on `stream` and returns the launch's CUDA
// error (0 on success). Pointers are device pointers to contiguous
// tensors. The caller checks shapes, types and alignment.
extern "C" int soft_fwd(const void* table, const void* lights,
                        const void* params, void* rgba, void* m, void* sumw,
                        int batch, int num_tris, int num_lights, int width,
                        int height, int full_height, int split,
                        void* stream) {
  return launch_soft_cluster(
      soft_fwd_kernel, kRecordBytes<true>, kSplit, split, batch, width,
      height, stream, static_cast<const float*>(table),
      static_cast<const float4*>(lights), static_cast<const float*>(params),
      static_cast<float4*>(rgba), static_cast<float*>(m),
      static_cast<float*>(sumw), num_tris, num_lights, width, height,
      full_height);
}

// Resident CTAs of soft_fwd_kernel per SM at its block size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int soft_fwd_blocks_per_sm() {
  return soft_cluster_blocks_per_sm(soft_fwd_kernel, kRecordBytes<true>);
}
