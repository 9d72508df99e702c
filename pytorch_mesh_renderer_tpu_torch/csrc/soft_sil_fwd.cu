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
// softmax. K5 is the instance of K7's cluster body (soft_cluster_fwd.cuh)
// without shading: the same cull, split, rounds and ordered fold, with one
// record field (the coverage, 8 KB of records) and sil <- sil * (1 -
// coverage) as the fold, over the same valid pairs in the same order as
// K7's product, so its alpha equals K7's bit for bit at every split.
//
// What bounds it: its pairs are cheap (~110 fp32 operations), so the
// stream and cull of every row by every pixel block weigh as much as the
// busy blocks' chains. On the H100 (PERF.md) the teapot's table with no
// row kept takes 0.048 ms at kSplit 4 of K5's 0.128 at 256x256 batch 4
// (the one-CTA-per-block design it replaced: 0.031 of 0.124), and the
// split pays at the cow fit's 128x128 x 4 views (0.042 -> 0.036 ms).

#include "soft_cluster_fwd.cuh"

namespace {

// CTAs per pixel block (the cluster's size). Chosen from the device times
// at 4 and 8 on the H100 (PERF.md).
constexpr int kSplit = 4;

__global__ void __launch_bounds__(kSoftThreads, 4) soft_sil_fwd_kernel(
    const float* __restrict__ table,   // [B, T, 59]
    const float* __restrict__ params,  // sigma, gamma, blur^2, row offset
    float* __restrict__ alpha,         // [B, H, W]
    int num_tris, int width, int height, int full_height) {
  soft_cluster_forward<false>(table, nullptr, params, nullptr, nullptr,
                              nullptr, alpha, num_tris, 0, width, height,
                              full_height);
}

}  // namespace

// Launches the kernel in clusters of `split` CTAs per pixel block (0 for
// kSplit, the kernel's own; 1, 2, 4 or 8; other values than kSplit serve
// only to measure that choice) on `stream` and returns the launch's CUDA
// error (0 on success). Pointers are device pointers to contiguous
// tensors. The caller checks shapes and types.
extern "C" int soft_sil_fwd(const void* table, const void* params,
                            void* alpha, int batch, int num_tris, int width,
                            int height, int full_height, int split,
                            void* stream) {
  return launch_soft_cluster(
      soft_sil_fwd_kernel, kRecordBytes<false>, kSplit, split, batch, width,
      height, stream, static_cast<const float*>(table),
      static_cast<const float*>(params), static_cast<float*>(alpha),
      num_tris, width, height, full_height);
}

// Resident CTAs of soft_sil_fwd_kernel per SM at its block size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int soft_sil_fwd_blocks_per_sm() {
  return soft_cluster_blocks_per_sm(soft_sil_fwd_kernel,
                                    kRecordBytes<false>);
}
