// Silhouette-only SoftRas analytic backward, for Hopper.
//
// Replaces the TPU kernel K6 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/soft_rasterize_pallas.py
//   `_bwd_kernel_sil` (:881-948), launched by `_run_backward_sil` (:1034).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/soft_rasterize_cuda.py
//   `soft_silhouette_backward_torch_packed`.
//
// Alpha touches the table only through coverage = sigmoid(sgn d^2 / sigma)
// gated by validity, so only the six edge-endpoint columns (9-14) and
// sigma take a gradient: per valid pair dsq = sgn / sigma * dA * sil * cov
// (d alpha / d cov = prod_{j != c}(1 - cov_j), whose (1 - cov) cancels
// against the sigmoid's derivative), the squared-distance chain of the
// picked edge (edge_gradients without the offset-t chain) and
// dsigma = -dsq * d^2 / sigma. The reduction is K8's (soft_bwd.cu): a warp
// skips a triangle none of its lanes finds valid, else sums each column
// with xor shuffles and lane 0 adds it to the [B, T, 59] table with
// atomicAdd; dsigma is summed per block. The atomic order makes the last
// bits vary from run to run.

#include "soft_common.cuh"

namespace {

__global__ void __launch_bounds__(kSoftThreads) soft_sil_bwd_kernel(
    const float* __restrict__ table,    // [B, T, 59]
    const float* __restrict__ params,   // sigma, gamma, blur^2, row offset
    const float* __restrict__ alpha,    // [B, H, W] forward output
    const float* __restrict__ d_alpha,  // [B, H, W] cotangent
    float* __restrict__ dtable,         // [B, T, 59]
    float* __restrict__ dsigma,         // [B]
    int num_tris, int width, int height, int full_height) {
  __shared__ float slab[kSlabRows * kCols];
  __shared__ int kept_ids[kSlabRows];
  __shared__ int warp_kept[kSlabWarps];
  __shared__ float s_dsigma;

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int x = blockIdx.x * kSoftBlockX + threadIdx.x;
  const int y = blockIdx.y * kSoftBlockY + threadIdx.y;
  const bool in_image = x < width && y < height;
  const SoftParams p = load_params(params);
  if (tid == 0) s_dsigma = 0.0f;
  const float px = pixel_x(x, width);
  const float py = pixel_y(y, p.row_off, full_height);
  const BlockExtent extent = block_extent(width, height, p.row_off,
                                          full_height);
  const float* rows_b = table + static_cast<size_t>(b) * num_tris * kCols;
  float* dtab_b = dtable + static_cast<size_t>(b) * num_tris * kCols;

  float sil = 1.0f, d_a = 0.0f;
  if (in_image) {
    const size_t pixel =
        (static_cast<size_t>(b) * height + y) * static_cast<size_t>(width) +
        x;
    sil = 1.0f - alpha[pixel];
    d_a = d_alpha[pixel];
  }

  for (int t0 = 0; t0 < num_tris; t0 += kSlabRows) {
    const int n_kept = stage_rows(rows_b, t0, min(kSlabRows, num_tris - t0),
                                  extent, slab, kept_ids, warp_kept);
    for (int k = 0; k < n_kept; ++k) {  // uniform over the block
      const float* r = slab + k * kCols;
      SoftGeometry g;
      g.valid = false;
      if (in_image) g = soft_geometry(r, px, py, p.sigma, p.sq_blur);
      if (!__any_sync(kFullMask, g.valid)) continue;  // uniform over warp
      float v[kCols];
#pragma unroll
      for (int c = 9; c < 15; ++c) v[c] = 0.0f;
      float dsig = 0.0f;
      if (g.valid) {
        const float dsq = (g.sgn / p.sigma) * d_a * sil * g.coverage;
        edge_gradients<false>(r, g, px, py, dsq, nullptr, v);
        dsig = -dsq * g.sq_dist / p.sigma;
      }
      float* out = dtab_b + static_cast<size_t>(t0 + kept_ids[k]) * kCols;
#pragma unroll
      for (int c = 9; c < 15; ++c) {
        const float total = warp_sum(v[c]);
        if (lane == 0 && total != 0.0f) atomicAdd(out + c, total);
      }
      const float sig_total = warp_sum(dsig);
      if (lane == 0) atomicAdd(&s_dsigma, sig_total);
    }
  }
  __syncthreads();
  if (tid == 0) atomicAdd(dsigma + b, s_dsigma);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors; dtable and
// dsigma are zeroed. The caller checks shapes and types.
extern "C" int soft_sil_bwd(const void* table, const void* params,
                            const void* alpha, const void* d_alpha,
                            void* dtable, void* dsigma, int batch,
                            int num_tris, int width, int height,
                            int full_height, void* stream) {
  const dim3 block(kSoftBlockX, kSoftBlockY);
  const dim3 grid((width + kSoftBlockX - 1) / kSoftBlockX,
                  (height + kSoftBlockY - 1) / kSoftBlockY, batch);
  soft_sil_bwd_kernel<<<grid, block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(params),
      static_cast<const float*>(alpha), static_cast<const float*>(d_alpha),
      static_cast<float*>(dtable), static_cast<float*>(dsigma), num_tris,
      width, height, full_height);
  return static_cast<int>(cudaGetLastError());
}
