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
// nearest edge, split evenly among the edges of an exact tie
// (edge_gradients without the offset-t chain) and
// dsigma = -dsq * d^2 / sigma.
//
// What bounds it: the busy pixel blocks' pairs, as in K8 (soft_bwd.cu).
// On the 256x256 batch-4 teapot 208 of the 1,024 pixel blocks hold a
// valid pair and the busiest stages 191 triangles; at the cow fit's shape
// (128x128, 4 views, 1,152 triangles) 144 of 256 blocks are busy and the
// busiest stages 70. One CTA per block ran them in sequence on its 8
// warps, each (warp, triangle) a latency-bound chain (the geometry phase,
// 7 warp sums, up to 7 atomics from lane 0).
//
// The work split is K8's (soft_split.cuh). The grid is (ceil(W / 16),
// ceil(H / 16), B x kSplit): CTA s of a pixel block stages only the rows
// t = s (mod kSplit), 256 rows a pass; a CTA that stages a row reads the
// block's residuals (sil = 1 - alpha and the cotangent) into shared memory
// once, and one that stages none leaves. Its (staged triangle, row pair)
// items are cut into one equal run per warp, one pixel per lane; a pair in
// which no lane is valid is skipped (one ballot). A lane keeps columns
// 9-14 and dsigma in registers; at the end of a triangle's items in the
// run one butterfly reduce-scatter (9 shuffles) leaves column
// (l >> 2) & 7 with lane l, and lanes 0, 4, ..., 20 add the six columns to
// the table at once. dsigma is summed over the CTA at its end and added to
// device memory once. With no light loop and 6 columns the pair chain is
// short, so three CTAs share an SM (the 60 KB slab of staged rows allows
// no more). Float atomics land in an order that changes from run to run,
// so the gradients' last bits do too; every per-pair value keeps the plain
// version's operation order (--fmad=false).

#include "soft_split.cuh"

namespace {

// CTAs per pixel block; each stages the rows of one residue mod kSplit.
// Chosen from the device times at 4, 8 and 16 on the H100 (PERF.md).
constexpr int kSplit = 4;
// Columns 9-14 padded to 8 for the butterfly.
constexpr int kEdgeCols = 6;
constexpr int kPaddedCols = 8;

__global__ void __launch_bounds__(kSoftThreads, 3) soft_sil_bwd_kernel(
    const float* __restrict__ table,    // [B, T, 59]
    const float* __restrict__ params,   // sigma, gamma, blur^2, row offset
    const float* __restrict__ alpha,    // [B, H, W] forward output
    const float* __restrict__ d_alpha,  // [B, H, W] cotangent
    float* __restrict__ dtable,         // [B, T, 59]
    float* __restrict__ dsigma,         // [B]
    int num_tris, int width, int height, int full_height, int split) {
  extern __shared__ float slab[];  // kStageRows x kCols
  __shared__ SplitShared sh;
  // Per-pixel residuals of the block: sil = 1 - alpha and the cotangent.
  // Neutral outside the image.
  __shared__ float s_sil[kSoftThreads];
  __shared__ float s_da[kSoftThreads];
  __shared__ float s_dsigma;

  const int b = blockIdx.z / split;
  const int part = blockIdx.z - b * split;
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int x0 = blockIdx.x * kSoftBlockX;
  const int y0 = blockIdx.y * kSoftBlockY;
  const SoftParams p = load_params(params);
  const BlockExtent extent = block_extent(width, height, p.row_off,
                                          full_height);
  const float* rows_b = table + static_cast<size_t>(b) * num_tris * kCols;
  float* dtab_b = dtable + static_cast<size_t>(b) * num_tris * kCols;

  // This lane's pixel column, and which row of a pair it takes.
  const int x = x0 + lane % kSoftBlockX;
  const float px = pixel_x(x, width);
  const int pair_row = lane / kSoftBlockX;
  const int rows_here = min(kSoftBlockY, height - y0);

  float dsig = 0.0f;  // this lane's sum over its pairs
  bool residuals_staged = false;
  for (int t0 = part; t0 < num_tris; t0 += kStageRows * split) {
    const int n_kept = stage_rows<kStageRows>(
        rows_b, t0, split_pass_rows(t0, num_tris, split), split, extent,
        slab, sh.kept_ids, sh.warp_kept);
    if (n_kept > 0 && !residuals_staged) {  // uniform over the block
      if (tid == 0) s_dsigma = 0.0f;
      stage_residuals(b, width, height, p.row_off, full_height, sh,
                      [&](int t, long long pixel) {
        s_sil[t] = pixel >= 0 ? 1.0f - alpha[pixel] : 1.0f;
        s_da[t] = pixel >= 0 ? d_alpha[pixel] : 0.0f;
      });
      residuals_staged = true;
    }
    if (n_kept == 0) continue;  // uniform over the block

    const int n_items = scan_row_pairs(slab, n_kept, rows_here, sh);
    const WarpRun run = warp_run(n_items, n_kept, sh);
    int k = run.k;
    float acc[kCols];  // this lane's column gradients of row k (9-14)
#pragma unroll
    for (int c = 9; c < 9 + kEdgeCols; ++c) acc[c] = 0.0f;
    bool any_valid = false;  // uniform over the warp
    for (int i = run.i0; i < run.i1; ++i) {  // uniform over the warp
      const float* r = slab + k * kCols;
      const int row0 = item_row0(sh, k, i);
      const float py = sh.py[row0 + pair_row];
      SoftGeometry g;
      g.valid = false;
      if (x < width && row0 + pair_row < rows_here) {
        g = soft_geometry(r, px, py, p.sigma, p.sq_blur);
      }
      if (__any_sync(kFullMask, g.valid)) {
        any_valid = true;
        if (g.valid) {
          const int pix = row0 * kSoftBlockX + lane;
          const float dsq =
              (g.sgn / p.sigma) * s_da[pix] * s_sil[pix] * g.coverage;
          edge_gradients<false>(r, g, px, py, dsq, nullptr, acc);
          dsig += -dsq * g.sq_dist / p.sigma;
        }
      }

      // Row k's last item of this run: its 6 columns, summed over the warp
      // once, go to the table; then on to the next row with items.
      if (!row_ends(sh, k, i, run.i1, n_kept)) continue;
      if (any_valid) {
        float t[kPaddedCols];
#pragma unroll
        for (int c = 0; c < kPaddedCols; ++c) {
          t[c] = c < kEdgeCols ? acc[9 + c] : 0.0f;
        }
        reduce_scatter<kPaddedCols / 2, 16>(t, lane);
        t[0] += __shfl_xor_sync(kFullMask, t[0], 2);
        t[0] += __shfl_xor_sync(kFullMask, t[0], 1);
        const int c = (lane >> 2) & 7;
        if ((lane & 3) == 0 && c < kEdgeCols && t[0] != 0.0f) {
          atomicAdd(dtab_b + static_cast<size_t>(t0 + sh.kept_ids[k]) *
                                 kCols + 9 + c,
                    t[0]);
        }
      }
#pragma unroll
      for (int c = 9; c < 9 + kEdgeCols; ++c) acc[c] = 0.0f;
      any_valid = false;
      k = next_row(sh, k, i, n_kept);
    }
  }
  // Most CTAs stage no row: they leave without the epilogue.
  if (!residuals_staged) return;  // uniform over the block
  const float sig_total = warp_sum(dsig);
  if (lane == 0 && sig_total != 0.0f) atomicAdd(&s_dsigma, sig_total);
  __syncthreads();
  if (tid == 0 && s_dsigma != 0.0f) atomicAdd(dsigma + b, s_dsigma);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors; dtable and
// dsigma are zeroed. The caller checks shapes and types. `split` is the
// CTAs per pixel block: 0 for kSplit, the kernel's own; other values serve
// only to measure that choice.
extern "C" int soft_sil_bwd(const void* table, const void* params,
                            const void* alpha, const void* d_alpha,
                            void* dtable, void* dsigma, int batch,
                            int num_tris, int width, int height,
                            int full_height, int split, void* stream) {
  if (split == 0) split = kSplit;
  if (split < 1 || static_cast<long long>(batch) * split > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t error = cudaFuncSetAttribute(
      soft_sil_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSlabBytes);
  if (error != cudaSuccess) return static_cast<int>(error);
  const dim3 block(kSoftBlockX, kSoftBlockY);
  const dim3 grid((width + kSoftBlockX - 1) / kSoftBlockX,
                  (height + kSoftBlockY - 1) / kSoftBlockY, batch * split);
  soft_sil_bwd_kernel<<<grid, block, kSlabBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(params),
      static_cast<const float*>(alpha), static_cast<const float*>(d_alpha),
      static_cast<float*>(dtable), static_cast<float*>(dsigma), num_tris,
      width, height, full_height, split);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs of soft_sil_bwd_kernel per SM at its block size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int soft_sil_bwd_blocks_per_sm() {
  cudaError_t error = cudaFuncSetAttribute(
      soft_sil_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSlabBytes);
  int blocks = 0;
  if (error == cudaSuccess) {
    error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, soft_sil_bwd_kernel, kSoftThreads, kSlabBytes);
  }
  return error == cudaSuccess ? blocks : -static_cast<int>(error);
}
