// Full SoftRas analytic backward, for Hopper.
//
// Replaces the TPU kernel K8 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/soft_rasterize_pallas.py `_bwd_kernel`
//   (:496-790), launched by `_run_backward` (:1238).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/soft_rasterize_cuda.py
//   `soft_backward_torch_packed` (autograd of the plain forward).
//
// A recompute backward: for every (pixel, triangle) pair it re-runs the
// forward's geometry and shading (soft_common.cuh, the code K7 runs) and
// applies the hand-derived chain of the Pallas kernel (module docstring of
// soft_rasterize_pallas.py, :31-39): the softmax max m is a constant (it
// cancels); the silhouette term folds to dA * sil * cov * sgn / sigma; the
// squared-distance path uses the envelope theorem; the ndl and t clip
// gates zero their paths. The background weight's own gamma dependence is
// dropped, as there. There is no weight-sum cotangent (the port has no
// multi-pass merge) and m takes none.
//
// Outputs, zeroed by the caller: the table gradient [B, T, 59] (columns
// 0-17 and 26-55; the others get none: 18-20 and 21-25 enter the forward
// only through gates, 56-58 are caches whose chain is folded into the edge
// gradients), the light gradient [B, L, 4] and (dsigma, dgamma) per batch
// image [B, 2].
//
// What bounds it: the busy pixel blocks' pairs. On the 256x256 batch-4
// teapot 208 of the 1,024 pixel blocks hold a valid pair and the busiest
// stages 191 triangles; one CTA per block ran them in sequence on its 8
// warps, each (warp, triangle) item a chain of ~700 dependent fp32
// operations, 58 warp sums and 48 atomics issued by one lane. Each pair's
// chain is latency-bound, so what counts is how many warps run chains at
// once and how long the longest sequence is.
//
// The work split (soft_split.cuh; K6 runs the same). The grid is
// (ceil(W / 16), ceil(H / 16), B x kSplit):
// CTA s of a pixel block stages only the table rows t = s (mod kSplit), so
// neighbouring triangle ids land in different CTAs and a busy block's
// triangles spread over kSplit CTAs whatever the mesh's index order; all
// 256 threads cull, 256 rows a pass. A CTA that stages a row reads the
// block's per-pixel residuals (rgb, 1 - alpha, the cotangent, m and
// 1 / (sum_w + bg)) into shared memory once; one that stages none leaves.
// Its work is every (staged triangle, row pair the triangle's bbox rows
// touch) item, in triangle order, cut into 8 equal runs, one per warp; a
// lane takes one pixel of the 16x2 pair, and a pair in which no lane is
// valid is skipped (one ballot). A lane adds its pairs' 48 column
// gradients into registers; at the end of a triangle's items in the run
// one butterfly reduce-scatter over the warp (62 shuffles) leaves columns
// 2l and 2l + 1 with lane l, which adds them into the table in device
// memory: 48 atomics from 24 lanes at once. Light gradients are summed
// over the warp per pair (4 L values) into the CTA's shared accumulators
// (lights past kSharedLights straight into device memory, so any L is
// taken); dsigma and dgamma stay in each lane's registers until the CTA's
// end. Each CTA adds its non-zero light and (sigma, gamma) sums to device
// memory once. The table has no size cap. Two CTAs share an SM (the
// launch bounds cap registers at 128; ptxas spills the rest to L1): more
// chains in flight paid more than the spills cost on the H100 (PERF.md).
// Float atomics land in an order that changes from run to run, so the
// gradients' last bits do too; every per-pair value keeps the plain
// version's operation order (--fmad=false).

#include "soft_split.cuh"

namespace {

// Table columns with a gradient: 0-17 and 26-55.
constexpr int kNumGradCols = 48;
// The butterfly halves 64 padded columns five times: lane l keeps 2l, 2l+1.
constexpr int kPaddedCols = 64;
// CTAs per pixel block; each stages the rows of one residue mod kSplit.
// Chosen from the device times at 4, 8 and 16 on the H100 (PERF.md).
constexpr int kSplit = 8;
// Lights whose gradients a CTA sums in shared memory; later ones go to
// device memory directly.
constexpr int kSharedLights = 256;

__device__ __forceinline__ constexpr int grad_col(int i) {
  return i < 18 ? i : i + 8;
}

// d|v|/dv, +1 at v = 0 as jnp.abs's derivative and the plain route's
// (a pixel centre on an edge has a corner weight of exactly 0).
__device__ __forceinline__ float sign_of(float v) {
  return v >= 0.0f ? 1.0f : -1.0f;
}

__global__ void __launch_bounds__(kSoftThreads, 2) soft_bwd_kernel(
    const float* __restrict__ table,    // [B, T, 59]
    const float4* __restrict__ lights,  // [B, L] (x, y, z, intensity)
    const float* __restrict__ params,   // sigma, gamma, blur^2, row offset
    const float4* __restrict__ rgba,    // [B, H, W] forward output
    const float* __restrict__ m_in,     // [B, H, W] running max
    const float* __restrict__ sumw_in,  // [B, H, W] weight sum
    const float4* __restrict__ d_rgba,  // [B, H, W] cotangent
    float* __restrict__ dtable,         // [B, T, 59]
    float* __restrict__ dlights,        // [B, L, 4]
    float* __restrict__ dparams,        // [B, 2]
    int num_tris, int num_lights, int width, int height, int full_height,
    int split) {
  extern __shared__ float slab[];  // kStageRows x kCols
  __shared__ SplitShared sh;
  // Per-pixel residuals of the block: rgb and sil = 1 - alpha; the
  // cotangent; m; 1 / (sum_w + bg). Neutral outside the image.
  __shared__ float4 s_rgbs[kSoftThreads];
  __shared__ float4 s_d[kSoftThreads];
  __shared__ float s_m[kSoftThreads];
  __shared__ float s_inv[kSoftThreads];
  __shared__ float s_acc[4 * kSharedLights + 2];  // dlights, dsigma, dgamma

  const int b = blockIdx.z / split;
  const int part = blockIdx.z - b * split;
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int x0 = blockIdx.x * kSoftBlockX;
  const int y0 = blockIdx.y * kSoftBlockY;
  const SoftParams p = load_params(params);
  const int n_shared = min(num_lights, kSharedLights);
  const int n_acc = 4 * n_shared + 2;
  const BlockExtent extent = block_extent(width, height, p.row_off,
                                          full_height);
  const float* rows_b = table + static_cast<size_t>(b) * num_tris * kCols;
  float* dtab_b = dtable + static_cast<size_t>(b) * num_tris * kCols;
  const float4* lights_b = lights + static_cast<size_t>(b) * num_lights;
  float* dlights_b = dlights + static_cast<size_t>(b) * 4 * num_lights;

  // This lane's pixel column, and which row of a pair it takes.
  const int x = x0 + lane % kSoftBlockX;
  const float px = pixel_x(x, width);
  const int pair_row = lane / kSoftBlockX;
  const int rows_here = min(kSoftBlockY, height - y0);

  float dsig = 0.0f, dgam = 0.0f;  // this lane's sums over its pairs
  bool residuals_staged = false;
  for (int t0 = part; t0 < num_tris; t0 += kStageRows * split) {
    const int n_kept = stage_rows<kStageRows>(
        rows_b, t0, split_pass_rows(t0, num_tris, split), split, extent,
        slab, sh.kept_ids, sh.warp_kept);
    if (n_kept > 0 && !residuals_staged) {  // uniform over the block
      for (int i = tid; i < n_acc; i += kSoftThreads) s_acc[i] = 0.0f;
      stage_residuals(b, width, height, p.row_off, full_height, sh,
                      [&](int t, long long pixel) {
        float4 rgbs = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
        float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float m = 0.0f, inv_total = 0.0f;
        if (pixel >= 0) {
          const float4 c = rgba[pixel];
          rgbs = make_float4(c.x, c.y, c.z, 1.0f - c.w);
          d = d_rgba[pixel];
          m = m_in[pixel];
          const float bg = fmaxf(expf(kEps / p.gamma - m), kEps);
          inv_total = 1.0f / (sumw_in[pixel] + bg);
        }
        s_rgbs[t] = rgbs;
        s_d[t] = d;
        s_m[t] = m;
        s_inv[t] = inv_total;
      });
      residuals_staged = true;
    }
    if (n_kept == 0) continue;  // uniform over the block

    const int n_items = scan_row_pairs(slab, n_kept, rows_here, sh);
    const WarpRun run = warp_run(n_items, n_kept, sh);
    int k = run.k;
    float acc[kCols];  // this lane's column gradients of row k
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
    bool any_valid = false;  // uniform over the warp
    for (int i = run.i0; i < run.i1; ++i) {  // uniform over the warp
      const float* r = slab + k * kCols;
      const int row0 = item_row0(sh, k, i);
      const int pix = row0 * kSoftBlockX + lane;
      const float py = sh.py[row0 + pair_row];
      SoftGeometry g;
      g.valid = false;
      if (x < width && row0 + pair_row < rows_here) {
        g = soft_geometry(r, px, py, p.sigma, p.sq_blur);
      }
      const bool valid = g.valid;
      if (__any_sync(kFullMask, valid)) {
        any_valid = true;

        float dsq = 0.0f, dlight_sum = 0.0f;
        float dcr = 0.0f, dcg = 0.0f, dcbl = 0.0f;
        float dsb[3] = {0.0f, 0.0f, 0.0f};
        SoftShade s = {};
        if (valid) {
          const float4 rgb = s_rgbs[pix];
          const float4 d = s_d[pix];
          const float m = s_m[pix];
          const float inv_total = s_inv[pix];
          s = soft_shade(r, g, lights_b, num_lights);
          const float shade_r = s.cr * s.light_sum;
          const float shade_g = s.cg * s.light_sum;
          const float shade_b = s.cb * s.light_sum;
          const float E = expf(g.z / p.gamma - m);
          const float W = g.coverage * E;
          // rgb = sum(W * shade) / (sum_w + bg); m cancels, bg is constant.
          const float common = (d.x * (shade_r - rgb.x) +
                                d.y * (shade_g - rgb.y) +
                                d.z * (shade_b - rgb.z)) *
                               inv_total;
          const float ds_r = d.x * W * inv_total;
          const float ds_g = d.y * W * inv_total;
          const float ds_b = d.z * W * inv_total;
          // Coverage: the rgb term keeps sigmoid' = cov (1 - cov); the
          // silhouette term's (1 - cov) cancels against prod_{j != c}.
          dsq = (g.sgn / p.sigma) *
                (d.w * rgb.w * g.coverage +
                 common * E * g.cov_raw * (1.0f - g.cov_raw));
          // Depth: dW/dl = W; z = 0.5 - z_ndc / 2; l = z / gamma.
          const float dz_ndc = common * W / p.gamma * (-0.5f);
          dsig += -dsq * g.sq_dist / p.sigma;
          dgam += 2.0f * dz_ndc * g.z / p.gamma;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            dsb[c] = dz_ndc * r[15 + c];
            acc[15 + c] += dz_ndc * g.sb[c];
          }
          dcr = ds_r * s.light_sum;
          dcg = ds_g * s.light_sum;
          dcbl = ds_b * s.light_sum;
          dlight_sum = ds_r * s.cr + ds_g * s.cg + ds_b * s.cb;
        }

        // Lights, uniform over the warp: each light's four gradients are
        // summed over the warp into the CTA's accumulators.
        float dp3x = 0.0f, dp3y = 0.0f, dp3z = 0.0f;
        float dnx = 0.0f, dny = 0.0f, dnz = 0.0f;
        for (int l = 0; l < num_lights; ++l) {
          float ddx = 0.0f, ddy = 0.0f, ddz = 0.0f, dint = 0.0f;
          if (valid) {
            const float4 lt = __ldg(lights_b + l);
            const float dx = lt.x - s.p3x;
            const float dy = lt.y - s.p3y;
            const float dz = lt.z - s.p3z;
            const float d_norm = sqrtf(dx * dx + dy * dy + dz * dz);
            const float di = 1.0f / fmaxf(d_norm, 1e-12f);
            const float ct = (dx * s.nx + dy * s.ny + dz * s.nz) * di;
            const float ndl = fminf(fmaxf(ct, 0.0f), 1.0f);
            const float dndl = clip01_grad(ct) * (dlight_sum * lt.w);
            dint = dlight_sum * ndl;
            ddx = dndl * (s.nx * di - ct * dx * di * di);
            ddy = dndl * (s.ny * di - ct * dy * di * di);
            ddz = dndl * (s.nz * di - ct * dz * di * di);
            dnx += dndl * dx * di;
            dny += dndl * dy * di;
            dnz += dndl * dz * di;
            dp3x -= ddx;
            dp3y -= ddy;
            dp3z -= ddz;
          }
          const float sx = warp_sum(ddx);
          const float sy = warp_sum(ddy);
          const float sz = warp_sum(ddz);
          const float si = warp_sum(dint);
          if (lane == 0) {
            float* dst =
                l < kSharedLights ? s_acc + 4 * l : dlights_b + 4 * l;
            atomicAdd(dst + 0, sx);
            atomicAdd(dst + 1, sy);
            atomicAdd(dst + 2, sz);
            atomicAdd(dst + 3, si);
          }
        }

        if (valid) {
          // Normalize backward: u -> n.
          const float ndot = dnx * s.nx + dny * s.ny + dnz * s.nz;
          const float dux = (dnx - s.nx * ndot) * s.n_inv;
          const float duy = (dny - s.ny * ndot) * s.n_inv;
          const float duz = (dnz - s.nz * ndot) * s.n_inv;
          // Attribute interpolation transposes (corner-major columns).
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float sbc = g.sb[c];
            acc[26 + 3 * c] += dp3x * sbc;
            acc[27 + 3 * c] += dp3y * sbc;
            acc[28 + 3 * c] += dp3z * sbc;
            acc[35 + 3 * c] += dux * sbc;
            acc[36 + 3 * c] += duy * sbc;
            acc[37 + 3 * c] += duz * sbc;
            acc[44 + 3 * c] += dcr * sbc;
            acc[45 + 3 * c] += dcg * sbc;
            acc[46 + 3 * c] += dcbl * sbc;
            dsb[c] += dp3x * r[26 + 3 * c] + dp3y * r[27 + 3 * c] +
                      dp3z * r[28 + 3 * c] + dux * r[35 + 3 * c] +
                      duy * r[36 + 3 * c] + duz * r[37 + 3 * c] +
                      dcr * r[44 + 3 * c] + dcg * r[45 + 3 * c] +
                      dcbl * r[46 + 3 * c];
          }
          // L1-normalize backward: sb = ow / sum(|ow|).
          const float sdot = dsb[0] * g.sb[0] + dsb[1] * g.sb[1] +
                             dsb[2] * g.sb[2];
          float dcb[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float dow =
                (dsb[c] - sdot * sign_of(g.ow[c])) * g.inv_denom;
            dcb[c] = dow * r[53 + c];
            acc[53 + c] += dow * g.cb[c];  // d(1/w); the pack's chain: dw
          }
          float dts[3] = {0.0f, 0.0f, 0.0f};
          if (g.inside) {
            // cb = the screen barycentrics, linear in (px, py, 1).
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              acc[3 * c + 0] += dcb[c] * px;
              acc[3 * c + 1] += dcb[c] * py;
              acc[3 * c + 2] += dcb[c];
            }
          } else {
            // cb from the picked edge's offset t.
            dts[0] = g.pick == 0 ? dcb[1] - dcb[0] : 0.0f;
            dts[1] = g.pick == 1 ? dcb[2] - dcb[1] : 0.0f;
            dts[2] = g.pick == 2 ? dcb[0] - dcb[2] : 0.0f;
          }
          edge_gradients<true>(r, g, px, py, dsq, dts, acc);
        }
      }

      // Row k's last item of this run: its 48 columns, summed over the
      // warp once, go to the table; then on to the next row with items.
      if (!row_ends(sh, k, i, run.i1, n_kept)) continue;
      if (any_valid) {
        float t[kPaddedCols];
#pragma unroll
        for (int c = 0; c < kPaddedCols; ++c) {
          t[c] = c < kNumGradCols ? acc[grad_col(c)] : 0.0f;
        }
        reduce_scatter<kPaddedCols / 2, 16>(t, lane);
        float* out =
            dtab_b + static_cast<size_t>(t0 + sh.kept_ids[k]) * kCols;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 2 * lane + j;
          if (c < kNumGradCols && t[j] != 0.0f) {
            atomicAdd(out + grad_col(c), t[j]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
      any_valid = false;
      k = next_row(sh, k, i, n_kept);
    }
  }
  // Most CTAs stage no row (1,633 of 8,192 stage one on the 256x256
  // batch-4 teapot): they leave without the epilogue.
  if (!residuals_staged) return;  // uniform over the block
  const float sig_total = warp_sum(dsig);
  const float gam_total = warp_sum(dgam);
  if (lane == 0 && (sig_total != 0.0f || gam_total != 0.0f)) {
    atomicAdd(&s_acc[4 * n_shared + 0], sig_total);
    atomicAdd(&s_acc[4 * n_shared + 1], gam_total);
  }
  __syncthreads();
  for (int i = tid; i < n_acc; i += kSoftThreads) {
    const float total = s_acc[i];
    if (total == 0.0f) continue;
    float* dst = i < 4 * n_shared ? dlights_b + i
                                  : dparams + static_cast<size_t>(b) * 2 +
                                        (i - 4 * n_shared);
    atomicAdd(dst, total);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors; dtable,
// dlights and dparams are zeroed. The caller checks shapes, types and
// alignment. `split` is the CTAs per pixel block: 0 for kSplit, the
// kernel's own; other values serve only to measure that choice.
extern "C" int soft_bwd(const void* table, const void* lights,
                        const void* params, const void* rgba, const void* m,
                        const void* sumw, const void* d_rgba, void* dtable,
                        void* dlights, void* dparams, int batch, int num_tris,
                        int num_lights, int width, int height,
                        int full_height, int split, void* stream) {
  if (split == 0) split = kSplit;
  if (split < 1 || static_cast<long long>(batch) * split > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t error = cudaFuncSetAttribute(
      soft_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSlabBytes);
  if (error != cudaSuccess) return static_cast<int>(error);
  const dim3 block(kSoftBlockX, kSoftBlockY);
  const dim3 grid((width + kSoftBlockX - 1) / kSoftBlockX,
                  (height + kSoftBlockY - 1) / kSoftBlockY, batch * split);
  soft_bwd_kernel<<<grid, block, kSlabBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float4*>(lights),
      static_cast<const float*>(params), static_cast<const float4*>(rgba),
      static_cast<const float*>(m), static_cast<const float*>(sumw),
      static_cast<const float4*>(d_rgba), static_cast<float*>(dtable),
      static_cast<float*>(dlights), static_cast<float*>(dparams), num_tris,
      num_lights, width, height, full_height, split);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs of soft_bwd_kernel per SM at its block size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int soft_bwd_blocks_per_sm() {
  cudaError_t error = cudaFuncSetAttribute(
      soft_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSlabBytes);
  int blocks = 0;
  if (error == cudaSuccess) {
    error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, soft_bwd_kernel, kSoftThreads, kSlabBytes);
  }
  return error == cudaSuccess ? blocks : -static_cast<int>(error);
}
