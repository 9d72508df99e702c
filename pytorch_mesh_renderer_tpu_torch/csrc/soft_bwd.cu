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
// The reduction from many pixels to many triangles: the blocks of the
// forward's tiling each stage the triangles that may touch them
// (soft_common.cuh). For a staged triangle every thread computes its
// pixel's contribution (zero for an invalid pair); a warp in which no
// lane is valid skips the triangle (one ballot). Otherwise each column is
// summed over the warp with five xor shuffles and lane 0 adds the non-zero
// sums into the table in device memory with atomicAdd. Light and
// (sigma, gamma) gradients are summed per block in shared memory and added
// to device memory once per block at the end. The table has no size cap.
// Float atomics land in an order that changes from run to run, so the
// gradients' last bits do too.

#include "soft_common.cuh"

namespace {

// Table columns with a gradient: 0-17 and 26-55.
constexpr int kNumGradCols = 48;

__device__ __forceinline__ constexpr int grad_col(int i) {
  return i < 18 ? i : i + 8;
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

__global__ void __launch_bounds__(kSoftThreads) soft_bwd_kernel(
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
    int num_tris, int num_lights, int width, int height, int full_height) {
  __shared__ float slab[kSlabRows * kCols];
  __shared__ int kept_ids[kSlabRows];
  __shared__ int warp_kept[kSlabWarps];
  __shared__ float4 s_lights[kMaxLights];
  __shared__ float s_acc[4 * kMaxLights + 2];  // dlights, dsigma, dgamma

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int x = blockIdx.x * kSoftBlockX + threadIdx.x;
  const int y = blockIdx.y * kSoftBlockY + threadIdx.y;
  const bool in_image = x < width && y < height;
  const SoftParams p = load_params(params);
  const int n_acc = 4 * num_lights + 2;
  for (int i = tid; i < n_acc; i += kSoftThreads) s_acc[i] = 0.0f;
  for (int l = tid; l < num_lights; l += kSoftThreads) {
    s_lights[l] = lights[static_cast<size_t>(b) * num_lights + l];
  }
  const float px = pixel_x(x, width);
  const float py = pixel_y(y, p.row_off, full_height);
  const BlockExtent extent = block_extent(width, height, p.row_off,
                                          full_height);
  const float* rows_b = table + static_cast<size_t>(b) * num_tris * kCols;
  float* dtab_b = dtable + static_cast<size_t>(b) * num_tris * kCols;

  // Residuals and cotangents of this pixel; neutral outside the image.
  float sil = 1.0f, inv_total = 0.0f, m = 0.0f;
  float4 rgb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (in_image) {
    const size_t pixel =
        (static_cast<size_t>(b) * height + y) * static_cast<size_t>(width) +
        x;
    rgb = rgba[pixel];
    d = d_rgba[pixel];
    m = m_in[pixel];
    sil = 1.0f - rgb.w;
    const float bg = fmaxf(expf(kEps / p.gamma - m), kEps);
    inv_total = 1.0f / (sumw_in[pixel] + bg);
  }

  for (int t0 = 0; t0 < num_tris; t0 += kSlabRows) {
    const int n_kept = stage_rows(rows_b, t0, min(kSlabRows, num_tris - t0),
                                  extent, slab, kept_ids, warp_kept);
    for (int k = 0; k < n_kept; ++k) {  // uniform over the block
      const float* r = slab + k * kCols;
      SoftGeometry g;
      g.valid = false;
      if (in_image) g = soft_geometry(r, px, py, p.sigma, p.sq_blur);
      const bool valid = g.valid;
      if (!__any_sync(kFullMask, valid)) continue;  // uniform over the warp

      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = 0.0f;
      float dsig = 0.0f, dgam = 0.0f, dsq = 0.0f, dlight_sum = 0.0f;
      float dcr = 0.0f, dcg = 0.0f, dcbl = 0.0f;
      float dsb[3] = {0.0f, 0.0f, 0.0f};
      SoftShade s = {};
      if (valid) {
        s = soft_shade(r, g, s_lights, num_lights);
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
              (d.w * sil * g.coverage +
               common * E * g.cov_raw * (1.0f - g.cov_raw));
        // Depth: dW/dl = W; z = 0.5 - z_ndc / 2; l = z / gamma.
        const float dz_ndc = common * W / p.gamma * (-0.5f);
        dsig = -dsq * g.sq_dist / p.sigma;
        dgam = 2.0f * dz_ndc * g.z / p.gamma;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dsb[c] = dz_ndc * r[15 + c];
          v[15 + c] = dz_ndc * g.sb[c];
        }
        dcr = ds_r * s.light_sum;
        dcg = ds_g * s.light_sum;
        dcbl = ds_b * s.light_sum;
        dlight_sum = ds_r * s.cr + ds_g * s.cg + ds_b * s.cb;
      }

      // Lights, uniform over the warp: each light's four gradients are
      // summed over the warp into the block's shared accumulators.
      float dp3x = 0.0f, dp3y = 0.0f, dp3z = 0.0f;
      float dnx = 0.0f, dny = 0.0f, dnz = 0.0f;
      for (int l = 0; l < num_lights; ++l) {
        float ddx = 0.0f, ddy = 0.0f, ddz = 0.0f, dint = 0.0f;
        if (valid) {
          const float4 lt = s_lights[l];
          const float dx = lt.x - s.p3x;
          const float dy = lt.y - s.p3y;
          const float dz = lt.z - s.p3z;
          const float d_norm = sqrtf(dx * dx + dy * dy + dz * dz);
          const float di = 1.0f / fmaxf(d_norm, 1e-12f);
          const float ct = (dx * s.nx + dy * s.ny + dz * s.nz) * di;
          const float ndl = fminf(fmaxf(ct, 0.0f), 1.0f);
          const float dndl =
              (ct > 0.0f && ct < 1.0f) ? dlight_sum * lt.w : 0.0f;
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
          atomicAdd(&s_acc[4 * l + 0], sx);
          atomicAdd(&s_acc[4 * l + 1], sy);
          atomicAdd(&s_acc[4 * l + 2], sz);
          atomicAdd(&s_acc[4 * l + 3], si);
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
          v[26 + 3 * c] = dp3x * sbc;
          v[27 + 3 * c] = dp3y * sbc;
          v[28 + 3 * c] = dp3z * sbc;
          v[35 + 3 * c] = dux * sbc;
          v[36 + 3 * c] = duy * sbc;
          v[37 + 3 * c] = duz * sbc;
          v[44 + 3 * c] = dcr * sbc;
          v[45 + 3 * c] = dcg * sbc;
          v[46 + 3 * c] = dcbl * sbc;
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
          const float dow = (dsb[c] - sdot * sign_of(g.ow[c])) * g.inv_denom;
          dcb[c] = dow * r[53 + c];
          v[53 + c] = dow * g.cb[c];  // d(1/w); the pack's chain gives dw
        }
        float dts[3] = {0.0f, 0.0f, 0.0f};
        if (g.inside) {
          // cb = the screen barycentrics, linear in (px, py, 1).
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v[3 * c + 0] = dcb[c] * px;
            v[3 * c + 1] = dcb[c] * py;
            v[3 * c + 2] = dcb[c];
          }
        } else {
          // cb from the picked edge's offset t.
          dts[0] = g.pick == 0 ? dcb[1] - dcb[0] : 0.0f;
          dts[1] = g.pick == 1 ? dcb[2] - dcb[1] : 0.0f;
          dts[2] = g.pick == 2 ? dcb[0] - dcb[2] : 0.0f;
        }
        edge_gradients<true>(r, g, px, py, dsq, dts, v);
      }

      float* out = dtab_b + static_cast<size_t>(t0 + kept_ids[k]) * kCols;
#pragma unroll
      for (int i = 0; i < kNumGradCols; ++i) {
        const int c = grad_col(i);
        const float total = warp_sum(v[c]);
        if (lane == 0 && total != 0.0f) atomicAdd(out + c, total);
      }
      const float sig_total = warp_sum(dsig);
      const float gam_total = warp_sum(dgam);
      if (lane == 0) {
        atomicAdd(&s_acc[4 * num_lights + 0], sig_total);
        atomicAdd(&s_acc[4 * num_lights + 1], gam_total);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n_acc; i += kSoftThreads) {
    float* dst = i < 4 * num_lights
                     ? dlights + static_cast<size_t>(b) * 4 * num_lights + i
                     : dparams + static_cast<size_t>(b) * 2 +
                           (i - 4 * num_lights);
    atomicAdd(dst, s_acc[i]);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors; dtable,
// dlights and dparams are zeroed. The caller checks shapes, types,
// alignment and num_lights <= 64.
extern "C" int soft_bwd(const void* table, const void* lights,
                        const void* params, const void* rgba, const void* m,
                        const void* sumw, const void* d_rgba, void* dtable,
                        void* dlights, void* dparams, int batch, int num_tris,
                        int num_lights, int width, int height,
                        int full_height, void* stream) {
  const dim3 block(kSoftBlockX, kSoftBlockY);
  const dim3 grid((width + kSoftBlockX - 1) / kSoftBlockX,
                  (height + kSoftBlockY - 1) / kSoftBlockY, batch);
  soft_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float4*>(lights),
      static_cast<const float*>(params), static_cast<const float4*>(rgba),
      static_cast<const float*>(m), static_cast<const float*>(sumw),
      static_cast<const float4*>(d_rgba), static_cast<float*>(dtable),
      static_cast<float*>(dlights), static_cast<float*>(dparams), num_tris,
      num_lights, width, height, full_height);
  return static_cast<int>(cudaGetLastError());
}
