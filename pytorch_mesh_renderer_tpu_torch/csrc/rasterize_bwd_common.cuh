// Device code shared by the analytic hard-rasterizer backwards K2
// (rasterize_fused_bwd.cu, with attributes) and K4 (rasterize_bary_bwd.cu,
// barycentrics only). The TPU pair shares `_bwd_chunk_core`
// (rasterize_pallas.py:638) in the same way.
//
// Per-pixel closed form (rasterize_xla.py:21-32, 149-190;
// rasterize_pallas.py:638-673, 1344-1377). With g the pixel's bc cotangent,
// b its barycentrics, m the winner's sign-corrected adjugate (packed
// columns 0-8, row i = edge i) and gattr its attribute cotangent:
//   g_k  += sum_a gattr[a] * attr_k[winner, a]           (fused part)
//   t_c   = (s_c * <g, b> - sum_i g_i * m[i, c]) * inv_abs_det,
//           s_c = sum_i m[i, c], c in {x, y, w}
//   dclip_k[c] = b_k * t_c;  dattr_k[a] = b_k * gattr[a].
// Vertex z gets no gradient. A pixel is inactive when id == 0 and
// sum(bc) < 0.9 (DEGENERATE_BARYCENTRIC_CUTOFF); it contributes nothing.
//
// What bounds it: every pixel contributes to one triangle only, its winner,
// so the per-pixel arithmetic is a few tens of operations and the cost is
// reading the pixel's inputs (bc, g, gattr: (6 + A) * 4 bytes, plus its id)
// and reducing 9 + 3A values per pixel into the per-triangle table. Done
// with one atomic add per value and pixel, that is (9 + 3A) atomics per
// covered pixel, all of a neighbourhood on the same addresses.
//
// What the design does about it: one thread per pixel, 256 pixels of a row
// per block, so a warp holds 32 horizontally neighbouring pixels, which
// mostly share a winner. A warp finds its runs of equal winner id with one
// shuffle and one ballot, and sums each value over each run with five
// `__shfl_down_sync` steps (a segmented tree reduction); only the first
// lane of each run issues the atomic add into the [B, T, 9 + 3A] table in
// device memory. That divides the atomics by the run length (up to 32).
// The table has no per-pass cap: it lives in device memory, not in
// on-chip memory. The scatter from triangles to vertices ([B, T, 9 + 3A]
// -> [B, V, 4] and [B, V, A]) is T-sized and stays plain PyTorch, as the
// JAX package leaves `_scatter_corner_grads` to XLA.
//
// Rounding: the per-pixel values follow the plain version's operation
// order (built with --fmad=false), but float atomic adds land in an order
// that changes from run to run, so the table's last bits vary between runs
// and differ from the plain version's sequential sums.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBwdThreads = 256;
constexpr float kDegenerateBarycentricCutoff = 0.9f;
constexpr unsigned kFullMask = 0xffffffffu;

// Sums v over lanes [lane, run_end) of the warp: afterwards the first lane
// of each run holds that run's total. Every lane of the warp must call it.
// After the step with offset o, lane l holds the sum over
// [l, min(l + 2o, run_end)): lane l + o lies in the same run, so its
// partial sum stops at the same run_end.
__device__ __forceinline__ float run_sum(float v, int lane, int run_end) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const float other = __shfl_down_sync(kFullMask, v, offset);
    if (lane + offset < run_end) v += other;
  }
  return v;
}

// One pixel per thread: blockIdx.y is the batch image, blockIdx.x * 256 +
// threadIdx.x the pixel in it (row-major). kWithAttrs selects the fused
// part (K2); without it gattr and corner are unused (K4).
template <bool kWithAttrs>
__device__ __forceinline__ void accumulate_triangle_gradients(
    const int* __restrict__ ids,            // [B, H*W]
    const float* __restrict__ bc,           // [B, H*W, 3]
    const float* __restrict__ g_bc,         // [B, H*W, 3]
    const float* __restrict__ g_attr,       // [B, H*W, A]
    const float4* __restrict__ tri_rows,    // [B, T, 16]
    const float* __restrict__ inv_abs_det,  // [B, T]
    const float* __restrict__ corner,       // [B, T, 3, A]
    float* __restrict__ dtab,               // [B, T, 9 + 3A]
    int num_tris, int num_attrs, int pixels) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kBwdThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const size_t pixel = static_cast<size_t>(b) * pixels + p;

  // The winner, or -1 when the pixel is outside the image or inactive.
  int id = -1;
  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
  if (p < pixels) {
    const int t = ids[pixel];
    const float c0 = bc[pixel * 3 + 0];
    const float c1 = bc[pixel * 3 + 1];
    const float c2 = bc[pixel * 3 + 2];
    const bool active =
        !(t == 0 && c0 + c1 + c2 < kDegenerateBarycentricCutoff);
    if (active && t >= 0 && t < num_tris) {
      id = t;
      b0 = c0;
      b1 = c1;
      b2 = c2;
    }
  }
  const size_t tri = static_cast<size_t>(b) * num_tris + (id >= 0 ? id : 0);

  float tx = 0.0f, ty = 0.0f, tw = 0.0f;
  if (id >= 0) {
    float g0 = g_bc[pixel * 3 + 0];
    float g1 = g_bc[pixel * 3 + 1];
    float g2 = g_bc[pixel * 3 + 2];
    if constexpr (kWithAttrs) {
      const float* ga = g_attr + pixel * num_attrs;
      const float* ca = corner + tri * 3 * num_attrs;
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
      for (int a = 0; a < num_attrs; ++a) {
        const float gv = ga[a];
        d0 += gv * ca[a];
        d1 += gv * ca[num_attrs + a];
        d2 += gv * ca[2 * num_attrs + a];
      }
      g0 = g0 + d0;
      g1 = g1 + d1;
      g2 = g2 + d2;
    }
    const float4* row = tri_rows + tri * 4;
    const float4 r0 = row[0];  // m00 m01 m02 m10
    const float4 r1 = row[1];  // m11 m12 m20 m21
    const float m22 = row[2].x;
    const float inv = inv_abs_det[tri];
    const float gb = g0 * b0 + g1 * b1 + g2 * b2;
    const float sx = r0.x + r0.w + r1.z;
    const float sy = r0.y + r1.x + r1.w;
    const float sw = r0.z + r1.y + m22;
    const float rx = g0 * r0.x + g1 * r0.w + g2 * r1.z;
    const float ry = g0 * r0.y + g1 * r1.x + g2 * r1.w;
    const float rw = g0 * r0.z + g1 * r1.y + g2 * m22;
    tx = (sx * gb - rx) * inv;
    ty = (sy * gb - ry) * inv;
    tw = (sw * gb - rw) * inv;
  }

  // Runs of lanes with equal winner id; only a run's first lane writes.
  const int prev = __shfl_up_sync(kFullMask, id, 1);
  const bool head = lane == 0 || prev != id;
  const unsigned heads = __ballot_sync(kFullMask, head);
  const unsigned later = lane == 31 ? 0u : heads & (kFullMask << (lane + 1));
  const int run_end = later ? __ffs(later) - 1 : 32;
  const bool writer = head && id >= 0;
  float* out = dtab + tri * (9 + 3 * num_attrs);

  const float tc[3] = {tx, ty, tw};
  const float bk[3] = {b0, b1, b2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = run_sum(bk[k] * tc[c], lane, run_end);
      if (writer) atomicAdd(out + c * 3 + k, v);
    }
  }
  if constexpr (kWithAttrs) {
    for (int a = 0; a < num_attrs; ++a) {  // num_attrs is warp-uniform
      const float gv = id >= 0 ? g_attr[pixel * num_attrs + a] : 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = run_sum(bk[k] * gv, lane, run_end);
        if (writer) atomicAdd(out + 9 + k * num_attrs + a, v);
      }
    }
  }
}

}  // namespace
