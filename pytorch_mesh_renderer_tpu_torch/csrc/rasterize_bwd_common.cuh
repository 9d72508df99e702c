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
// What bounds them: every pixel contributes to one triangle only, its
// winner, so the per-pixel arithmetic is a few tens of operations and the
// cost is reading the pixel's inputs (ids and bc of every pixel; g, gattr
// of the active ones) and reducing 9 + 3A values per active pixel into
// the per-triangle table, all of a neighbourhood on the same rows.
//
// This header holds what the two share: the activity test, the closed
// form (`clip_terms`), the segmented warp sums over runs of equal winner
// (`run_sum`; `run_sums` for many columns at once), and K4's body
// (`accumulate_triangle_gradients`): one thread per pixel, 256 pixels of
// a row per block, so a warp holds 32 horizontally neighbouring pixels,
// which mostly share a winner. A warp finds its runs of equal winner id
// with one shuffle and one ballot, sums each value over each run with five
// `__shfl_down_sync` steps, and only the first lane of each run issues the
// atomic add into the table in device memory, which has no per-pass cap.
// K2 (rasterize_fused_bwd.cu) first sorts each warp's lanes by winner.
// The scatter from triangles to vertices ([B, T, 9 + 3A] -> [B, V, 4] and
// [B, V, A]) is T-sized and stays plain PyTorch, as the JAX package leaves
// `_scatter_corner_grads` to XLA.
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

// run_sum of each of v[0, n) (n <= N, the same on every lane), the
// columns' shuffles of a step issued together, over the steps that runs
// of up to `span` lanes (a power of two, the same on every lane) need.
template <int N>
__device__ __forceinline__ void run_sums(float (&v)[N], int n, int lane,
                                         int run_end, int span) {
  for (int offset = 1; offset < span; offset <<= 1) {
    const bool add = lane + offset < run_end;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const float other = __shfl_down_sync(kFullMask, v[i], offset);
        if (add) v[i] += other;
      }
    }
  }
}

// Whether a pixel with winner t and barycentrics c0..c2 contributes: not
// an uncovered pixel (id 0 with a barycentric sum below the cutoff), and
// a winner inside the table.
__device__ __forceinline__ bool pixel_active(int t, float c0, float c1,
                                             float c2, int num_tris) {
  return !(t == 0 && c0 + c1 + c2 < kDegenerateBarycentricCutoff) &&
         t >= 0 && t < num_tris;
}

// The closed form's t_c (c in x, y, w) for bc cotangent g, barycentrics b
// and the winner's packed row (its sign-corrected adjugate m in columns
// 0-8) and 1/|det|.
__device__ __forceinline__ void clip_terms(float g0, float g1, float g2,
                                           float b0, float b1, float b2,
                                           const float4* row, float inv,
                                           float* tc) {
  const float4 r0 = row[0];  // m00 m01 m02 m10
  const float4 r1 = row[1];  // m11 m12 m20 m21
  const float m22 = row[2].x;
  const float gb = g0 * b0 + g1 * b1 + g2 * b2;
  const float sx = r0.x + r0.w + r1.z;
  const float sy = r0.y + r1.x + r1.w;
  const float sw = r0.z + r1.y + m22;
  const float rx = g0 * r0.x + g1 * r0.w + g2 * r1.z;
  const float ry = g0 * r0.y + g1 * r1.x + g2 * r1.w;
  const float rw = g0 * r0.z + g1 * r1.y + g2 * m22;
  tc[0] = (sx * gb - rx) * inv;
  tc[1] = (sy * gb - ry) * inv;
  tc[2] = (sw * gb - rw) * inv;
}

// The first lane of the run of equal `id` that holds this lane, and the
// run's end: runs are maximal spans of lanes with one id (-1 included).
__device__ __forceinline__ int run_end_of(int id, int lane, bool* head) {
  const int prev = __shfl_up_sync(kFullMask, id, 1);
  *head = lane == 0 || prev != id;
  const unsigned heads = __ballot_sync(kFullMask, *head);
  const unsigned later = lane == 31 ? 0u : heads & (kFullMask << (lane + 1));
  return later ? __ffs(later) - 1 : 32;
}

// K4's body. One pixel per thread: blockIdx.y is the batch image,
// blockIdx.x * 256 + threadIdx.x the pixel in it (row-major).
__device__ __forceinline__ void accumulate_triangle_gradients(
    const int* __restrict__ ids,            // [B, H*W]
    const float* __restrict__ bc,           // [B, H*W, 3]
    const float* __restrict__ g_bc,         // [B, H*W, 3]
    const float4* __restrict__ tri_rows,    // [B, T, 16]
    const float* __restrict__ inv_abs_det,  // [B, T]
    float* __restrict__ dtab,               // [B, T, 9]
    int num_tris, int pixels) {
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
    if (pixel_active(t, c0, c1, c2, num_tris)) {
      id = t;
      b0 = c0;
      b1 = c1;
      b2 = c2;
    }
  }
  const size_t tri = static_cast<size_t>(b) * num_tris + (id >= 0 ? id : 0);

  float tc[3] = {0.0f, 0.0f, 0.0f};
  if (id >= 0) {
    clip_terms(g_bc[pixel * 3 + 0], g_bc[pixel * 3 + 1], g_bc[pixel * 3 + 2],
               b0, b1, b2, tri_rows + tri * 4, inv_abs_det[tri], tc);
  }

  // Runs of lanes with equal winner id; only a run's first lane writes.
  bool head;
  const int run_end = run_end_of(id, lane, &head);
  const bool writer = head && id >= 0;
  float* out = dtab + tri * 9;
  const float bk[3] = {b0, b1, b2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = run_sum(bk[k] * tc[c], lane, run_end);
      if (writer) atomicAdd(out + c * 3 + k, v);
    }
  }
}

}  // namespace
