// Device code shared by the forward hard rasterizers K1
// (rasterize_fused_fwd.cu) and K3 (rasterize_bary_fwd.cu), whose one
// cluster body is rasterize_cluster_fwd.cuh (S2's production core `prod`,
// mxu_full.cu, runs it too), and by S3 (patch_eval.cu): the per-block edge
// cull (`row_may_cover`), the per-pixel test (`consider_row`) and the order
// of winners (`wins`). The TPU pair shares `_rasterize_chunk_core`
// (rasterize_pallas.py:265) in the same way.
//
// What bounds it: tested brute force, every (pixel, triangle) pair costs a
// few tens of fp32 operations. At 256x256, batch 4 and 2,464 triangles that
// is 6.5e8 tests, bound by fp32 issue and latency, not by device-memory
// bytes: the 16-byte triangle data of a test is shared by every pixel of a
// block. Most pairs cannot hit: a triangle of the teapot covers a few of a
// batch image's 256 blocks, so the cluster body drops a row for a block
// when one of its edge functions is provably negative at the block's four
// corner pixel centres (`row_may_cover`), which changes no output bit.

// Rounding: build with --fmad=false. The plain version evaluates
// a*px + b*py + c as two products and two sums; an FMA would round
// differently and flip the inside test on edge pixels.
//
// Semantics (rasterize_pallas.py:254-340, 1190-1196):
//   e_i = a_i*px + b_i*py + c_i; inside when all e_i >= 0 and some e_i > 0;
//   z = sum(e*vz) / sum(e*vw) with a zero denominator replaced by 1;
//   valid = inside && live && -1 <= z <= 1; smallest z wins, ties go to the
//   larger triangle id; the carry starts at z = 1, id = -1.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr int kThreads = kBlockX * kBlockY;
// Packed triangle row: 9 edge coefficients, 3 clip z, 3 clip w, liveness.
constexpr int kRowFloat4s = 4;

__device__ __forceinline__ float pixel_ndc(int index, float scale) {
  return (static_cast<float>(index) + 0.5f) * scale - 1.0f;
}

// False only if edge a*px + b*py + c is negative at every pixel centre of
// the block [px_lo, px_hi] x [py_lo, py_hi], as evaluated in fp32 by the
// per-pixel test. fl(a*px + b*py + c) is within
// bound = 1e-6 * (|a|*max|px| + |b|*max|py| + |c|) of the exact value (the
// rounding error of three operations is below 1.8e-7 times that sum), so
// if all four corners evaluate below -2*bound, the exact linear function is
// below -bound on the whole block and every evaluation inside stays < 0.
// NaN or infinite values never cull.
__device__ __forceinline__ bool edge_may_cover(float a, float b, float c,
                                               float px_lo, float px_hi,
                                               float py_lo, float py_hi,
                                               float px_max, float py_max) {
  const float e00 = a * px_lo + b * py_lo + c;
  const float e10 = a * px_hi + b * py_lo + c;
  const float e01 = a * px_lo + b * py_hi + c;
  const float e11 = a * px_hi + b * py_hi + c;
  const float bound =
      1e-6f * (fabsf(a) * px_max + fabsf(b) * py_max + fabsf(c)) + 1e-30f;
  return !(fmaxf(fmaxf(e00, e10), fmaxf(e01, e11)) < -2.0f * bound);
}

__device__ __forceinline__ bool row_may_cover(const float4* row, float px_lo,
                                              float px_hi, float py_lo,
                                              float py_hi) {
  const float4 r0 = row[0], r1 = row[1], r2 = row[2];
  if (!(row[3].w > 0.0f)) return false;  // dead: all three w < 0
  const float px_max = fmaxf(1.0f, fmaxf(fabsf(px_lo), fabsf(px_hi)));
  const float py_max = fmaxf(1.0f, fmaxf(fabsf(py_lo), fabsf(py_hi)));
  return edge_may_cover(r0.x, r0.y, r0.z, px_lo, px_hi, py_lo, py_hi,
                        px_max, py_max) &&
         edge_may_cover(r0.w, r1.x, r1.y, px_lo, px_hi, py_lo, py_hi,
                        px_max, py_max) &&
         edge_may_cover(r1.z, r1.w, r2.x, px_lo, px_hi, py_lo, py_hi,
                        px_max, py_max);
}

// The z-buffer carry of one pixel after every triangle: the winner's depth,
// id (-1 when none) and three raw edge values.
struct Winner {
  float z;
  int id;
  float we0, we1, we2;
};

// The per-pixel test of live row `row` (triangle t) at pixel centre
// (px, py): if the pixel lies inside and its depth is valid and wins (the
// smaller z; on equal z the larger id), the row becomes `best`. The depth
// divide runs only for pixels inside the triangle.
__device__ __forceinline__ void consider_row(const float4* row, float px,
                                             float py, int t, Winner& best) {
  const float4 r0 = row[0];  // a0 b0 c0 a1
  const float4 r1 = row[1];  // b1 c1 a2 b2
  const float e0 = r0.x * px + r0.y * py + r0.z;
  const float e1 = r0.w * px + r1.x * py + r1.y;
  const float4 r2 = row[2];  // c2 z0 z1 z2
  const float e2 = r1.z * px + r1.w * py + r2.x;
  const bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                      (e0 > 0.0f || e1 > 0.0f || e2 > 0.0f);
  if (!inside) return;
  const float4 r3 = row[3];  // w0 w1 w2 live
  const float num = e0 * r2.y + e1 * r2.z + e2 * r2.w;
  const float den = e0 * r3.x + e1 * r3.y + e2 * r3.z;
  const float z = num / (den != 0.0f ? den : 1.0f);
  if (z >= -1.0f && z <= 1.0f &&
      (z < best.z || (z == best.z && t > best.id))) {
    best.z = z;
    best.id = t;
    best.we0 = e0;
    best.we1 = e1;
    best.we2 = e2;
  }
}

// Whether carry c wins over best: the order of the per-pixel test, a total
// order on (z, id) pairs since ids differ (-0.0 == 0.0 ties go to the
// larger id as well). Merging carries of disjoint row sets by it in any
// order gives the carry of one thread running every row.
__device__ __forceinline__ bool wins(const Winner& c, const Winner& best) {
  return c.z < best.z || (c.z == best.z && c.id > best.id);
}

}  // namespace
