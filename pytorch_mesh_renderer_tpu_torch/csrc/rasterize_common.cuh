// Device code shared by the forward hard rasterizers K1
// (rasterize_fused_fwd.cu) and K3 (rasterize_bary_fwd.cu): the per-block
// edge cull (`row_may_cover`), the per-pixel test (`consider_row`) and the
// order of winners (`wins`), and K3's one-CTA-per-block z-buffer loop
// (`rasterize_pixel`, which S2's production core reuses). The TPU pair
// shares `_rasterize_chunk_core` (rasterize_pallas.py:265) in the same
// way. K1 runs the same cull and test in a cluster over a group of blocks
// (rasterize_fused_fwd.cu) and must give K3's outputs bit for bit.
//
// What bounds it: tested brute force, every (pixel, triangle) pair costs a
// few tens of fp32 operations. At 256x256, batch 4 and 2,464 triangles that
// is 6.5e8 tests, bound by fp32 issue and latency, not by device-memory
// bytes: the 16-byte triangle data of a test is shared by every pixel of a
// block. Most pairs cannot hit: a triangle of the teapot covers a few of a
// batch image's 256 blocks.
//
// What rasterize_pixel does about it: one thread per pixel keeps its z-buffer
// carry (best z, best id, the winner's three raw edge values) in registers. A
// 16x16 block stages triangle rows into shared memory in slabs of 128 rows (64
// B each) with coalesced 16-byte loads. Then 128 threads test one staged row
// each against the block: a row is dropped when it is dead or when one of its
// edge functions is provably negative at all four corner pixel centres of the
// block, with a margin above the rounding error of evaluating it. Edge
// functions are linear, so such a triangle covers no pixel centre of the block,
// and the cull changes no output bit. The kept rows are compacted in order with
// warp ballots; every thread then runs the per-pixel test on them alone,
// reading each row as broadcast 16-byte loads. The depth divide runs only for
// pixels inside a live triangle. There is no binning prepass and no per-pass
// triangle cap: triangles stream from device memory, so after the cull the
// kernel is bound by the staging (every block reads every row once) and its
// barriers.
//
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
constexpr int kSlabRows = 128;
constexpr int kSlabWarps = kSlabRows / 32;
static_assert(kSlabRows % 32 == 0 && kSlabRows <= kThreads,
              "one culling thread per staged row, in whole warps");

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

// Rasterizes this thread's pixel of a (kBlockX, kBlockY) block at
// (blockIdx.x, blockIdx.y) of batch image blockIdx.z against all
// `num_tris` rows of that image. Every thread of the block must call it:
// it stages rows through shared memory behind block barriers. Threads whose
// pixel lies outside the image take part in staging and culling and return
// the empty carry.
__device__ __forceinline__ Winner rasterize_pixel(
    const float4* __restrict__ tri_rows, int num_tris, int width, int height,
    int row_offset, float scale_x, float scale_y) {
  __shared__ float4 slab[kSlabRows * kRowFloat4s];
  __shared__ int kept_rows[kSlabRows];  // slab rows that pass the cull
  __shared__ int warp_kept[kSlabWarps];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kBlockX;
  const int y0 = blockIdx.y * kBlockY;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const bool in_image = x < width && y < height;

  // Pixel centres in NDC; row 0 is the bottom of the (full) image.
  const float px = pixel_ndc(x, scale_x);
  const float py = pixel_ndc(y + row_offset, scale_y);
  // The block's extreme pixel centres inside the image, for the cull.
  const float px_lo = pixel_ndc(x0, scale_x);
  const float px_hi = pixel_ndc(min(x0 + kBlockX, width) - 1, scale_x);
  const float py_lo = pixel_ndc(y0 + row_offset, scale_y);
  const float py_hi =
      pixel_ndc(min(y0 + kBlockY, height) - 1 + row_offset, scale_y);

  const float4* rows_b =
      tri_rows + static_cast<size_t>(b) * num_tris * kRowFloat4s;

  Winner best{1.0f, -1, 0.0f, 0.0f, 0.0f};

  for (int t0 = 0; t0 < num_tris; t0 += kSlabRows) {
    const int n = min(kSlabRows, num_tris - t0);
    __syncthreads();  // the previous slab has been consumed
    for (int i = tid; i < n * kRowFloat4s; i += kThreads) {
      slab[i] = rows_b[static_cast<size_t>(t0) * kRowFloat4s + i];
    }
    __syncthreads();
    // Cull: thread j < kSlabRows tests staged row j against the block.
    bool keep = false;
    unsigned kept_mask = 0;
    if (tid < kSlabRows) {  // whole warps
      keep = tid < n && row_may_cover(&slab[tid * kRowFloat4s], px_lo,
                                      px_hi, py_lo, py_hi);
      kept_mask = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) warp_kept[warp] = __popc(kept_mask);
    }
    __syncthreads();
    int n_kept = 0;
    int slot = 0;
    for (int w = 0; w < kSlabWarps; ++w) {
      if (w < warp) slot += warp_kept[w];
      n_kept += warp_kept[w];
    }
    if (keep) {
      kept_rows[slot + __popc(kept_mask & ((1u << lane) - 1u))] = tid;
    }
    __syncthreads();
    if (!in_image) continue;
    for (int k = 0; k < n_kept; ++k) {
      const int j = kept_rows[k];
      consider_row(&slab[j * kRowFloat4s], px, py, t0 + j, best);
    }
  }
  return best;
}

}  // namespace
