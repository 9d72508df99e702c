// Device code shared by the four soft (SoftRas) rasterizer kernels:
// K5 soft_sil_fwd.cu, K6 soft_sil_bwd.cu, K7 soft_fwd.cu, K8 soft_bwd.cu.
// The TPU kernels share `_chunk_forward` and `_edge_gradients`
// (soft_rasterize_pallas.py:318-419, 791-832) in the same way.
//
// The packed triangle table is [B, T, 59] f32 with the column layout of
// `_pack_triangle_data` (soft_rasterize_pallas.py:133-213): 0-8 the
// normalized 2D inverse (screen barycentric rows), 9-14 NDC corner xy,
// 15-17 NDC z, 18-20 clip w, 21 keep, 22-25 the blur-inflated NDC bbox,
// 26-34 world xyz, 35-43 normals, 44-52 diffuse rgb, 53-55 1/w, 56-58
// 1/|edge|^2. Params are 4 f32 in device memory: sigma, gamma, blur^2 and
// the row offset (the twin of `_make_params`, :1265), so sigma and gamma
// never cross to the host.
//
// What bounds the kernels: every (pixel, triangle) pair inside a
// triangle's blur-inflated bbox costs a few hundred fp32 operations
// (~215 + 23 L forward, ~645 + 63 L backward; L lights). At the sizes the
// renderers use a pixel meets about one such bbox (0.97 pairs per pixel on
// the 256x256 teapot), so by the card's peak rates the least time is that
// of the bytes: 24-40 bytes of per-pixel images read and written, and the
// [B, T, 59] tables. The triangle rows (236 bytes each) are read by every
// block that keeps them and stay in L2. What the measured times follow is
// neither: it is the chain of dependent work on the few busy blocks (on
// the 256x256 batch-4 teapot 208 of 1,024 pixel blocks hold a valid pair,
// the busiest 191 triangles), and how many of those chains the card runs
// at once.
//
// What the design does about it. Every kernel works on 16x16 pixel blocks
// and culls a block's triangle rows with one test (`block_keeps`: keep,
// and the bbox of cols 22-25 against the block's pixel-centre extent),
// compacting the kept rows in index order with warp ballots (`cull_rows`;
// `stage_rows` also copies them to shared memory). The per-pixel bbox test
// uses the same px, py and comparisons, so a culled triangle is one that
// no pixel of the block would have found valid, and an invalid pair is an
// exact no-op of the per-triangle updates (coverage 0 multiplies the
// silhouette by exactly 1.0; the softmax state is left as it is). The cull
// changes no output bit. There is no binning prepass and no per-pass
// triangle cap: rows stream from device memory.
//
// - K6 and K8 (soft_sil_bwd.cu, soft_bwd.cu; the split in soft_split.cuh):
//   kSplit CTAs per block, CTA s staging only the rows t = s (mod kSplit),
//   256 rows a pass; inside a CTA the (staged triangle, 16x2 row pair its
//   bbox touches) items are cut into one equal run per warp, one pixel per
//   lane, and each triangle's column sums are reduced over the warp once.
//   A busy block's work so spreads over kSplit x 8 warps instead of
//   queueing on 8. K8 adds its sums with atomics, in no order; K6 writes
//   one partial per (image, kept row, block) and adds them in block order
//   in a second pass, which finds them with the same `block_keeps` at
//   `block_extent_at`, so its gradients repeat bit for bit.
// - K7 and K5 (soft_fwd.cu, soft_sil_fwd.cu; one body in
//   soft_cluster_fwd.cuh, with and without shading): the fold of each
//   pixel is ordered (the online softmax, and K5's alpha bit-identical to
//   K7's), so a thread-block cluster of kSplit CTAs splits the evaluation
//   of the pairs and each pixel's owner folds the records the cluster
//   wrote, in index order, through distributed shared memory. A busy block
//   holds kSplit CTA slots for all its rounds, so the split pays where the
//   busy blocks times kSplit about fit the card's CTA slots.
//
// Lights are read from device memory through the read-only cache; no
// kernel caps their count.
//
// Rounding: build with --fmad=false; every expression keeps the operation
// order of the plain PyTorch version (ops/soft_rasterize_cuda.py) and of
// the Pallas kernels. Pixel centres are px = 2 (col + 0.5) / W - 1 and
// py = -2 (row + row_off + 0.5) / full_height + 1 with IEEE divisions, as
// the plain version computes them in numpy float32.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kSoftBlockX = 16;
constexpr int kSoftBlockY = 16;
constexpr int kSoftThreads = kSoftBlockX * kSoftBlockY;
constexpr int kCols = 59;
constexpr float kEps = 1e-10f;  // background floor, soft_rasterize.py:40
constexpr unsigned kFullMask = 0xffffffffu;

struct SoftParams {
  float sigma, gamma, sq_blur, row_off;
};

__device__ __forceinline__ SoftParams load_params(const float* params) {
  return SoftParams{params[0], params[1], params[2], params[3]};
}

__device__ __forceinline__ float pixel_x(int x, int width) {
  return 2.0f * (static_cast<float>(x) + 0.5f) / static_cast<float>(width) -
         1.0f;
}

__device__ __forceinline__ float pixel_y(int y, float row_off,
                                         int full_height) {
  return -2.0f * ((static_cast<float>(y) + row_off) + 0.5f) /
             static_cast<float>(full_height) +
         1.0f;
}

// The pixel-centre extent of a pixel block, clipped to the image.
struct BlockExtent {
  float px_lo, px_hi, py_lo, py_hi;
};

// Pixel block (bx, by)'s.
__device__ __forceinline__ BlockExtent block_extent_at(int bx, int by,
                                                       int width, int height,
                                                       float row_off,
                                                       int full_height) {
  const int x0 = bx * kSoftBlockX;
  const int y0 = by * kSoftBlockY;
  // py falls as the row grows: the top row has the largest py.
  return BlockExtent{
      pixel_x(x0, width), pixel_x(min(x0 + kSoftBlockX, width) - 1, width),
      pixel_y(min(y0 + kSoftBlockY, height) - 1, row_off, full_height),
      pixel_y(y0, row_off, full_height)};
}

// This thread's block's.
__device__ __forceinline__ BlockExtent block_extent(int width, int height,
                                                    float row_off,
                                                    int full_height) {
  return block_extent_at(blockIdx.x, blockIdx.y, width, height, row_off,
                         full_height);
}

// Whether table row r can hold a valid pair for a pixel of the block: it
// is kept and its blur-inflated bbox meets the block's pixel-centre extent.
// The per-pixel bbox test of soft_geometry uses the same comparisons, so a
// row this rejects is one that no pixel of the block finds valid.
__device__ __forceinline__ bool block_keeps(const float* r,
                                            const BlockExtent& e) {
  const float keep = r[21];  // all five loads in flight at once
  const float x_lo = r[22], x_hi = r[23], y_lo = r[24], y_hi = r[25];
  return keep > 0.0f && x_hi >= e.px_lo && x_lo <= e.px_hi &&
         y_hi >= e.py_lo && y_lo <= e.py_hi;
}

// Tests rows t0 + i stride for i < n (n <= kPerThread x kRows; thread
// tid tests i = h kRows + tid for h < kPerThread) of one image's table
// against the block and writes the kept ones' offsets i stride from t0, in
// index order, to kept_ids (kPerThread x kRows); warp_kept holds
// kPerThread x kRows / 32 counts. Returns the kept rows' count. Every
// thread of the block must call it; it starts and ends with a block
// barrier.
template <int kRows, int kPerThread = 1>
__device__ __forceinline__ int cull_rows(const float* __restrict__ rows_b,
                                         int t0, int n, int stride,
                                         const BlockExtent& e, int* kept_ids,
                                         int* warp_kept) {
  static_assert(kRows % 32 == 0 && kRows <= kSoftThreads,
                "one culling thread per tested row, in whole warps");
  constexpr int kWarpsCulling = kRows / 32;
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  __syncthreads();  // the previous pass's kept rows have been consumed
  bool keep[kPerThread];
  unsigned kept_mask[kPerThread];
#pragma unroll
  for (int h = 0; h < kPerThread; ++h) {
    const int i = h * kRows + tid;
    const float* r = rows_b + static_cast<size_t>(t0 + i * stride) * kCols;
    keep[h] = tid < kRows && i < n && block_keeps(r, e);
  }
  if (tid < kRows) {  // whole warps
#pragma unroll
    for (int h = 0; h < kPerThread; ++h) {
      kept_mask[h] = __ballot_sync(kFullMask, keep[h]);
      if (lane == 0) {
        warp_kept[h * kWarpsCulling + warp] = __popc(kept_mask[h]);
      }
    }
  }
  __syncthreads();
  int n_kept = 0;
  int slot[kPerThread] = {};
  for (int w = 0; w < kPerThread * kWarpsCulling; ++w) {
#pragma unroll
    for (int h = 0; h < kPerThread; ++h) {
      if (w < h * kWarpsCulling + warp) slot[h] += warp_kept[w];
    }
    n_kept += warp_kept[w];
  }
#pragma unroll
  for (int h = 0; h < kPerThread; ++h) {
    if (keep[h]) {
      kept_ids[slot[h] + __popc(kept_mask[h] & ((1u << lane) - 1u))] =
          (h * kRows + tid) * stride;
    }
  }
  __syncthreads();
  return n_kept;
}

// cull_rows, then copies the kept rows, in index order, to `slab`
// (kRows x kCols). Returns the kept rows' count; ends with a block
// barrier.
template <int kRows>
__device__ __forceinline__ int stage_rows(const float* __restrict__ rows_b,
                                          int t0, int n, int stride,
                                          const BlockExtent& e, float* slab,
                                          int* kept_ids, int* warp_kept) {
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int n_kept =
      cull_rows<kRows>(rows_b, t0, n, stride, e, kept_ids, warp_kept);
  for (int i = tid; i < n_kept * kCols; i += kSoftThreads) {
    const int k = i / kCols;
    slab[i] = rows_b[static_cast<size_t>(t0 + kept_ids[k]) * kCols +
                     (i - k * kCols)];
  }
  __syncthreads();
  return n_kept;
}

// The derivative of clip(x, 0, 1) as `jnp.clip` takes it (and
// `math_utils.clip`): 1 strictly inside (0, 1), 1/2 at exactly 0 or 1
// (lax.max and lax.min split a tie evenly), 0 outside.
__device__ __forceinline__ float clip01_grad(float x) {
  if (x > 0.0f && x < 1.0f) return 1.0f;
  return x == 0.0f || x == 1.0f ? 0.5f : 0.0f;
}

// Squared distance from (px, py) to segment [a, b], the clipped offset t
// of the nearest point (`_segment_sq_dist`, :216-231) and the derivative
// of the clip at the unclipped offset (`clip01_grad`).
__device__ __forceinline__ float segment_sq_dist(float px, float py,
                                                 float ax, float ay,
                                                 float bx, float by,
                                                 float inv_len2, float* t,
                                                 float* dt_clip) {
  const float abx = bx - ax;
  const float aby = by - ay;
  float tt = ((px - ax) * abx + (py - ay) * aby) * inv_len2;
  *dt_clip = clip01_grad(tt);
  tt = fminf(fmaxf(tt, 0.0f), 1.0f);
  const float nx = ax + tt * abx - px;
  const float ny = ay + tt * aby - py;
  *t = tt;
  return nx * nx + ny * ny;
}

// The geometry phase of one (pixel, triangle) pair: `_chunk_forward` up to
// the coverage (:335-375, 413-415). When `valid` is false the other fields
// are unspecified; the callers skip the pair.
struct SoftGeometry {
  bool valid;
  bool inside;
  float bc[3];  // screen barycentrics
  float cb[3];  // chosen barycentrics: bc inside, the nearest edge's outside
  float t01, t12, t20;
  float dt_clip[3];  // clip01_grad of each edge's unclipped offset
  int pick;  // nearest edge: 0 for v0v1, 1 for v1v2, 2 for v2v0
  // Bit e set where edge e's distance equals sq_dist: two or three bits at
  // an exact tie, among which the backward splits sq_dist's cotangent
  // evenly (the derivative of jnp.min and torch.amin).
  unsigned nearest;
  float sq_dist;
  float ow[3];  // cb / w
  float inv_denom;
  float sb[3];  // perspective-correct, L1-normalized
  float z;
  float sgn;
  float cov_raw;   // sigmoid(sgn * sq_dist / sigma)
  float coverage;  // cov_raw of a valid pair
};

__device__ __forceinline__ SoftGeometry soft_geometry(const float* r,
                                                      float px, float py,
                                                      float sigma,
                                                      float sq_blur) {
  SoftGeometry g;
  g.valid = false;
  const bool in_bbox = px >= r[22] && px <= r[23] && py >= r[24] &&
                       py <= r[25];
  if (!(r[21] > 0.0f && in_bbox)) return g;
  g.bc[0] = r[0] * px + r[1] * py + r[2];
  g.bc[1] = r[3] * px + r[4] * py + r[5];
  g.bc[2] = r[6] * px + r[7] * py + r[8];
  g.inside = g.bc[0] >= 0.0f && g.bc[1] >= 0.0f && g.bc[2] >= 0.0f;
  const float d01 = segment_sq_dist(px, py, r[9], r[10], r[11], r[12],
                                    r[56], &g.t01,
                                    &g.dt_clip[0]);
  const float d12 = segment_sq_dist(px, py, r[11], r[12], r[13], r[14],
                                    r[57], &g.t12,
                                    &g.dt_clip[1]);
  const float d20 = segment_sq_dist(px, py, r[13], r[14], r[9], r[10],
                                    r[58], &g.t20,
                                    &g.dt_clip[2]);
  const bool p01 = d01 <= d12 && d01 <= d20;
  const bool p12 = !p01 && d12 <= d20;
  g.pick = p01 ? 0 : (p12 ? 1 : 2);
  g.sq_dist = p01 ? d01 : (p12 ? d12 : d20);
  g.nearest = (d01 == g.sq_dist ? 1u : 0u) | (d12 == g.sq_dist ? 2u : 0u) |
              (d20 == g.sq_dist ? 4u : 0u);
  if (!(g.inside || g.sq_dist <= sq_blur)) return g;
  const float eb0 = p01 ? 1.0f - g.t01 : (p12 ? 0.0f : g.t20);
  const float eb1 = p01 ? g.t01 : (p12 ? 1.0f - g.t12 : 0.0f);
  const float eb2 = p01 ? 0.0f : (p12 ? g.t12 : 1.0f - g.t20);
  g.cb[0] = g.inside ? g.bc[0] : eb0;
  g.cb[1] = g.inside ? g.bc[1] : eb1;
  g.cb[2] = g.inside ? g.bc[2] : eb2;
  g.ow[0] = g.cb[0] * r[53];
  g.ow[1] = g.cb[1] * r[54];
  g.ow[2] = g.cb[2] * r[55];
  const float denom = fabsf(g.ow[0]) + fabsf(g.ow[1]) + fabsf(g.ow[2]);
  g.inv_denom = 1.0f / fmaxf(denom, 1e-12f);
  g.sb[0] = g.ow[0] * g.inv_denom;
  g.sb[1] = g.ow[1] * g.inv_denom;
  g.sb[2] = g.ow[2] * g.inv_denom;
  const float z_ndc = g.sb[0] * r[15] + g.sb[1] * r[16] + g.sb[2] * r[17];
  g.z = 0.5f - z_ndc * 0.5f;
  if (!(g.z >= 0.0f && g.z <= 1.0f)) return g;
  g.valid = true;
  g.sgn = g.inside ? 1.0f : -1.0f;
  g.cov_raw = 1.0f / (1.0f + expf(-(g.sgn * g.sq_dist / sigma)));
  g.coverage = g.cov_raw;
  return g;
}

// Phong diffuse shading of a valid pair (:378-410): the interpolated world
// point, unit normal and colour, and the summed light term. `lights` points
// to one image's lights in device memory.
struct SoftShade {
  float p3x, p3y, p3z;
  float nx, ny, nz;
  float n_inv;
  float cr, cg, cb;
  float light_sum;
};

__device__ __forceinline__ SoftShade soft_shade(const float* r,
                                                const SoftGeometry& g,
                                                const float4* lights,
                                                int num_lights) {
  SoftShade s;
  const float s0 = g.sb[0], s1 = g.sb[1], s2 = g.sb[2];
  s.p3x = s0 * r[26] + s1 * r[29] + s2 * r[32];
  s.p3y = s0 * r[27] + s1 * r[30] + s2 * r[33];
  s.p3z = s0 * r[28] + s1 * r[31] + s2 * r[34];
  const float ux = s0 * r[35] + s1 * r[38] + s2 * r[41];
  const float uy = s0 * r[36] + s1 * r[39] + s2 * r[42];
  const float uz = s0 * r[37] + s1 * r[40] + s2 * r[43];
  const float u_norm = sqrtf(ux * ux + uy * uy + uz * uz);
  s.n_inv = 1.0f / fmaxf(u_norm, 1e-12f);
  s.nx = ux * s.n_inv;
  s.ny = uy * s.n_inv;
  s.nz = uz * s.n_inv;
  s.cr = s0 * r[44] + s1 * r[47] + s2 * r[50];
  s.cg = s0 * r[45] + s1 * r[48] + s2 * r[51];
  s.cb = s0 * r[46] + s1 * r[49] + s2 * r[52];
  float light_sum = 0.0f;
  for (int l = 0; l < num_lights; ++l) {
    const float4 lt = __ldg(lights + l);
    const float dx = lt.x - s.p3x;
    const float dy = lt.y - s.p3y;
    const float dz = lt.z - s.p3z;
    const float d_norm = sqrtf(dx * dx + dy * dy + dz * dz);
    const float d_inv = 1.0f / fmaxf(d_norm, 1e-12f);
    const float ct = (dx * s.nx + dy * s.ny + dz * s.nz) * d_inv;
    const float ndl = fminf(fmaxf(ct, 0.0f), 1.0f);
    light_sum = light_sum + ndl * lt.w;
  }
  s.light_sum = light_sum;
  return s;
}

// Sum over the warp; every lane gets the total. Every lane must call it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

// Edge-endpoint gradients into the per-lane table-gradient row `v`
// (cols 9-14; `_edge_gradients`, :791-832): per edge, the offset-t chain
// `dt` (kWithT only; the silhouette backward has none) and the
// squared-distance chain of the nearest edge, split evenly among the edges
// of an exact tie (`g.nearest`; the envelope theorem: t is constant at the
// interior optimum).
template <bool kWithT>
__device__ __forceinline__ void edge_gradients(const float* r,
                                               const SoftGeometry& g,
                                               float px, float py, float dsq,
                                               const float* dts, float* v) {
  const int cols[3][5] = {{9, 10, 11, 12, 56}, {11, 12, 13, 14, 57},
                          {13, 14, 9, 10, 58}};
  const float ts[3] = {g.t01, g.t12, g.t20};
  const int n_nearest = __popc(g.nearest);
  const float dsq_share =
      n_nearest > 1 ? dsq / static_cast<float>(n_nearest) : dsq;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float ax = r[cols[e][0]], ay = r[cols[e][1]];
    const float bx = r[cols[e][2]], by = r[cols[e][3]];
    const float t = ts[e];
    const float abx = bx - ax;
    const float aby = by - ay;
    float da_x = 0.0f, da_y = 0.0f, db_x = 0.0f, db_y = 0.0f;
    if constexpr (kWithT) {
      const float qx = px - ax;
      const float qy = py - ay;
      const float dtg = g.dt_clip[e] * dts[e];
      const float inv_len2 = r[cols[e][4]];
      da_x = dtg * (-abx - qx + 2.0f * t * abx) * inv_len2;
      da_y = dtg * (-aby - qy + 2.0f * t * aby) * inv_len2;
      db_x = dtg * (qx - 2.0f * t * abx) * inv_len2;
      db_y = dtg * (qy - 2.0f * t * aby) * inv_len2;
    }
    const float dsqp = (g.nearest >> e) & 1u ? dsq_share : 0.0f;
    const float rx = ax + t * abx - px;
    const float ry = ay + t * aby - py;
    v[cols[e][0]] += da_x + dsqp * 2.0f * rx * (1.0f - t);
    v[cols[e][1]] += da_y + dsqp * 2.0f * ry * (1.0f - t);
    v[cols[e][2]] += db_x + dsqp * 2.0f * rx * t;
    v[cols[e][3]] += db_y + dsqp * 2.0f * ry * t;
  }
}

}  // namespace
