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
// the per-triangle table, all of a neighbourhood on the same rows. On the
// 256x256 batch-4 teapot only 33,118 of 262,144 pixels are active: 1,219
// of 8,192 warps of 8x4 pixels hold one, with 7,126 distinct (warp,
// winner) pairs (utils/hard_work.py `bwd_counts`).
//
// The body both kernels run (`warp_gradients`, templated on whether
// attributes exist): warps of 8x4 pixels, two to a 64-thread CTA of 8x8
// pixels, and no block barrier.
//   1. Every lane reads its pixel's id and bc; a warp with no active pixel
//      leaves at once (one ballot), before any cotangent load or shuffle.
//   2. The warp sorts its lanes by winner: lanes with one winner group
//      with `__match_any_sync`, a prefix sum over the groups' first lanes
//      places each group, and one exchange through shared memory hands
//      each lane its place's pixel. The active pixels come first, each
//      winner's together, so the runs of a winner that the 8x4 block
//      splits join.
//   3. With attributes, in rounds of kAttrChunk attributes (float4 or
//      float2 loads where A allows, each attribute cotangent loaded once),
//      the warp folds them into g (the fused part), then sums their
//      columns over each run of one winner four attributes at a time
//      (`run_sums`: each step's shuffles of 12 columns issued together,
//      over as many steps as the warp's longest run needs). Then the 9
//      clip columns; the run's first lane adds each sum to the table in
//      device memory: one global atomic per (warp, winner, column). No A
//      is too large: a round holds kAttrChunk cotangents in registers.
//      Without attributes (K4) the rounds and the fused part compile away
//      and the table's stride is 9.
// Why no larger unit: summing per 16x16 tile in shared memory measured
// slower on the H100 (PERF.md). sm_90 has no native shared fp32 add (the
// atomic compiles to a CAS loop), and a tile sort needs block barriers,
// which leave the teapot's 200 busy tiles one or two long CTA chains per
// SM. Likewise a CTA of eight such warps keeps an idle warp's slot until
// its busy neighbours are done; a CTA of two ties it to one at most.
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
#include <cstdint>

namespace {

constexpr float kDegenerateBarycentricCutoff = 0.9f;
constexpr unsigned kFullMask = 0xffffffffu;

// A warp's block of pixels: 8 wide, 4 high; a CTA's, two of them, 8x8.
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
static_assert(kWarpW * kWarpH == 32, "one lane per pixel");
constexpr int kBwdCtaW = kWarpW;
constexpr int kBwdCtaH = 2 * kWarpH;
constexpr int kBwdCtaThreads = kBwdCtaW * kBwdCtaH;
// Attribute cotangents per pixel and round, held in registers: a multiple
// of 4, for float4 loads.
constexpr int kAttrChunk = 12;
// Attributes whose columns one run_sums call sums.
constexpr int kSumAttrs = 4;
static_assert(kAttrChunk % kSumAttrs == 0, "whole groups of attributes");

// Sums each of v[0, n) (n <= N, the same on every lane) over lanes
// [lane, run_end) of the warp: afterwards the first lane of each run holds
// that run's totals. The columns' shuffles of a step are issued together,
// over the steps that runs of up to `span` lanes (a power of two, the same
// on every lane) need. Every lane of the warp must call it. After the step
// with offset o, lane l holds the sum over [l, min(l + 2o, run_end)): lane
// l + o lies in the same run, so its partial sum stops at the same
// run_end.
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

// Loads values [0, n) of `src` into out[0, kN) (the rest 0), `vec` floats
// a load: 4 and 2 need n and the address to be multiples of vec.
template <int kN>
__device__ __forceinline__ void load_chunk(const float* src, int n, int vec,
                                           float (&out)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) out[j] = 0.0f;
  if (vec == 4) {
#pragma unroll
    for (int j = 0; j < kN; j += 4) {
      if (j < n) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src + j));
        out[j] = v.x;
        out[j + 1] = v.y;
        out[j + 2] = v.z;
        out[j + 3] = v.w;
      }
    }
  } else if (vec == 2) {
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      if (j < n) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(src + j));
        out[j] = v.x;
        out[j + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j < n) out[j] = __ldg(src + j);
    }
  }
}

// The body of K2 (kAttrs) and K4 (!kAttrs) for one warp of a
// kBwdCtaThreads CTA: blockIdx.x, blockIdx.y the CTA's 8x8 pixels,
// blockIdx.z the batch image. Without attributes, g_attr and corner are
// not read (they may be null), num_attrs is taken as 0 and dtab is
// [B, T, 9].
template <bool kAttrs>
__device__ __forceinline__ void warp_gradients(
    const int* __restrict__ ids,            // [B, H, W]
    const float* __restrict__ bc,           // [B, H, W, 3]
    const float* __restrict__ g_bc,         // [B, H, W, 3]
    const float* __restrict__ g_attr,       // [B, H, W, A]
    const float4* __restrict__ tri_rows,    // [B, T, 16]
    const float* __restrict__ inv_abs_det,  // [B, T]
    const float* __restrict__ corner,       // [B, T, 3, A]
    float* __restrict__ dtab,               // [B, T, 9 + 3A]
    int num_tris, int num_attrs, int width, int height) {
  __shared__ int lane_at[kBwdCtaThreads / 32][32];  // sorted place -> lane
  if (!kAttrs) num_attrs = 0;

  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // 1. This lane's pixel of the warp's 8x4 block: its winner, or -1 when
  // the pixel is outside the image or inactive.
  const int x = blockIdx.x * kBwdCtaW + lane % kWarpW;
  const int y = blockIdx.y * kBwdCtaH + warp * kWarpH + lane / kWarpW;
  const size_t own_pixel =
      (static_cast<size_t>(b) * height + y) * static_cast<size_t>(width) + x;
  int id = -1;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (x < width && y < height) {
    const int t = ids[own_pixel];
    c0 = bc[own_pixel * 3 + 0];
    c1 = bc[own_pixel * 3 + 1];
    c2 = bc[own_pixel * 3 + 2];
    if (pixel_active(t, c0, c1, c2, num_tris)) id = t;
  }
  const unsigned active = __ballot_sync(kFullMask, id >= 0);
  if (active == 0) return;  // warp-uniform: no active pixel

  // 2. Sort the lanes by winner: groups in the order of their first lanes,
  // the inactive lanes last.
  const unsigned below = (1u << lane) - 1u;
  unsigned peers = 0;
  int leader = lane;
  if (id >= 0) {
    peers = __match_any_sync(active, id);
    leader = __ffs(peers) - 1;
  }
  int start = lane == leader && id >= 0 ? __popc(peers) : 0;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {  // inclusive prefix sum
    const int other = __shfl_up_sync(kFullMask, start, offset);
    if (lane >= offset) start += other;
  }
  const int n_active = __popc(active);
  const int group_start = __shfl_sync(kFullMask, start, leader) -
                          (id >= 0 ? __popc(peers) : 0);
  const int place = id >= 0 ? group_start + __popc(peers & below)
                            : n_active + __popc(~active & below);
  lane_at[warp][place] = lane;
  __syncwarp();
  const int from = lane_at[warp][lane];
  const int my_id = __shfl_sync(kFullMask, id, from);
  const float b0 = __shfl_sync(kFullMask, c0, from);
  const float b1 = __shfl_sync(kFullMask, c1, from);
  const float b2 = __shfl_sync(kFullMask, c2, from);
  const size_t pixel = __shfl_sync(
      kFullMask, static_cast<unsigned long long>(own_pixel), from);

  // Runs of lanes with one winner (the tail's lanes hold -1): only a
  // run's first lane adds its sums, over as many steps as the warp's
  // longest run needs.
  bool head = false;
  const int run_end = run_end_of(my_id, lane, &head);
  const bool writer = head && my_id >= 0;
  const int longest = __reduce_max_sync(kFullMask, head ? run_end - lane : 0);
  int span = 1;
  while (span < longest) span <<= 1;

  // 3. The winner's row, 1/|det| and the bc cotangent, loaded before the
  // attribute rounds so that their latency overlaps.
  const size_t tri =
      static_cast<size_t>(b) * num_tris + (my_id >= 0 ? my_id : 0);
  float4 row[3] = {};
  float inv = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  if (my_id >= 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) row[k] = __ldg(tri_rows + tri * 4 + k);
    inv = __ldg(inv_abs_det + tri);
    g0 = __ldg(g_bc + pixel * 3 + 0);
    g1 = __ldg(g_bc + pixel * 3 + 1);
    g2 = __ldg(g_bc + pixel * 3 + 2);
  }
  float* out = dtab + tri * (9 + 3 * num_attrs);
  const float bk[3] = {b0, b1, b2};
  if constexpr (kAttrs) {
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
    const float* ga = g_attr + pixel * num_attrs;
    const float* ca = corner + tri * 3 * num_attrs;
    // Float4 or float2 loads of the cotangent rows where A and the base
    // address allow (the rounds start at multiples of kAttrChunk).
    const uintptr_t address = reinterpret_cast<uintptr_t>(g_attr);
    const int vec = num_attrs % 4 == 0 && address % 16 == 0 ? 4
                    : num_attrs % 2 == 0 && address % 8 == 0 ? 2 : 1;
    for (int a0 = 0; a0 < num_attrs; a0 += kAttrChunk) {
      const int na = min(kAttrChunk, num_attrs - a0);
      float gv[kAttrChunk];
      if (my_id >= 0) {
        load_chunk(ga + a0, na, vec, gv);
      } else {
#pragma unroll
        for (int j = 0; j < kAttrChunk; ++j) gv[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kAttrChunk; ++j) {
        if (j < na && my_id >= 0) {  // the fused part, in attribute order
          d0 += gv[j] * ca[a0 + j];
          d1 += gv[j] * ca[num_attrs + a0 + j];
          d2 += gv[j] * ca[2 * num_attrs + a0 + j];
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < kAttrChunk; j0 += kSumAttrs) {
        const int n = min(kSumAttrs, na - j0);  // uniform over the grid
        if (n <= 0) break;
        // Column 3 j + k: corner k's attribute a0 + j0 + j.
        float v[3 * kSumAttrs];
#pragma unroll
        for (int j = 0; j < kSumAttrs; ++j) {
#pragma unroll
          for (int k = 0; k < 3; ++k) v[3 * j + k] = bk[k] * gv[j0 + j];
        }
        run_sums(v, 3 * n, lane, run_end, span);
        if (writer) {
#pragma unroll
          for (int j = 0; j < kSumAttrs; ++j) {
            if (j < n) {
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                atomicAdd(out + 9 + k * num_attrs + a0 + j0 + j,
                          v[3 * j + k]);
              }
            }
          }
        }
      }
    }
    g0 += d0;  // the fused part joins the bc cotangent
    g1 += d1;
    g2 += d2;
  }
  // Column c * 3 + k: corner k's clip coordinate c.
  float tc[3] = {0.0f, 0.0f, 0.0f};
  if (my_id >= 0) {
    clip_terms(g0, g1, g2, b0, b1, b2, row, inv, tc);
  }
  float v[9];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[c * 3 + k] = bk[k] * tc[c];
  }
  run_sums(v, 9, lane, run_end, span);
  if (writer) {
#pragma unroll
    for (int i = 0; i < 9; ++i) atomicAdd(out + i, v[i]);
  }
}

}  // namespace
