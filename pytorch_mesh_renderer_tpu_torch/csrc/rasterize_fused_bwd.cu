// Fused analytic backward of the hard rasterizer with attribute
// interpolation, for Hopper.
//
// Replaces the TPU kernel K2 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py `_bwd_kernel_fused`
//   (:1282-1402), launched by `_backward_fused` (:1474).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/rasterize_cuda.py
//   `triangle_gradients_torch` (inside
//   `rasterize_interpolate_backward_torch`).
//
// Output: the per-triangle table [B, T, 9 + 3A], zeroed by the caller.
// Columns c*3 + k hold corner k's coordinate-c clip gradient (c in x, y, w:
// the JAX package's coordinate-major layout), columns 9 + k*A + a corner
// k's attribute-a gradient. The math is rasterize_bwd_common.cuh's, shared
// with the barycentric-only backward K4.
//
// What bounds it: reading ids and bc of every pixel, the cotangents of the
// active ones, and summing 9 + 3A values per active pixel into the table.
// On the 256x256 batch-4 teapot only 33,118 of 262,144 pixels are active:
// 1,494 of 8,192 row-major warps of 32 pixels hold one, with 11,231 runs
// of equal winner, while 1,219 of 8,192 warps of 8x4 pixels hold one, with
// 7,126 distinct winners (utils/hard_work.py `bwd_counts`).
//
// The design: warps of 8x4 pixels, two to a CTA, and no block barrier.
//   1. Every lane reads its pixel's id and bc; a warp with no active pixel
//      leaves at once (one ballot), before any cotangent load or shuffle.
//   2. The warp sorts its lanes by winner: lanes with one winner group
//      with `__match_any_sync`, a prefix sum over the groups' first lanes
//      places each group, and one exchange through shared memory hands
//      each lane its place's pixel. The active pixels come first, each
//      winner's together, so the runs of a winner that the 8x4 block
//      splits join.
//   3. In rounds of kAttrChunk attributes (float4 or float2 loads where A
//      allows, each attribute cotangent loaded once), the warp folds them
//      into g (the fused part), then sums their columns over each run of
//      one winner four attributes at a time (`run_sums`: each step's
//      shuffles of 12 columns issued together, over as many steps as the
//      warp's longest run needs), then the 9 clip columns; the run's
//      first lane adds each sum to the table in device memory. That is
//      one global atomic per (warp, winner, column): 7,126 x 36 at the
//      teapot, against 11,231 x 36 for one per row-major run. No A is too
//      large: a round holds kAttrChunk cotangents in registers.
// Why no larger unit: summing per 16x16 tile in shared memory measured
// slower on the H100 (PERF.md). sm_90 has no native shared fp32 add (the
// atomic compiles to a CAS loop), and a tile sort needs block barriers,
// which leave the teapot's 200 busy tiles one or two long CTA chains per
// SM. Likewise a CTA of eight such warps keeps an idle warp's slot until
// its busy neighbours are done; a CTA of two ties it to one at most.
//
// Rounding: per-pixel values in the plain version's operation order
// (--fmad=false); the atomic order makes the table's last bits vary from
// run to run.

#include <cstdint>

#include "rasterize_bwd_common.cuh"

namespace {

// A warp's block of pixels: 8 wide, 4 high; a CTA's, two of them, 8x8.
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
static_assert(kWarpW * kWarpH == 32, "one lane per pixel");
constexpr int kCtaW = kWarpW;
constexpr int kCtaH = 2 * kWarpH;
constexpr int kCtaThreads = kCtaW * kCtaH;
// Attribute cotangents per pixel and round, held in registers: a multiple
// of 4, for float4 loads.
constexpr int kAttrChunk = 12;
// Attributes whose columns one run_sums call sums.
constexpr int kSumAttrs = 4;
static_assert(kAttrChunk % kSumAttrs == 0, "whole groups of attributes");

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

__global__ void __launch_bounds__(kCtaThreads) rasterize_fused_bwd_kernel(
    const int* __restrict__ ids,            // [B, H, W]
    const float* __restrict__ bc,           // [B, H, W, 3]
    const float* __restrict__ g_bc,         // [B, H, W, 3]
    const float* __restrict__ g_attr,       // [B, H, W, A]
    const float4* __restrict__ tri_rows,    // [B, T, 16]
    const float* __restrict__ inv_abs_det,  // [B, T]
    const float* __restrict__ corner,       // [B, T, 3, A]
    float* __restrict__ dtab,               // [B, T, 9 + 3A]
    int num_tris, int num_attrs, int width, int height) {
  __shared__ int lane_at[kCtaThreads / 32][32];  // sorted place -> lane

  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // 1. This lane's pixel of the warp's 8x4 block: its winner, or -1 when
  // the pixel is outside the image or inactive.
  const int x = blockIdx.x * kCtaW + lane % kWarpW;
  const int y = blockIdx.y * kCtaH + warp * kWarpH + lane / kWarpW;
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
  const float* ga = g_attr + pixel * num_attrs;
  const float* ca = corner + tri * 3 * num_attrs;
  float* out = dtab + tri * (9 + 3 * num_attrs);
  // Float4 or float2 loads of the cotangent rows where A and the base
  // address allow (the rounds start at multiples of kAttrChunk).
  const uintptr_t address = reinterpret_cast<uintptr_t>(g_attr);
  const int vec = num_attrs % 4 == 0 && address % 16 == 0 ? 4
                  : num_attrs % 2 == 0 && address % 8 == 0 ? 2 : 1;
  const float bk[3] = {b0, b1, b2};
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
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
      if (j < na && my_id >= 0) {  // the fused part, in the attributes' order
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
              atomicAdd(out + 9 + k * num_attrs + a0 + j0 + j, v[3 * j + k]);
            }
          }
        }
      }
    }
  }
  // Column c * 3 + k: corner k's clip coordinate c.
  float tc[3] = {0.0f, 0.0f, 0.0f};
  if (my_id >= 0) {
    clip_terms(g0 + d0, g1 + d1, g2 + d2, b0, b1, b2, row, inv, tc);
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

// Launches the kernel on `stream` and returns the launch's CUDA error (0 on
// success). Pointers are device pointers to contiguous tensors; `dtab` is
// zeroed. The caller checks shapes, types and alignment.
extern "C" int rasterize_fused_bwd(const void* ids, const void* bc,
                                   const void* g_bc, const void* g_attr,
                                   const void* tri_rows,
                                   const void* inv_abs_det,
                                   const void* corner, void* dtab, int batch,
                                   int num_tris, int num_attrs, int width,
                                   int height, void* stream) {
  const dim3 grid((width + kCtaW - 1) / kCtaW, (height + kCtaH - 1) / kCtaH,
                  batch);
  rasterize_fused_bwd_kernel<<<grid, kCtaThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(bc),
      static_cast<const float*>(g_bc), static_cast<const float*>(g_attr),
      static_cast<const float4*>(tri_rows),
      static_cast<const float*>(inv_abs_det),
      static_cast<const float*>(corner), static_cast<float*>(dtab),
      num_tris, num_attrs, width, height);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs of rasterize_fused_bwd_kernel per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int rasterize_fused_bwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rasterize_fused_bwd_kernel, kCtaThreads, 0);
  return error == cudaSuccess ? blocks : -static_cast<int>(error);
}
