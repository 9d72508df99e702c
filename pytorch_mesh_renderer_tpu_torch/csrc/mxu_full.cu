// The full per-visit pipeline microbenchmark: the production rasterizer
// core vs a tensor-core core, for Hopper.
//
// Replaces the Pallas kernels of scripts/mxu_full_microbench.py (S2):
// `kernel_prod` (:85) by mxu_full_prod_kernel and `kernel_mxu` (:113) by
// mxu_full_tc_kernel. The plain PyTorch versions they are held against
// are pytorch_mesh_renderer_tpu_torch/microbench/mxu_full.py
// `zbuffer_prod_torch` and `zbuffer_tc_torch`.
//
// The function: the z-buffer of one 16x128 tile (pixel pitch of a 512x512
// image) over `visits` visits of C synthetic triangles with positional ids:
// per pixel the smallest valid z, ties to the larger id, and the winner's
// raw edge values; z = 2, id = -1 and zeros where no triangle is valid.
//
// What bounds it: fp32 instruction throughput (tc: tensor-core TF32), ~18
// operations for every (triangle, pixel) pair a cull must keep (each
// triangle's box of covered pixels, microbench/mxu_full.py `pair_counts`:
// a small part of the 8.4e6 pairs at 512 visits of 8) and ~16 more for the
// pairs inside a triangle, against 0.26 MB (prod) or 0.66 MB (tc) of
// input.
//
// What the design does about it. As in mxu_edge.cu, 2,048 pixels fill 8
// SMs, so both variants split the visits over `splits` blocks per 16x16
// pixel block (grid 8 x 1 x splits); each block writes its partial winner
// per pixel, and one shared second pass picks the winner over the splits
// (smallest z, ties to the larger id: the merge is order-free, so the
// result is the single pass's bit for bit). The variants differ in how
// the five values of a pair are made:
//   * prod: `rasterize_pixel` of rasterize_common.cuh unchanged (one CTA
//     per block, staged rows and a per-block cull: the per-block core that
//     K1 and K3 ran before they took the cluster body of
//     rasterize_cluster_fwd.cuh), the
//     split's rows passed as its batch image blockIdx.z; the epilogue makes
//     its ids global and maps an empty pixel to z = 2;
//   * tc: 3xTF32 `mma.sync` m16n8k8 products of the edge-major table
//     (rows f * C + triangle, K 3 -> 8 zero-padded) on compacted groups
//     of 8 triangles. Per CTA (a 16x16 pixel block and its split of the
//     visits), in stages of kStageTris triangles:
//       1. Stage: the threads copy the stage's 5 function rows of every
//          triangle (their first 16 bytes: the three coefficients and a
//          pad) into shared memory with `cp.async`, and each thread splits
//          the values it copied into TF32 hi and lo, once per CTA, into
//          shared memory. One __syncthreads follows (two from the second
//          stage on: more than kStageTris triangles per split, which the
//          script's 512 visits of 8 do not reach).
//       2. Cull: each warp covers two rows of the block's 16x16 pixels;
//          each lane takes a triangle and drops it for the warp's 2x16
//          region when one edge is below -margin at all four corner pixel
//          centres (an affine function is largest at a corner; margin =
//          kCullMargin x (|a| max|x| + |b| max|y| + |c|), far above the
//          ~1e-7 relative rounding of fp32 and of the 3xTF32 products,
//          so no pair the plain version counts inside is dropped:
//          microbench/mxu_full.py `tc_keeps` is its plain model). A ballot
//          and a prefix sum compact the survivors in shared memory.
//       3. Products: the survivors in groups of 8, the last padded with a
//          dead triangle (all-zero functions, whose pairs fail the inside
//          test). The pixel centres are TF32-exact (the kernel's pixel scale
//          is the constant kTcPixelScale; the launcher refuses any other),
//          so B's lo parts are zero and each
//          3xTF32 product takes two mma.sync (lo*hi, hi*hi) with the same
//          sum. Three m16 tiles hold the group's e0/e1, e2/num and
//          den/padding rows, so lane = 4g + q receives all five values of
//          triangle g for pixels 2q and 2q + 1 of each n8 tile. Each
//          thread then runs the inside test, depth and carry merge on its
//          pairs into a per-thread carry (8 pixels: 4 tiles x 2 columns).
//     After the last stage a shuffle tree over the 8 triangle slots
//     (lanes 4 apart) merges the carries: the per-visit min-z / max-id
//     reduction of the Pallas kernel, deferred because the merge is
//     order-free. Like the Pallas kernel, tc skips the live-column test.
//     Without the cull it ran every (triangle, pixel) pair through the
//     products; at 512 visits of 8 the cull keeps 12.9% of them and its
//     groups of 8 run 15.6% (`tc_cull_counts`).

#include "mma_common.cuh"
#include "rasterize_common.cuh"

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kFullTileW = 128;
constexpr int kFullTileH = 16;
constexpr int kFullPix = kFullTileW * kFullTileH;
constexpr float kEmptyZ = 2.0f;

struct Carry {
  float z;
  int id;
  float w0, w1, w2;
};

// Smallest z wins, ties to the larger id (id -1 never wins a tie).
__device__ __forceinline__ bool better(float z, int id, const Carry& c) {
  return z < c.z || (z == c.z && id > c.id);
}

__device__ __forceinline__ void store_partial(
    const Carry& c, int split, int p, float* part_z, int* part_id,
    float* part_w) {
  const size_t i = static_cast<size_t>(split) * kFullPix + p;
  part_z[i] = c.z;
  part_id[i] = c.id;
  const size_t w = static_cast<size_t>(split) * 3 * kFullPix + p;
  part_w[w] = c.w0;
  part_w[w + kFullPix] = c.w1;
  part_w[w + 2 * kFullPix] = c.w2;
}

__global__ void __launch_bounds__(kThreads) mxu_full_prod_kernel(
    const float4* __restrict__ rows,  // [visits * C, 16]
    float* __restrict__ part_z, int* __restrict__ part_id,
    float* __restrict__ part_w,  // [splits, 2048], [splits, 3, 2048]
    int rows_per_split, float scale) {
  // Split blockIdx.z's rows are rasterize_pixel's batch image blockIdx.z.
  const Winner best = rasterize_pixel(rows, rows_per_split, kFullTileW,
                                      kFullTileH, 0, scale, scale);
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int split = blockIdx.z;
  const bool covered = best.id >= 0;
  const Carry c{covered ? best.z : kEmptyZ,
                covered ? split * rows_per_split + best.id : -1, best.we0,
                best.we1, best.we2};
  store_partial(c, split, y * kFullTileW + x, part_z, part_id, part_w);
}

// Triangles a tc CTA stages in shared memory at once, and their five
// affine functions (e0, e1, e2, num, den).
constexpr int kStageTris = 128;
constexpr int kFuncs = 5;
// The tc cull keeps a triangle for a warp's region unless one edge is below
// -kCullMargin x (|a| max|x| + |b| max|y| + |c|) at all four corners.
constexpr float kCullMargin = 1e-5f;

// Asynchronous 16-byte copy from device to shared memory (cp.async, which
// bypasses the registers); cp_async_wait makes this thread's copies
// complete and visible to it.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned address =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(address),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The tc kernel's pixel scale, the scripts' 2/512. Pixel centre i is then
// (2i + 1 - 512) / 512: an odd integer of at most 9 bits over a power of
// two, which TF32's 11 significant bits hold exactly (the tile's rows are a
// subset of its 128 columns' indices). So B's lo parts are zero, the hi*lo
// product of each 3xTF32 product is exactly zero and two mma.sync make it.
constexpr float kTcPixelScale = 2.0f / 512.0f;
static_assert(kTcPixelScale == 1.0f / 256.0f && kFullTileW <= 512,
              "tc pixel centres must be TF32-exact");

__global__ void __launch_bounds__(kThreads) mxu_full_tc_kernel(
    const float* __restrict__ coeff,  // [visits * 5C, 8], edge-major rows
    float* __restrict__ part_z, int* __restrict__ part_id,
    float* __restrict__ part_w, int chunk, int per_split) {
  constexpr float scale = kTcPixelScale;
  constexpr int kTiles = 4;  // n8 tiles per warp: 2 rows x 2 halves
  constexpr int kRowCols = 8;
  constexpr int kWarps = kThreads / 32;
  // Function f of stage triangle t at [f * kStageTris + t]: the fp32 row
  // (a, b, c, pad) and its TF32 hi and lo parts (pad 0).
  __shared__ float4 raw[kFuncs * kStageTris];
  __shared__ uint4 a_hi_s[kFuncs * kStageTris];
  __shared__ uint4 a_lo_s[kFuncs * kStageTris];
  __shared__ unsigned char kept[kWarps][kStageTris];  // compacted survivors
  static_assert(kStageTris <= 256, "stage triangles fit in a byte");

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int x0 = blockIdx.x * kBlockX;

  // This split's triangles, by global (positional) id v * C + c.
  const int split_tris = per_split * chunk;
  const int first = blockIdx.z * split_tris;
  // 1. Stage: thread i copies (and later splits) function i / n of stage
  // triangle i % n. The first stage's copies fly while the fragments
  // below are set up.
  auto stage = [&](int s0, int n) {
    for (int i = threadIdx.x; i < kFuncs * n; i += kThreads) {
      const int f = i / n;
      const int tri = first + s0 + (i - f * n);
      const int v = tri / chunk;
      const size_t row = static_cast<size_t>(v) * kFuncs * chunk +
                         f * chunk + (tri - v * chunk);
      cp_async16(&raw[f * kStageTris + i - f * n], coeff + row * kRowCols);
    }
  };
  stage(0, min(kStageTris, split_tris));

  // B fragments: b0 = (x, y, 1, 0)[q] of pixel g of each tile, b1 = 0
  // (K 4-7); their lo parts are 0.
  uint32_t b_hi[kTiles][2];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int row = 2 * warp + t / 2;
    const int col = x0 + 8 * (t % 2) + g;
    const float b = q == 0   ? pixel_ndc(col, scale)
                    : q == 1 ? pixel_ndc(row, scale)
                    : q == 2 ? 1.0f
                             : 0.0f;
    b_hi[t][0] = split_tf32(b).hi;
    b_hi[t][1] = 0u;
  }

  Carry carry[kTiles][2];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      carry[t][c] = Carry{kEmptyZ, -1, 0.0f, 0.0f, 0.0f};
    }
  }

  // The warp's region for the cull: columns x0..x0+15 of rows 2 warp and
  // 2 warp + 1.
  const float x_lo = pixel_ndc(x0, scale);
  const float x_hi = pixel_ndc(x0 + kBlockX - 1, scale);
  const float y_lo = pixel_ndc(2 * warp, scale);
  const float y_hi = pixel_ndc(2 * warp + 1, scale);
  const float x_max = fmaxf(1.0f, fmaxf(fabsf(x_lo), fabsf(x_hi)));
  const float y_max = fmaxf(1.0f, fmaxf(fabsf(y_lo), fabsf(y_hi)));

  for (int s0 = 0; s0 < split_tris; s0 += kStageTris) {
    const int n = min(kStageTris, split_tris - s0);
    if (s0 > 0) {
      __syncthreads();  // the previous stage's readers are done
      stage(s0, n);
    }
    cp_async_wait();
    // Split what this thread copied: its copies are complete and visible
    // to it after cp_async_wait.
    for (int i = threadIdx.x; i < kFuncs * n; i += kThreads) {
      const int f = i / n;
      const int at = f * kStageTris + i - f * n;
      const float4 r = raw[at];
      const Tf32Split a = split_tf32(r.x), b = split_tf32(r.y),
                      c = split_tf32(r.z);
      a_hi_s[at] = make_uint4(a.hi, b.hi, c.hi, 0u);
      a_lo_s[at] = make_uint4(a.lo, b.lo, c.lo, 0u);
    }
    __syncthreads();

    // 2. Cull for this warp's region, and compact the survivors.
    int n_kept = 0;
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int t = t0 + lane;
      bool keep = t < n;
      if (keep) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float4 r = raw[e * kStageTris + t];
          const float top =
              fmaxf(fmaxf(r.x * x_lo + r.y * y_lo + r.z,
                          r.x * x_hi + r.y * y_lo + r.z),
                    fmaxf(r.x * x_lo + r.y * y_hi + r.z,
                          r.x * x_hi + r.y * y_hi + r.z));
          const float margin =
              kCullMargin *
              (fabsf(r.x) * x_max + fabsf(r.y) * y_max + fabsf(r.z));
          if (top < -margin) keep = false;
        }
      }
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) kept[warp][n_kept + __popc(mask & ((1u << lane) - 1u))] = t;
      n_kept += __popc(mask);
    }
    __syncwarp();

    // 3. The survivors in groups of 8, padded with a dead triangle.
    for (int k0 = 0; k0 < n_kept; k0 += 8) {
      const bool live = k0 + g < n_kept;
      const int t = live ? kept[warp][k0 + g] : 0;
      // m-tile mt holds functions 2 mt (rows 0-7) and 2 mt + 1 (rows
      // 8-15) of the group; function 5 is padding. Column q (q = 3 pad).
      uint32_t a_hi[3][4], a_lo[3][4];
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 2 * mt + h;
          uint32_t hi = 0u, lo = 0u;
          if (f < kFuncs && live) {
            hi = reinterpret_cast<const uint32_t*>(
                &a_hi_s[f * kStageTris + t])[q];
            lo = reinterpret_cast<const uint32_t*>(
                &a_lo_s[f * kStageTris + t])[q];
          }
          a_hi[mt][h] = hi;
          a_lo[mt][h] = lo;
          a_hi[mt][h + 2] = a_lo[mt][h + 2] = 0u;  // K 4-7
        }
      }
      const int id = first + s0 + t;
#pragma unroll
      for (int tile = 0; tile < kTiles; ++tile) {
        float d[3][4];
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) {
          mma_tf32x3_exact_b(d[mt], a_hi[mt], a_lo[mt], b_hi[tile]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e0 = d[0][c], e1 = d[0][2 + c];
          const float e2 = d[1][c], num = d[1][2 + c], den = d[2][c];
          const float min_e = fminf(fminf(e0, e1), e2);
          const float max_e = fmaxf(fmaxf(e0, e1), e2);
          if (!(min_e >= 0.0f && max_e > 0.0f)) continue;
          const float z = num / (den != 0.0f ? den : 1.0f);
          if (z >= -1.0f && z <= 1.0f && better(z, id, carry[tile][c])) {
            carry[tile][c] = Carry{z, id, e0, e1, e2};
          }
        }
      }
    }
  }

  // Merge the 8 triangle slots' carries (lanes 4 apart); lanes 0-3 store.
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      Carry& mine = carry[t][c];
      for (int offset = 4; offset < 32; offset *= 2) {
        const Carry other{__shfl_xor_sync(0xffffffffu, mine.z, offset),
                          __shfl_xor_sync(0xffffffffu, mine.id, offset),
                          __shfl_xor_sync(0xffffffffu, mine.w0, offset),
                          __shfl_xor_sync(0xffffffffu, mine.w1, offset),
                          __shfl_xor_sync(0xffffffffu, mine.w2, offset)};
        if (better(other.z, other.id, mine)) mine = other;
      }
      if (g == 0) {
        const int p = (2 * warp + t / 2) * kFullTileW + x0 + 8 * (t % 2) +
                      2 * q + c;
        store_partial(mine, blockIdx.z, p, part_z, part_id, part_w);
      }
    }
  }
}

// The winner over the splits' partial carries, per pixel.
__global__ void __launch_bounds__(kThreads) mxu_full_merge_kernel(
    const float* __restrict__ part_z, const int* __restrict__ part_id,
    const float* __restrict__ part_w, float* __restrict__ z,
    int* __restrict__ id, float* __restrict__ w, int splits) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  Carry best{kEmptyZ, -1, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < splits; ++j) {
    const size_t i = static_cast<size_t>(j) * kFullPix + p;
    if (better(part_z[i], part_id[i], best)) {
      const size_t k = static_cast<size_t>(j) * 3 * kFullPix + p;
      best = Carry{part_z[i], part_id[i], part_w[k], part_w[k + kFullPix],
                   part_w[k + 2 * kFullPix]};
    }
  }
  z[p] = best.z;
  id[p] = best.id;
  w[p] = best.w0;
  w[p + kFullPix] = best.w1;
  w[p + 2 * kFullPix] = best.w2;
}

int launch_merge(const float* part_z, const int* part_id,
                 const float* part_w, float* z, int* id, float* w,
                 int splits, cudaStream_t stream) {
  const cudaError_t error = cudaGetLastError();
  if (error != cudaSuccess) return static_cast<int>(error);
  mxu_full_merge_kernel<<<kFullPix / kThreads, kThreads, 0, stream>>>(
      part_z, part_id, part_w, z, id, w, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches its kernel and the merge on `stream` and returns
// cudaGetLastError() (0 on success). `table` is the [visits * C, 16]
// packed rows (prod) or the [visits * 5C, 8] contraction rows (tc, C a
// multiple of 8); partials are [splits, 2048] z and id and
// [splits, 3, 2048] w; outputs [2048] z and id and [3, 2048] w. Device
// pointers to contiguous tensors; the caller checks shapes, types and
// alignment and that `splits` divides `visits`.
extern "C" int mxu_full_prod(const void* table, void* part_z, void* part_id,
                             void* part_w, void* z, void* id, void* w,
                             int visits, int chunk, int splits, float scale,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid(kFullTileW / kBlockX, kFullTileH / kBlockY, splits);
  mxu_full_prod_kernel<<<grid, block, 0, s>>>(
      static_cast<const float4*>(table), static_cast<float*>(part_z),
      static_cast<int*>(part_id), static_cast<float*>(part_w),
      visits / splits * chunk, scale);
  return launch_merge(static_cast<float*>(part_z),
                      static_cast<int*>(part_id),
                      static_cast<float*>(part_w), static_cast<float*>(z),
                      static_cast<int*>(id), static_cast<float*>(w), splits,
                      s);
}

extern "C" int mxu_full_tc(const void* table, void* part_z, void* part_id,
                           void* part_w, void* z, void* id, void* w,
                           int visits, int chunk, int splits, float scale,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kFullTileW / kBlockX, kFullTileH / kBlockY, splits);
  // The kernel computes at its own scale, whose pixel centres are
  // TF32-exact.
  if (scale != kTcPixelScale) return static_cast<int>(cudaErrorInvalidValue);
  mxu_full_tc_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(table), static_cast<float*>(part_z),
      static_cast<int*>(part_id), static_cast<float*>(part_w), chunk,
      visits / splits);
  return launch_merge(static_cast<float*>(part_z),
                      static_cast<int*>(part_id),
                      static_cast<float*>(part_w), static_cast<float*>(z),
                      static_cast<int*>(id), static_cast<float*>(w), splits,
                      s);
}
