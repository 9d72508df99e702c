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
// What bounds it: fp32 instruction throughput, ~18 operations for every
// (triangle, pixel) pair and ~16 more for the pairs inside a triangle,
// 8.4e6 pairs at 512 visits of 8, against 0.26 MB (prod) or 0.66 MB (tc)
// of input.
//
// What the design does about it. As in mxu_edge.cu, 2,048 pixels fill 8
// SMs, so both variants split the visits over `splits` blocks per 16x16
// pixel block (grid 8 x 1 x splits); each block writes its partial winner
// per pixel, and one shared second pass picks the winner over the splits
// (smallest z, ties to the larger id: the merge is order-free, so the
// result is the single pass's bit for bit). The variants differ in how
// the five values of a pair are made:
//   * prod: `rasterize_pixel` of rasterize_common.cuh unchanged (K1's and
//     K3's per-pixel loop with its staged rows and per-block cull), the
//     split's rows passed as its batch image blockIdx.z; the epilogue makes
//     its ids global and maps an empty pixel to z = 2;
//   * tc: per visit and per group of 8 triangles, three m16 tiles of the
//     3xTF32 mma.sync m16n8k8 product hold the group's e0/e1, e2/num and
//     den/padding rows (rows f * C + triangle of the edge-major table,
//     K 3 -> 8 zero-padded), so thread lane = 4g + q receives all five
//     values of triangle g for pixels 2q and 2q + 1 of each n8 tile. Each
//     thread then runs the inside test, depth and carry merge on its pairs
//     into a per-thread carry (8 pixels: 4 tiles x 2 columns), and after
//     the last visit a shuffle tree over the 8 triangle groups (lanes 4
//     apart) merges the carries: the per-visit min-z / max-id reduction of
//     the Pallas kernel, deferred because the merge is order-free. A warp
//     covers two rows of the block's 16x16 pixels. Like the Pallas kernel,
//     tc skips the live-column test.

#include "mma_common.cuh"
#include "rasterize_common.cuh"

#include <cuda_runtime.h>

#include <cstddef>

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

__global__ void __launch_bounds__(kThreads) mxu_full_tc_kernel(
    const float* __restrict__ coeff,  // [visits * 5C, 8], edge-major rows
    float* __restrict__ part_z, int* __restrict__ part_id,
    float* __restrict__ part_w, int chunk, int per_split, float scale) {
  constexpr int kTiles = 4;  // n8 tiles per warp: 2 rows x 2 halves
  constexpr int kRowCols = 8;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int x0 = blockIdx.x * kBlockX;
  const int m_rows = 5 * chunk;

  // B fragments: b0 = (x, y, 1, 0)[q] of pixel g of each tile, b1 = 0
  // (K 4-7). Pixel centres are multiples of 1/512: lo is 0.
  uint32_t b_hi[kTiles][2], b_lo[kTiles][2];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int row = 2 * warp + t / 2;
    const int col = x0 + 8 * (t % 2) + g;
    const float b = q == 0   ? pixel_ndc(col, scale)
                    : q == 1 ? pixel_ndc(row, scale)
                    : q == 2 ? 1.0f
                             : 0.0f;
    const Tf32Split s = split_tf32(b);
    b_hi[t][0] = s.hi;
    b_lo[t][0] = s.lo;
    b_hi[t][1] = b_lo[t][1] = 0u;
  }

  Carry carry[kTiles][2];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      carry[t][c] = Carry{kEmptyZ, -1, 0.0f, 0.0f, 0.0f};
    }
  }

  const int v0 = blockIdx.z * per_split;
  for (int v = v0; v < v0 + per_split; ++v) {
    const float* rows = coeff + static_cast<size_t>(v) * m_rows * kRowCols;
    for (int group = 0; group < chunk; group += 8) {
      const int tri = group + g;
      // m-tile mt holds functions 2 mt (rows 0-7) and 2 mt + 1 (rows
      // 8-15) of the group; function 5 is padding. Columns q < 3 only.
      uint32_t a_hi[3][4], a_lo[3][4];
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 2 * mt + h;
          const float a = f < 5 && q < 3
                              ? rows[(f * chunk + tri) * kRowCols + q]
                              : 0.0f;
          const Tf32Split s = split_tf32(a);
          a_hi[mt][h] = s.hi;
          a_lo[mt][h] = s.lo;
          a_hi[mt][h + 2] = a_lo[mt][h + 2] = 0u;  // K 4-7
        }
      }
      const int id = v * chunk + tri;
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        float d[3][4];
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) {
          mma_tf32x3(d[mt], a_hi[mt], a_lo[mt], b_hi[t], b_lo[t]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e0 = d[0][c], e1 = d[0][2 + c];
          const float e2 = d[1][c], num = d[1][2 + c], den = d[2][c];
          const float min_e = fminf(fminf(e0, e1), e2);
          const float max_e = fmaxf(fmaxf(e0, e1), e2);
          if (!(min_e >= 0.0f && max_e > 0.0f)) continue;
          const float z = num / (den != 0.0f ? den : 1.0f);
          if (z >= -1.0f && z <= 1.0f && better(z, id, carry[t][c])) {
            carry[t][c] = Carry{z, id, e0, e1, e2};
          }
        }
      }
    }
  }

  // Merge the 8 triangle groups' carries (lanes 4 apart); lanes 0-3 store.
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
  mxu_full_tc_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(table), static_cast<float*>(part_z),
      static_cast<int*>(part_id), static_cast<float*>(part_w), chunk,
      visits / splits, scale);
  return launch_merge(static_cast<float*>(part_z),
                      static_cast<int*>(part_id),
                      static_cast<float*>(part_w), static_cast<float*>(z),
                      static_cast<int*>(id), static_cast<float*>(w), splits,
                      s);
}
