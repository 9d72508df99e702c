// Edge-function evaluation microbenchmark: fp32 arithmetic on the CUDA
// cores vs tensor-core contractions, for Hopper.
//
// Replaces the Pallas kernels of scripts/mxu_edge_microbench.py (S1):
// `kernel_vpu` (:117) by mxu_edge_fma_kernel and `kernel_mxu` (:144, at
// Precision.DEFAULT and HIGHEST) by mxu_edge_tc_kernel<bf16 / 3xTF32>.
// The plain PyTorch versions they are held against are
// pytorch_mesh_renderer_tpu_torch/microbench/mxu_edge.py `fold_fma_torch`
// and `fold_tc_torch`.
//
// The function: one 16x128 tile of pixels (px, py at the pixel pitch of a
// 512x512 image) and `visits` visits of C triangles; per (triangle, pixel)
// pair the three edge functions and the depth numerator and denominator,
// folded into one sum per pixel: out[p] = sum over pairs of
// e0 + e1 + e2 + num + den.
//
// What bounds it: fp32 instruction throughput. At 512 visits of 8
// triangles that is 8.4e6 pairs of ~27 operations (fma) against 0.33 MB of
// input; the tensor-core variants turn the 22 operations of the five
// affine functions into [5C, 8] x [8, 8] tile products and keep ~5 for the
// fold.
//
// What the design does about it. The TPU ran the visit loop in sequence on
// one core over one tile; 2,048 pixels at one thread each fill 8 of the
// card's 132 SMs. So every variant splits the visits over `splits` blocks
// per 256-pixel block (grid 8 x splits) and a second pass adds the
// `splits` partial sums per pixel in split order. The variants share that
// decomposition and the additive fold, and differ only in how a pair's
// five values are made:
//   * fma: one thread per pixel, the packed rows read with broadcast
//     16-byte loads (every thread of a warp reads the same row), products
//     and sums in the order of the plain version (built with --fmad=false,
//     so a*b + c stays a product and a sum): bit for bit equal to it;
//   * tc: one warp per 32 pixels (four n8 tiles of the product). Per visit
//     the [5C, 8] coefficient rows, padded to whole m16 tiles, are the A
//     fragments (bf16: one m16n8k16 product, K 8 -> 16 zero-padded;
//     3xTF32: three m16n8k8 products hi*hi + hi*lo + lo*hi of operands
//     split by cvt.rna.tf32.f32), the [8, 2048] pixel matrix the B
//     fragments, loaded once. Each tile's product is added to a per-thread
//     accumulator of the same shape (one fp32 add per value, as the fma
//     fold adds each value once); after the last visit each thread adds
//     its two rows per column and a shuffle tree adds the 8 row groups.
//     Tensor-core sums round in their own order: the plain version rounds
//     the operands the same way and is compared at a stated tolerance.

#include "mma_common.cuh"

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kEdgeTileW = 128;
constexpr int kEdgePix = 2048;
constexpr int kEdgeThreads = 256;  // pixels per block, both variants
constexpr int kRowCols = 8;        // coefficient row width (K)

__device__ __forceinline__ float edge_pixel_ndc(int index, float scale) {
  return (static_cast<float>(index) + 0.5f) * scale - 1.0f;
}

// Visits [split * per_split, (split + 1) * per_split) of blockIdx.y.
__global__ void __launch_bounds__(kEdgeThreads) mxu_edge_fma_kernel(
    const float4* __restrict__ rows,  // [visits * C, 16]
    float* __restrict__ partial,      // [splits, 2048]
    int chunk, int per_split, float scale) {
  const int p = blockIdx.x * kEdgeThreads + threadIdx.x;
  const float px = edge_pixel_ndc(p % kEdgeTileW, scale);
  const float py = edge_pixel_ndc(p / kEdgeTileW, scale);
  const int v0 = blockIdx.y * per_split;
  float acc = 0.0f;
  for (int v = v0; v < v0 + per_split; ++v) {
    const float4* row = rows + static_cast<size_t>(v) * chunk * 4;
    float visit_sum = 0.0f;
    for (int c = 0; c < chunk; ++c, row += 4) {
      const float4 r0 = __ldg(row + 0);  // a0 b0 c0 a1
      const float4 r1 = __ldg(row + 1);  // b1 c1 a2 b2
      const float4 r2 = __ldg(row + 2);  // c2 z0 z1 z2
      const float4 r3 = __ldg(row + 3);  // w0 w1 w2 (unused)
      const float e0 = r0.x * px + r0.y * py + r0.z;
      const float e1 = r0.w * px + r1.x * py + r1.y;
      const float e2 = r1.z * px + r1.w * py + r2.x;
      const float num = e0 * r2.y + e1 * r2.z + e2 * r2.w;
      const float den = e0 * r3.x + e1 * r3.y + e2 * r3.z;
      const float term = e0 + e1 + e2 + num + den;
      visit_sum = c == 0 ? term : visit_sum + term;
    }
    acc = acc + visit_sum;
  }
  partial[static_cast<size_t>(blockIdx.y) * kEdgePix + p] = acc;
}

// Each warp: pixels [base, base + 32) as four n8 tiles.
template <bool kBf16>
__global__ void __launch_bounds__(kEdgeThreads) mxu_edge_tc_kernel(
    const float* __restrict__ coeff,  // [visits * 5C, 8]
    const float* __restrict__ pix,    // [8, 2048]
    float* __restrict__ partial,      // [splits, 2048]
    int chunk, int per_split) {
  constexpr int kTiles = 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int base = blockIdx.x * kEdgeThreads + (threadIdx.x / 32) * 32;
  const int m_rows = 5 * chunk;
  const int m_tiles = (m_rows + 15) / 16;

  // B fragments, constant over the visits.
  uint32_t b_hi[kTiles][2], b_lo[kTiles][2];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int n = base + 8 * t + g;
    if constexpr (kBf16) {  // rows 2q, 2q+1; rows 8-15 are the K padding
      b_hi[t][0] = pack_bf16(pix[(2 * q) * kEdgePix + n],
                             pix[(2 * q + 1) * kEdgePix + n]);
      b_hi[t][1] = 0u;
      b_lo[t][0] = b_lo[t][1] = 0u;
    } else {  // rows q and q + 4
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const Tf32Split s = split_tf32(pix[(q + 4 * k) * kEdgePix + n]);
        b_hi[t][k] = s.hi;
        b_lo[t][k] = s.lo;
      }
    }
  }

  float acc[kTiles][4] = {};
  const int v0 = blockIdx.y * per_split;
  for (int v = v0; v < v0 + per_split; ++v) {
    const float* rows = coeff + static_cast<size_t>(v) * m_rows * kRowCols;
    for (int mt = 0; mt < m_tiles; ++mt) {
      const int r0 = mt * 16 + g;
      const int r1 = r0 + 8;
      uint32_t a_hi[4], a_lo[4];
      if constexpr (kBf16) {
        a_hi[0] = r0 < m_rows ? pack_bf16(rows[r0 * kRowCols + 2 * q],
                                          rows[r0 * kRowCols + 2 * q + 1])
                              : 0u;
        a_hi[1] = r1 < m_rows ? pack_bf16(rows[r1 * kRowCols + 2 * q],
                                          rows[r1 * kRowCols + 2 * q + 1])
                              : 0u;
        a_hi[2] = a_hi[3] = 0u;  // K 8-15: padding
      } else {
        const float x[4] = {
            r0 < m_rows ? rows[r0 * kRowCols + q] : 0.0f,
            r1 < m_rows ? rows[r1 * kRowCols + q] : 0.0f,
            r0 < m_rows ? rows[r0 * kRowCols + q + 4] : 0.0f,
            r1 < m_rows ? rows[r1 * kRowCols + q + 4] : 0.0f};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const Tf32Split s = split_tf32(x[k]);
          a_hi[k] = s.hi;
          a_lo[k] = s.lo;
        }
      }
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        float d[4];
        if constexpr (kBf16) {
          const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(d, a_hi, b_hi[t], zero);
        } else {
          mma_tf32x3(d, a_hi, a_lo, b_hi[t], b_lo[t]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][i] = acc[t][i] + d[i];
      }
    }
  }

  // Rows g and g + 8, then the 8 row groups (lanes 4 apart).
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    float col[2] = {acc[t][0] + acc[t][2], acc[t][1] + acc[t][3]};
    for (int i = 0; i < 2; ++i) {
      for (int offset = 4; offset < 32; offset *= 2) {
        col[i] += __shfl_xor_sync(0xffffffffu, col[i], offset);
      }
    }
    if (g == 0) {
      float* out = partial + static_cast<size_t>(blockIdx.y) * kEdgePix +
                   base + 8 * t + 2 * q;
      out[0] = col[0];
      out[1] = col[1];
    }
  }
}

// out[p] = 0 + partial[0][p] + partial[1][p] + ... in split order.
__global__ void __launch_bounds__(kEdgeThreads) mxu_edge_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int splits) {
  const int p = blockIdx.x * kEdgeThreads + threadIdx.x;
  float sum = 0.0f;
  for (int j = 0; j < splits; ++j) {
    sum = sum + partial[static_cast<size_t>(j) * kEdgePix + p];
  }
  out[p] = sum;
}

int launch_sum(float* partial, float* out, int splits, cudaStream_t stream) {
  cudaError_t error = cudaGetLastError();
  if (error != cudaSuccess) return static_cast<int>(error);
  mxu_edge_sum_kernel<<<kEdgePix / kEdgeThreads, kEdgeThreads, 0, stream>>>(
      partial, out, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches its kernel and the split sum on `stream` and returns
// cudaGetLastError() (0 on success). Pointers are device pointers to
// contiguous tensors; the caller checks shapes, types and alignment and
// that `splits` divides `visits`.
extern "C" int mxu_edge_fma(const void* rows, void* partial, void* out,
                            int visits, int chunk, int splits, float scale,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kEdgePix / kEdgeThreads, splits);
  mxu_edge_fma_kernel<<<grid, kEdgeThreads, 0, s>>>(
      static_cast<const float4*>(rows), static_cast<float*>(partial), chunk,
      visits / splits, scale);
  return launch_sum(static_cast<float*>(partial), static_cast<float*>(out),
                    splits, s);
}

extern "C" int mxu_edge_tc(const void* coeff, const void* pix, void* partial,
                           void* out, int visits, int chunk, int splits,
                           int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kEdgePix / kEdgeThreads, splits);
  const float* c = static_cast<const float*>(coeff);
  const float* p = static_cast<const float*>(pix);
  float* part = static_cast<float*>(partial);
  if (bf16) {
    mxu_edge_tc_kernel<true><<<grid, kEdgeThreads, 0, s>>>(
        c, p, part, chunk, visits / splits);
  } else {
    mxu_edge_tc_kernel<false><<<grid, kEdgeThreads, 0, s>>>(
        c, p, part, chunk, visits / splits);
  }
  return launch_sum(part, static_cast<float*>(out), splits, s);
}
