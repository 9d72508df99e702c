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
// triangles that is 8.4e6 pairs of 27 operations (fma) against 0.33 MB of
// input; built with --fmad=false no product is fused, so fma issues all 27
// and can reach at most half of the 67 TFLOP/s that counts an FMA as two.
// The tensor-core variants make the five affine functions as [5C, 8] x
// [8, 8] tile products and fold them in the products' accumulators.
//
// What the design does about it. The TPU ran the visit loop in sequence on
// one core over one tile; the card needs the 2,048 pixels' work spread
// over its 132 SMs, each pair's row read from shared memory and serving
// several pairs, and no second launch. All three variants share one
// decomposition:
//   * a CTA of kWarps warps covers a group of kGroupPix pixels (grid x:
//     32 groups); every warp of it covers the whole group for one split of
//     the visits (`splits` contiguous visit ranges, split s covering visits
//     [s V / S, (s + 1) V / S)); a thread-block cluster of
//     ceil(splits / kWarps) CTAs (grid z; 16 at the script's 512 visits,
//     non-portable above 8) holds a group's splits: 32 x 16 = 512 CTAs of
//     4 warps, 3.9 per SM;
//   * each warp stages its split's rows in shared memory with cp.async, in
//     a ring of stages whose next copies fly while one is used (no block
//     barrier: the ring is the warp's own);
//   * each warp writes its partial sums to shared memory; after a cluster
//     barrier CTA r adds the pixels it owns over every split, in split
//     order, through distributed shared memory, and writes them out.
// They differ in how a pair's five values are made and folded:
//   * fma: each lane holds kPixPerLane pixels, so each row read (four
//     broadcast 16-byte shared loads) serves that many pairs whose fold
//     chains interleave; products and sums in the plain version's order
//     (c within a visit, then visits, then splits): bit for bit equal;
//   * tc: per stage the warp rounds its rows once into shared memory (bf16,
//     or TF32 hi and lo parts with their 16-byte halves swizzled so that
//     ldmatrix reads them without bank conflicts) and loads each m16 tile
//     of rows as A fragments with ldmatrix; each A fragment feeds the
//     warp's kTiles n8 tiles of pixels, whose B fragments stay in
//     registers. bf16 runs one m16n8k8 product per tile (K = 8, the
//     contraction's own depth); 3xTF32 runs lo*hi and hi*hi m16n8k8
//     products: the pixel centres are TF32-exact (make_inputs; see
//     mxu_full.cu kTcPixelScale), so B's lo part and the hi*lo product are
//     zero. The m16 tiles run over the split's rows as one sequence (a
//     last partial tile padded with zero rows), and every product lands in
//     its tile's accumulator; after the last stage each thread adds its two
//     rows per column and a shuffle tree adds the 8 row groups.
//     Tensor-core sums round in their own order: the plain version rounds
//     the operands the same way and is compared at a stated tolerance.

#include "cluster.cuh"
#include "mma_common.cuh"

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kEdgeTileW = 128;
constexpr int kEdgePix = 2048;
constexpr int kWarps = 4;  // warps per CTA, one split each
constexpr int kCtaThreads = 32 * kWarps;
constexpr int kGroupPix = 64;  // pixels per CTA
constexpr int kGroups = kEdgePix / kGroupPix;
constexpr int kPixPerLane = kGroupPix / 32;  // fma
constexpr int kTiles = kGroupPix / 8;        // tc: n8 tiles per warp
constexpr int kMaxCluster = 16;              // the non-portable limit
constexpr int kMaxSplits = kWarps * kMaxCluster;
constexpr int kRowFloat4s = 4;     // fma rows: 16 floats (tc: 8, two float4)
// A warp's ring of staged rows: stages of kFmaStageRows rows (2 KB) and
// of kTcStageRows coefficient rows (4 m16 tiles, 2 KB), the copies of the
// next kStages - 1 stages in flight while one is used.
constexpr int kFmaStageRows = 32;
constexpr int kTcStageRows = 64;
constexpr int kFmaStages = 4;
constexpr int kTcStages = 3;

__device__ __forceinline__ float edge_pixel_ndc(int index, float scale) {
  return (static_cast<float>(index) + 0.5f) * scale - 1.0f;
}

// The first visit of split s of `splits` over `visits`.
__device__ __forceinline__ int split_first(int s, int visits, int splits) {
  return static_cast<int>(static_cast<long long>(s) * visits / splits);
}

// Each warp has written its split's sums for the group's kGroupPix pixels
// to `partial` ([kWarps][kGroupPix] in every CTA of the cluster); CTA
// `rank` owns pixels [rank * owned, (rank + 1) * owned) and writes
// out[p] = 0 + split 0's + split 1's + ..., in split order. Every thread
// of every CTA must call it.
__device__ __forceinline__ void merge_splits(const float* partial,
                                             float* __restrict__ out,
                                             int base, int splits) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cluster_size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();  // every warp's sums are in place
  const int owned = (kGroupPix + cluster_size - 1) / cluster_size;
  const int p = rank * owned + static_cast<int>(threadIdx.x);
  if (static_cast<int>(threadIdx.x) < owned && p < kGroupPix) {
    // Every remote load in flight at once, then the ordered sum.
    float v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        v[s] = cluster.map_shared_rank(partial, s / kWarps)[
            (s % kWarps) * kGroupPix + p];
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) sum = sum + v[s];
    }
    out[base + p] = sum;
  }
  cluster.sync();  // the other CTAs have read this one's sums
}

__global__ void __launch_bounds__(kCtaThreads) mxu_edge_fma_kernel(
    const float4* __restrict__ rows,  // [visits * C, 16]
    float* __restrict__ out,          // [2048]
    int visits, int chunk, int splits, float scale) {
  __shared__ float4 staged[kWarps][kFmaStages][kFmaStageRows * kRowFloat4s];
  __shared__ float partial[kWarps * kGroupPix];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int split = blockIdx.z * kWarps + warp;
  const int base = blockIdx.x * kGroupPix;

  float px[kPixPerLane], py[kPixPerLane], acc[kPixPerLane];
#pragma unroll
  for (int k = 0; k < kPixPerLane; ++k) {
    const int p = base + 32 * k + lane;
    px[k] = edge_pixel_ndc(p % kEdgeTileW, scale);
    py[k] = edge_pixel_ndc(p / kEdgeTileW, scale);
    acc[k] = 0.0f;
  }

  if (split < splits) {
    const int row0 = split_first(split, visits, splits) * chunk;
    const int n = split_first(split + 1, visits, splits) * chunk - row0;
    const float4* src = rows + static_cast<size_t>(row0) * kRowFloat4s;
    const int n_stages = (n + kFmaStageRows - 1) / kFmaStageRows;
    auto issue = [&](int j) {
      const int first = j * kFmaStageRows;
      const int m = min(kFmaStageRows, n - first);
      float4* dst = staged[warp][j % kFmaStages];
      for (int i = lane; i < m * kRowFloat4s; i += 32) {
        cp_async16(dst + i, src + first * kRowFloat4s + i);
      }
      cp_async_commit();
    };
    // A stage past the split commits an empty group.
    for (int j = 0; j < kFmaStages - 1; ++j) issue(j);
    float visit_sum[kPixPerLane];
    int c = 0;  // the row's triangle within its visit
    for (int j = 0; j < n_stages; ++j) {
      issue(j + kFmaStages - 1);
      cp_async_wait<kFmaStages - 1>();
      __syncwarp();  // every lane's copies of stage j are visible
      const float4* row = staged[warp][j % kFmaStages];
      const int m = min(kFmaStageRows, n - j * kFmaStageRows);
      for (int i = 0; i < m; ++i, row += kRowFloat4s) {
        const float4 r0 = row[0];  // a0 b0 c0 a1
        const float4 r1 = row[1];  // b1 c1 a2 b2
        const float4 r2 = row[2];  // c2 z0 z1 z2
        const float4 r3 = row[3];  // w0 w1 w2 (unused)
#pragma unroll
        for (int k = 0; k < kPixPerLane; ++k) {
          const float e0 = r0.x * px[k] + r0.y * py[k] + r0.z;
          const float e1 = r0.w * px[k] + r1.x * py[k] + r1.y;
          const float e2 = r1.z * px[k] + r1.w * py[k] + r2.x;
          const float num = e0 * r2.y + e1 * r2.z + e2 * r2.w;
          const float den = e0 * r3.x + e1 * r3.y + e2 * r3.z;
          const float term = e0 + e1 + e2 + num + den;
          visit_sum[k] = c == 0 ? term : visit_sum[k] + term;
        }
        if (++c == chunk) {
#pragma unroll
          for (int k = 0; k < kPixPerLane; ++k) acc[k] = acc[k] + visit_sum[k];
          c = 0;
        }
      }
      __syncwarp();  // stage j is consumed before its buffer is reused
    }
  }
#pragma unroll
  for (int k = 0; k < kPixPerLane; ++k) {
    partial[warp * kGroupPix + 32 * k + lane] = acc[k];
  }
  merge_splits(partial, out, base, splits);
}

template <bool kBf16>
__global__ void __launch_bounds__(kCtaThreads) mxu_edge_tc_kernel(
    const float* __restrict__ coeff,  // [visits * 5C, 8]
    const float* __restrict__ pix,    // [8, 2048]
    float* __restrict__ out,          // [2048]
    int visits, int chunk, int splits) {
  // A warp's rounded rows: bf16, one 16-byte row of 8 values each; TF32,
  // the hi and the lo parts, two 16-byte halves a row each.
  constexpr int kHiRows = kBf16 ? kTcStageRows : 2 * kTcStageRows;
  constexpr int kLoRows = kBf16 ? 1 : 2 * kTcStageRows;
  __shared__ float4 staged[kWarps][kTcStages][kTcStageRows * 2];
  __shared__ uint4 a_hi_s[kWarps][kHiRows];
  __shared__ uint4 a_lo_s[kWarps][kLoRows];
  __shared__ float partial[kWarps * kGroupPix];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int split = blockIdx.z * kWarps + warp;
  const int base = blockIdx.x * kGroupPix;

  // B fragments, constant over the visits: bf16 B[2q..2q+1][g]; TF32
  // B[q][g] and B[q + 4][g] (hi parts: the lo parts are zero).
  uint32_t b[kTiles][2];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int n = base + 8 * t + g;
    if constexpr (kBf16) {
      b[t][0] = pack_bf16(pix[(2 * q) * kEdgePix + n],
                          pix[(2 * q + 1) * kEdgePix + n]);
      b[t][1] = 0u;
    } else {
      b[t][0] = to_tf32(pix[q * kEdgePix + n]);
      b[t][1] = to_tf32(pix[(q + 4) * kEdgePix + n]);
    }
  }
  float acc[kTiles][4] = {};

  if (split < splits) {
    const int funcs = 5 * chunk;
    const int row0 = split_first(split, visits, splits) * funcs;
    const int n = split_first(split + 1, visits, splits) * funcs - row0;
    const float4* src =
        reinterpret_cast<const float4*>(coeff) + static_cast<size_t>(row0) * 2;
    const int n_stages = (n + kTcStageRows - 1) / kTcStageRows;
    auto issue = [&](int j) {
      const int first = j * kTcStageRows;
      const int m = min(kTcStageRows, n - first);
      float4* dst = staged[warp][j % kTcStages];
      for (int i = lane; i < 2 * m; i += 32) {
        cp_async16(dst + i, src + 2 * first + i);
      }
      cp_async_commit();
    };
    for (int j = 0; j < kTcStages - 1; ++j) issue(j);
    for (int j = 0; j < n_stages; ++j) {
      issue(j + kTcStages - 1);
      cp_async_wait<kTcStages - 1>();
      __syncwarp();  // every lane's copies of stage j are visible
      const int m = min(kTcStageRows, n - j * kTcStageRows);
      const int m_tiles = (m + 15) / 16;
      // Round rows lane + 32 h once; rows past the split are zero.
#pragma unroll
      for (int h = 0; h < kTcStageRows / 32; ++h) {
        const int r = lane + 32 * h;
        float4 x0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), x1 = x0;
        if (r < m) {
          x0 = staged[warp][j % kTcStages][2 * r];
          x1 = staged[warp][j % kTcStages][2 * r + 1];
        }
        if constexpr (kBf16) {
          a_hi_s[warp][r] = make_uint4(pack_bf16(x0.x, x0.y),
                                       pack_bf16(x0.z, x0.w),
                                       pack_bf16(x1.x, x1.y),
                                       pack_bf16(x1.z, x1.w));
        } else {
          const float x[8] = {x0.x, x0.y, x0.z, x0.w,
                              x1.x, x1.y, x1.z, x1.w};
          uint32_t hi[8], lo[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const Tf32Split s = split_tf32(x[k]);
            hi[k] = s.hi;
            lo[k] = s.lo;
          }
          // Half c (columns 4c..4c+3) of row r at half c ^ ((r >> 2) & 1).
          const int swap = (r >> 2) & 1;
          a_hi_s[warp][2 * r + swap] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          a_hi_s[warp][2 * r + (swap ^ 1)] =
              make_uint4(hi[4], hi[5], hi[6], hi[7]);
          a_lo_s[warp][2 * r + swap] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          a_lo_s[warp][2 * r + (swap ^ 1)] =
              make_uint4(lo[4], lo[5], lo[6], lo[7]);
        }
      }
      __syncwarp();  // the rounded rows are visible to every lane
      for (int mt = 0; mt < m_tiles; ++mt) {
        if constexpr (kBf16) {
          // Matrix j (lanes 8j..8j+7): rows 16 mt + 8 j + (lane % 8).
          uint32_t a[2];
          ldmatrix_x2(a, &a_hi_s[warp][16 * mt + (lane % 16)]);
#pragma unroll
          for (int t = 0; t < kTiles; ++t) {
            mma_bf16_k8(acc[t], a, b[t][0], acc[t]);
          }
        } else {
          // Matrix j: rows 16 mt + 8 (j & 1) + (lane % 8), half j >> 1.
          const int jm = lane / 8;
          const int r = 16 * mt + 8 * (jm & 1) + lane % 8;
          const int at = 2 * r + ((jm >> 1) ^ ((r >> 2) & 1));
          uint32_t a_hi[4], a_lo[4];
          ldmatrix_x4(a_hi, &a_hi_s[warp][at]);
          ldmatrix_x4(a_lo, &a_lo_s[warp][at]);
#pragma unroll
          for (int t = 0; t < kTiles; ++t) {
            mma_tf32(acc[t], a_lo, b[t], acc[t]);
            mma_tf32(acc[t], a_hi, b[t], acc[t]);
          }
        }
      }
      __syncwarp();  // stage j is consumed before its buffers are reused
    }
  }

  // Rows g and g + 8, then the 8 row groups (lanes 4 apart).
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    float col[2] = {acc[t][0] + acc[t][2], acc[t][1] + acc[t][3]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int offset = 4; offset < 32; offset *= 2) {
        col[i] += __shfl_xor_sync(0xffffffffu, col[i], offset);
      }
    }
    if (g == 0) {
      partial[warp * kGroupPix + 8 * t + 2 * q] = col[0];
      partial[warp * kGroupPix + 8 * t + 2 * q + 1] = col[1];
    }
  }
  merge_splits(partial, out, base, splits);
}

// Launches `kernel` on the (kGroups, 1, cluster) grid in clusters of
// ceil(splits / kWarps) CTAs; returns the launch's CUDA error. More than
// kMaxSplits splits returns cudaErrorInvalidConfiguration.
template <typename... Params, typename... Args>
int launch_edge(void (*kernel)(Params...), int splits, void* stream,
                Args... args) {
  if (splits < 1 || splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int cluster = (splits + kWarps - 1) / kWarps;
  if (cluster > 8) {
    const cudaError_t error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  return launch_cluster(kernel, dim3(kGroups, 1, cluster), dim3(kCtaThreads),
                        0, cluster, stream, args...);
}

}  // namespace

// Each entry launches its kernel on `stream` and returns its CUDA error (0
// on success). Pointers are device pointers to contiguous tensors; the
// caller checks shapes, types and alignment. `splits` (1 to 64, at most
// `visits`) is microbench/mxu_edge.py `edge_splits`.
extern "C" int mxu_edge_fma(const void* rows, void* out, int visits,
                            int chunk, int splits, float scale,
                            void* stream) {
  return launch_edge(mxu_edge_fma_kernel, splits, stream,
                     static_cast<const float4*>(rows),
                     static_cast<float*>(out), visits, chunk, splits, scale);
}

extern "C" int mxu_edge_tc(const void* coeff, const void* pix, void* out,
                           int visits, int chunk, int splits, int bf16,
                           void* stream) {
  const float* c = static_cast<const float*>(coeff);
  const float* p = static_cast<const float*>(pix);
  float* o = static_cast<float*>(out);
  if (bf16) {
    return launch_edge(mxu_edge_tc_kernel<true>, splits, stream, c, p, o,
                       visits, chunk, splits);
  }
  return launch_edge(mxu_edge_tc_kernel<false>, splits, stream, c, p, o,
                     visits, chunk, splits);
}
