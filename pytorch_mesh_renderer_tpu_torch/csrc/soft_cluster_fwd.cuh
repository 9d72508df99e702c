// The cluster forward shared by the full SoftRas forward K7 (soft_fwd.cu)
// and the silhouette forward K5 (soft_sil_fwd.cu): one body, instantiated
// with shading (K7: rgba, m, sum_w) and without (K5: alpha).
//
// The design: a thread-block cluster of kSplit CTAs per pixel block
// splits the pairs, and each pixel still folds them in index order. The
// grid is (ceil(W / 16), ceil(H / 16), B x kSplit) in clusters of
// (1, 1, kSplit). A pass covers kSplit x 512 table rows: CTA s culls rows
// [t0 + 512 s, t0 + 512 (s + 1)), two per thread (cull_rows), keeps
// their offsets in index order and writes its count into
// every CTA of the cluster (distributed shared memory); after one cluster
// barrier each CTA knows that the pass's kept rows in index order are
// CTA 0's, then CTA 1's, and so on, and a pass no CTA keeps a row of ends
// there. Entry e of that list is evaluated by CTA e mod kSplit, so each
// CTA takes an equal share whatever the mesh's order. In rounds of
// kSplit x kRecordRows entries a CTA stages its rows, evaluates each
// against the block's 256 pixels (one thread per pixel: the geometry
// phase, and with shading the Phong terms) and writes a record per (row,
// pixel), with a ballot of the valid pixels: with shading the logit
// z / gamma, the coverage and the three shaded colours (40 KB of records),
// without it the coverage alone (8 KB). After a cluster barrier the owner
// of each pixel (CTA s owns 256 / kSplit pixels, one 16x2 row pair at
// kSplit 8) folds the round's entries in index order, reading entry e's
// record from CTA e mod kSplit through distributed shared memory,
// kFoldBatch entries' loads at once, and skipping the invalid ones; a
// second cluster barrier comes before the next round overwrites the
// records. The fold state stays in the owner's registers. So each pixel
// folds the same valid pairs in the same order with the same arithmetic
// as one thread running every staged row: the outputs do not depend on
// kSplit, and the silhouette product sil <- sil * (1 - coverage) runs on
// the same coverages in the same order in both instances, so K5's alpha
// equals K7's bit for bit.
//
// What bounds it: the busy pixel blocks' pairs (soft_common.cuh), and the
// stream and cull of every row by every block. A busy block holds kSplit
// CTA slots for all its rounds, so the split pays where the busy blocks
// times kSplit about fit the card's resident CTAs; where the pairs are
// cheap (K5), the cluster's passes and barriers cost about what the split
// saves (PERF.md).

#pragma once

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "soft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplit = 8;  // the portable cluster size
constexpr int kWarps = kSoftThreads / 32;
// Rows a CTA culls per pass, two per thread: at kSplit 8 a pass covers
// 4,096 rows, so the teapot's 2,464 take one.
constexpr int kCullPerThread = 2;
constexpr int kPassRows = kCullPerThread * kSoftThreads;
// Rows a CTA evaluates per round; its records are dynamic shared memory,
// kFields x kRecordRows x 256 floats.
constexpr int kRecordRows = 8;
// Entries whose records a folding lane loads before it folds them.
constexpr int kFoldBatch = 4;

// Record fields per (row, pixel): logit, coverage, shade r, g, b with
// shading; the coverage alone without.
template <bool kShade>
constexpr int kFields = kShade ? 5 : 1;
template <bool kShade>
constexpr int kRecordBytes =
    kFields<kShade> * kRecordRows * kSoftThreads * sizeof(float);

// The body of K7 (kShade) and K5 (!kShade). K7 writes rgba, m and sum_w
// and reads the lights; K5 writes alpha and takes neither lights nor the
// other outputs (null). Every thread of the CTA must call it.
template <bool kShade>
__device__ __forceinline__ void soft_cluster_forward(
    const float* __restrict__ table,    // [B, T, 59]
    const float4* __restrict__ lights,  // [B, L] (x, y, z, intensity)
    const float* __restrict__ params,   // sigma, gamma, blur^2, row offset
    float4* __restrict__ rgba,          // [B, H, W]
    float* __restrict__ m_out,          // [B, H, W]
    float* __restrict__ sumw_out,       // [B, H, W]
    float* __restrict__ alpha_out,      // [B, H, W]
    int num_tris, int num_lights, int width, int height, int full_height) {
  constexpr int kNumFields = kFields<kShade>;
  constexpr int kCoverage = kShade ? 1 : 0;  // the coverage's field
  extern __shared__ float rec[];  // [kNumFields][kRecordRows][kSoftThreads]
  __shared__ unsigned s_valid[kRecordRows][kWarps];  // ballots per row
  __shared__ float slab[kRecordRows * kCols];
  // Kept rows of the pass, and every CTA's count of them (each CTA writes
  // its own into all), by pass parity: a CTA works on pass p + 1 while
  // another may still read its pass p.
  __shared__ int s_kept[2][kPassRows];
  __shared__ int s_counts[2][kMaxSplit];
  __shared__ int warp_kept[kCullPerThread * kWarps];
  __shared__ int s_mine[kPassRows];  // the rows this CTA evaluates

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z / split;
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int x0 = blockIdx.x * kSoftBlockX;
  const int y0 = blockIdx.y * kSoftBlockY;
  const SoftParams p = load_params(params);
  const BlockExtent extent = block_extent(width, height, p.row_off,
                                          full_height);
  const float* rows_b = table + static_cast<size_t>(b) * num_tris * kCols;
  const float4* lights_b =
      kShade ? lights + static_cast<size_t>(b) * num_lights : nullptr;

  // The pixel this thread evaluates rows against.
  const int x = x0 + static_cast<int>(threadIdx.x);
  const int y = y0 + static_cast<int>(threadIdx.y);
  const bool in_image = x < width && y < height;
  const float px = pixel_x(x, width);
  const float py = pixel_y(y, p.row_off, full_height);

  // The pixel this thread folds, if it is one of the CTA's owners.
  const int owned = kSoftThreads / split;
  const bool owner = tid < owned;
  const int pix = rank * owned + tid;  // in the block
  float m = kEps / p.gamma;
  float sum_w = 0.0f, sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;
  float sil = 1.0f;

  // A CTA writes into another's shared memory only once that one runs:
  // the first pass's cull overlaps this barrier.
  cluster_arrive();
  bool started = false;
  int parity = 0;
  for (int t0 = 0; t0 < num_tris; t0 += split * kPassRows, parity ^= 1) {
    const int base = t0 + rank * kPassRows;
    const int n_kept = cull_rows<kSoftThreads, kCullPerThread>(
        rows_b, base, min(kPassRows, num_tris - base), 1, extent,
        s_kept[parity], warp_kept);
    if (!started) {
      cluster_wait();
      started = true;
    }
    if (tid < split) {
      cluster.map_shared_rank(&s_counts[parity][0], tid)[rank] = n_kept;
    }
    // After this barrier every CTA's kept rows and count of the pass are
    // in place.
    cluster.sync();
    int n_total = 0;
    for (int r = 0; r < split; ++r) n_total += s_counts[parity][r];
    if (n_total == 0) continue;  // uniform over the cluster

    // Entry e = rank + split q of the pass's kept rows is this CTA's q-th.
    const int n_mine = n_total > rank ? (n_total - rank + split - 1) / split
                                      : 0;
    for (int q = tid; q < n_mine; q += kSoftThreads) {
      int e = rank + split * q;
      int r = 0;
      while (e >= s_counts[parity][r]) e -= s_counts[parity][r++];
      s_mine[q] = t0 + r * kPassRows +
                  cluster.map_shared_rank(&s_kept[parity][0], r)[e];
    }
    __syncthreads();

    for (int e0 = 0; e0 < n_total; e0 += split * kRecordRows) {
      const int q0 = e0 / split;
      const int n_rows = max(min(n_mine - q0, kRecordRows), 0);
      for (int i = tid; i < n_rows * kCols; i += kSoftThreads) {
        const int k = i / kCols;
        slab[i] = rows_b[static_cast<size_t>(s_mine[q0 + k]) * kCols +
                         (i - k * kCols)];
      }
      __syncthreads();
      for (int j = 0; j < n_rows; ++j) {  // uniform over the block
        bool valid = false;
        if (in_image) {
          const float* r = slab + j * kCols;
          const SoftGeometry g = soft_geometry(r, px, py, p.sigma,
                                               p.sq_blur);
          valid = g.valid;
          if (valid) {
            float* out = rec + j * kSoftThreads + tid;
            const int field = kRecordRows * kSoftThreads;
            out[kCoverage * field] = g.coverage;
            if constexpr (kShade) {
              const SoftShade s = soft_shade(r, g, lights_b, num_lights);
              out[0] = g.z / p.gamma;
              out[2 * field] = s.cr * s.light_sum;
              out[3 * field] = s.cg * s.light_sum;
              out[4 * field] = s.cb * s.light_sum;
            }
          }
        }
        const unsigned ballot = __ballot_sync(kFullMask, valid);
        if (lane == 0) s_valid[j][warp] = ballot;
      }
      cluster.sync();  // the round's records are in place

      if (owner) {  // whole warps
        // Lane l loads the valid ballots of entries e0 + l and e0 + 32 + l
        // for its warp's pixels. The warp visits only the entries valid for
        // one of its lanes, in index order, and loads kFoldBatch entries'
        // records before it folds them.
        const int e1 = min(e0 + split * kRecordRows, n_total);
        const int owner_warp = pix / 32;
        unsigned ballots[2] = {0u, 0u};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = e0 + 32 * h + lane;
          if (e < e1) {
            ballots[h] = cluster.map_shared_rank(
                &s_valid[0][0], e % split)[(e / split - q0) * kWarps +
                                           owner_warp];
          }
        }
        unsigned long long todo =
            __ballot_sync(kFullMask, ballots[0] != 0u) |
            static_cast<unsigned long long>(
                __ballot_sync(kFullMask, ballots[1] != 0u))
                << 32;
        while (todo != 0ull) {  // uniform over the warp
          float v[kFoldBatch][kNumFields];
          bool ok[kFoldBatch];
#pragma unroll
          for (int u = 0; u < kFoldBatch; ++u) {
            const int k =
                todo != 0ull ? __ffsll(static_cast<long long>(todo)) - 1 : -1;
            todo &= todo - 1ull;
            unsigned ballot = 0u;
            if (k >= 0) {
              ballot = __shfl_sync(kFullMask, k < 32 ? ballots[0] : ballots[1],
                                   k % 32);
            }
            ok[u] = (ballot >> lane) & 1u;
            if (ok[u]) {
              const int e = e0 + k;
              const float* in = cluster.map_shared_rank(rec, e % split) +
                                (e / split - q0) * kSoftThreads + pix;
#pragma unroll
              for (int f = 0; f < kNumFields; ++f) {
                v[u][f] = in[f * kRecordRows * kSoftThreads];
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kFoldBatch; ++u) {
            if (!ok[u]) continue;
            const float coverage = v[u][kCoverage];
            if constexpr (kShade) {
              const float logit = v[u][0];
              const float new_max = fmaxf(m, logit);
              const float scale = expf(m - new_max);
              const float w = coverage * expf(logit - new_max);
              sum_w = sum_w * scale + w;
              sum_r = sum_r * scale + w * v[u][2];
              sum_g = sum_g * scale + w * v[u][3];
              sum_b = sum_b * scale + w * v[u][4];
              m = new_max;
            }
            sil = sil * (1.0f - coverage);
          }
        }
      }
      cluster.sync();  // before the next round overwrites the records
    }
  }
  // Every remote read above comes before a cluster barrier that all CTAs
  // pass, so a CTA may leave now.
  if (!started) cluster_wait();
  const int xo = x0 + pix % kSoftBlockX;
  const int yo = y0 + pix / kSoftBlockX;
  if (!owner || xo >= width || yo >= height) return;
  const size_t pixel =
      (static_cast<size_t>(b) * height + yo) * static_cast<size_t>(width) +
      xo;
  if constexpr (kShade) {
    const float bg = fmaxf(expf(kEps / p.gamma - m), kEps);
    const float inv_total = 1.0f / (sum_w + bg);
    rgba[pixel] = make_float4(sum_r * inv_total, sum_g * inv_total,
                              sum_b * inv_total, 1.0f - sil);
    m_out[pixel] = m;
    sumw_out[pixel] = sum_w;
  } else {
    alpha_out[pixel] = 1.0f - sil;
  }
}

// Launches `kernel` (a __global__ that calls soft_cluster_forward with
// `record_bytes` of records) in clusters of `split` CTAs per pixel block
// (0 for `default_split`; 1, 2, 4 or 8) on `stream` and returns the
// launch's CUDA error (0 on success).
template <typename... Params, typename... Args>
int launch_soft_cluster(void (*kernel)(Params...), int record_bytes,
                        int default_split, int split, int batch, int width,
                        int height, void* stream, Args... args) {
  if (split == 0) split = default_split;
  if (split < 1 || split > kMaxSplit || kSoftThreads % (32 * split) != 0 ||
      static_cast<long long>(batch) * split > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t error = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, record_bytes);
  if (error != cudaSuccess) return static_cast<int>(error);
  return launch_cluster(
      kernel,
      dim3((width + kSoftBlockX - 1) / kSoftBlockX,
           (height + kSoftBlockY - 1) / kSoftBlockY, batch * split),
      dim3(kSoftBlockX, kSoftBlockY), record_bytes, split, stream, args...);
}

// Resident CTAs of `kernel` per SM with `record_bytes` of records
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
template <typename... Params>
int soft_cluster_blocks_per_sm(void (*kernel)(Params...), int record_bytes) {
  cudaError_t error = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, record_bytes);
  int blocks = 0;
  if (error == cudaSuccess) {
    error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kSoftThreads, record_bytes);
  }
  return error == cudaSuccess ? blocks : -static_cast<int>(error);
}

}  // namespace
