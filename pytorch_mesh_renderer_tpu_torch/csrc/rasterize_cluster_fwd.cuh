// The cluster body of the forward hard rasterizers K1
// (rasterize_fused_fwd.cu, with attribute interpolation) and K3
// (rasterize_bary_fwd.cu, ids, barycentrics and z only), and of S2's
// production core (mxu_full.cu `prod`): one carry stage
// (`cluster_winners`), templated on the group of pixel blocks a cluster
// covers and on an epilogue that writes each pixel's winner: K1's and K3's
// (`rasterize_cluster`, templated on the attributes, so that K3's ids, bc
// and z equal K1's by construction) and S2's. The per-pixel test, the
// per-block edge cull and the order of winners are rasterize_common.cuh's;
// the launch rule K3 and S2 share is `choose_launch`.
//
// What bounds it. Every 16x16 pixel block must see every triangle row:
// with one CTA per block, on the 256x256 batch-4 teapot (2,464 rows) that
// is 1,024 blocks x 158 KB of rows read from L2 and culled, and a table
// moved off screen, whose rows all fail the cull, takes 59% of the time
// (utils/hard_work.py, PERF.md); on the sphere72 stress mesh at 512x512 it
// is 2.7 GB. The rest is the per-pixel test on the kept rows: 55 a block
// on average, 539 in the teapot's busiest.
//
// The design: a thread-block cluster of `split` CTAs covers a group of
// kGroup x kGroup pixel blocks. The grid is (ceil(W / (16 kGroup)),
// ceil(H / (16 kGroup)), B x split) in clusters of (1, 1, split). CTA s
// takes the rows t = s (mod split) alone, so each row is read from L2 once
// per group, not once per block. A pass loads 256 of them, one a thread,
// straight into registers, culls each against the group (`row_may_cover`
// on the group's extent) and the survivors against each of its blocks,
// and copies the kept ones, compacted in index order, with the bits of the
// blocks they may cover, to shared memory. Each thread holds one pixel of
// each block and tests each of them against the kept rows that may cover
// its block, keeping a partial carry (z, id, three raw edge values) per
// pixel in registers. The mesh's index order is spatially local, so the
// strided split spreads a busy group's rows evenly over the CTAs. At the
// end each CTA writes its carries to shared memory; after one cluster
// barrier CTA s owns kGroup^2 256 / split pixels of the group, reads their
// split carries through distributed shared memory and keeps the one that
// wins (`wins`: the smaller z, on equal z the larger id). That rule is a
// total order on the carries, so the merge gives the single-thread loop's
// winner whatever the order, and its edge values travel with it: ids, bc,
// z and attributes depend on neither the split nor the group. A second
// cluster barrier keeps every CTA resident until the others have read its
// carries.
//
// Outputs (rasterize_pallas.py:1190-1196):
//   Uncovered pixels: id 0, bc 0, z 1, attributes 0.
//   bc_k = we_k * (1 / sum(we)); attr = a_0*bc_0 + a_1*bc_1 + a_2*bc_2.

#pragma once

#include <cooperative_groups.h>

#include <mutex>

#include "cluster.cuh"
#include "rasterize_common.cuh"

namespace {

constexpr int kMaxSplit = 8;  // the portable cluster size
// Rows a CTA culls per pass: one a thread.
constexpr int kPassRows = kThreads;
// A carry's float fields in shared memory: z, we0, we1, we2.
constexpr int kCarryFloats = 4;

// The pixel-centre extent of pixel columns [x0, x0 + n) and rows
// [y0, y0 + n), clipped to the image, for the cull.
struct Extent {
  float px_lo, px_hi, py_lo, py_hi;
};

__device__ __forceinline__ Extent extent(int x0, int y0, int n, int width,
                                         int height, int row_offset,
                                         float scale_x, float scale_y) {
  return Extent{pixel_ndc(x0, scale_x),
                pixel_ndc(min(x0 + n, width) - 1, scale_x),
                pixel_ndc(y0 + row_offset, scale_y),
                pixel_ndc(min(y0 + n, height) - 1 + row_offset, scale_y)};
}

__device__ __forceinline__ bool row_may_cover(const float4* row,
                                              const Extent& e) {
  return row_may_cover(row, e.px_lo, e.px_hi, e.py_lo, e.py_hi);
}

// Pixels of a group of kGroup x kGroup blocks: the merge splits them
// evenly over the cluster's CTAs.
template <int kGroup>
__host__ __device__ constexpr int group_pixels() {
  return kGroup * kGroup * kThreads;
}

// One CTA of the cluster: the carry stage. Each pixel's winner over the
// image's rows (z, id, three raw edge values; z 1 and id -1 where none
// wins) is handed to `epilogue(b, x, y, winner)` by the CTA that owns the
// pixel, once for each pixel of the image; the epilogue writes the
// caller's outputs (K1/K3: `rasterize_cluster`; S2's prod: mxu_full.cu).
template <int kGroup, typename Epilogue>
__device__ __forceinline__ void cluster_winners(
    const float4* __restrict__ tri_rows,  // [B, T, 16]
    int num_tris, int width, int height, int row_offset, float scale_x,
    float scale_y, Epilogue epilogue) {
  namespace cg = cooperative_groups;
  constexpr int kSide = kGroup * kBlockX;  // the group's pixel side
  constexpr int kPix = kGroup * kGroup;    // pixels a thread holds
  constexpr int kGroupPixels = group_pixels<kGroup>();
  constexpr int kWarps = kThreads / 32;

  __shared__ float4 s_rows[kPassRows * kRowFloat4s];  // the pass's kept rows
  __shared__ int s_ids[kPassRows];                      // and their ids
  __shared__ int s_blocks[kPassRows];  // the blocks each may cover (bits)
  __shared__ int warp_kept[kWarps];
  __shared__ float s_carry[kCarryFloats][kGroupPixels];
  __shared__ int s_carry_id[kGroupPixels];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z / split;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gx0 = blockIdx.x * kSide;
  const int gy0 = blockIdx.y * kSide;

  // The group's extent for the coarse cull; each block's for the fine one
  // (a block wholly outside the image is never covered), and this thread's
  // pixel centre in each block (NDC; row 0 is the bottom of the full
  // image).
  const Extent group = extent(gx0, gy0, kSide, width, height, row_offset,
                              scale_x, scale_y);
  Extent blocks[kPix];
  float px[kPix], py[kPix];
  int present = 0;  // bit q: block q has a pixel in the image
  int in_image = 0;  // bit q: this thread's pixel of block q is
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int bx0 = gx0 + (q % kGroup) * kBlockX;
    const int by0 = gy0 + (q / kGroup) * kBlockY;
    blocks[q] = extent(bx0, by0, kBlockX, width, height, row_offset,
                       scale_x, scale_y);
    if (bx0 < width && by0 < height) present |= 1 << q;
    const int x = bx0 + threadIdx.x;
    const int y = by0 + threadIdx.y;
    if (x < width && y < height) in_image |= 1 << q;
    px[q] = pixel_ndc(x, scale_x);
    py[q] = pixel_ndc(y + row_offset, scale_y);
  }

  const float4* rows_b =
      tri_rows + static_cast<size_t>(b) * num_tris * kRowFloat4s;
  // This CTA's rows are t = rank + split i for i < n_mine.
  const int n_mine = num_tris > rank ? (num_tris - rank + split - 1) / split
                                     : 0;

  Winner best[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) best[q] = Winner{1.0f, -1, 0.0f, 0.0f, 0.0f};
  for (int i0 = 0; i0 < n_mine; i0 += kPassRows) {
    const int t = rank + split * (i0 + tid);
    float4 row[kRowFloat4s];
    int covers = 0;  // bit q: the row may cover a pixel of block q
    if (i0 + tid < n_mine) {
      const float4* src = rows_b + static_cast<size_t>(t) * kRowFloat4s;
#pragma unroll
      for (int k = 0; k < kRowFloat4s; ++k) row[k] = __ldg(src + k);
      if (row_may_cover(row, group)) {
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          if (((present >> q) & 1) && row_may_cover(row, blocks[q])) {
            covers |= 1 << q;
          }
        }
      }
    }
    const bool keep = covers != 0;
    const unsigned kept_mask = __ballot_sync(0xffffffffu, keep);
    __syncthreads();  // the previous pass's kept rows have been consumed
    if (lane == 0) warp_kept[warp] = __popc(kept_mask);
    __syncthreads();
    int n_kept = 0;
    int slot = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) slot += warp_kept[w];
      n_kept += warp_kept[w];
    }
    if (keep) {
      slot += __popc(kept_mask & ((1u << lane) - 1u));
#pragma unroll
      for (int k = 0; k < kRowFloat4s; ++k) {
        s_rows[slot * kRowFloat4s + k] = row[k];
      }
      s_ids[slot] = t;
      s_blocks[slot] = covers;
    }
    __syncthreads();
    if (in_image == 0) continue;
    for (int k = 0; k < n_kept; ++k) {
      const int live = s_blocks[k] & in_image;
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        if ((live >> q) & 1) {
          consider_row(&s_rows[k * kRowFloat4s], px[q], py[q], s_ids[k],
                       best[q]);
        }
      }
    }
  }

  // Merge: each CTA's carries into shared memory (pixel p = q 256 + tid of
  // the group); CTA `rank` owns pixels [rank * owned, (rank + 1) * owned).
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int p = q * kThreads + tid;
    s_carry[0][p] = best[q].z;
    s_carry[1][p] = best[q].we0;
    s_carry[2][p] = best[q].we1;
    s_carry[3][p] = best[q].we2;
    s_carry_id[p] = best[q].id;
  }
  cluster.sync();  // every CTA's carries are in place
  const int owned = kGroupPixels / split;
  Winner win[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    win[j] = Winner{1.0f, -1, 0.0f, 0.0f, 0.0f};
    const int own = tid + j * kThreads;
    if (own >= owned) continue;
    const int p = rank * owned + own;
    for (int r = 0; r < split; ++r) {
      const float* c = cluster.map_shared_rank(&s_carry[0][0], r);
      const Winner other{c[p], cluster.map_shared_rank(s_carry_id, r)[p],
                         c[kGroupPixels + p], c[2 * kGroupPixels + p],
                         c[3 * kGroupPixels + p]};
      if (wins(other, win[j])) win[j] = other;
    }
  }
  cluster_arrive();  // this CTA's remote reads are done

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int own = tid + j * kThreads;
    const int p = rank * owned + own;
    const int q = p / kThreads;
    const int xo = gx0 + (q % kGroup) * kBlockX + p % kBlockX;
    const int yo = gy0 + (q / kGroup) * kBlockY + (p % kThreads) / kBlockX;
    if (own >= owned || xo >= width || yo >= height) continue;
    epilogue(b, xo, yo, win[j]);
  }
  cluster_wait();  // the other CTAs have read this one's carries
}

// K1 and K3: the cluster body whose epilogue writes ids, barycentrics, z
// and (kWithAttrs) attributes. `corner_attrs` and `attrs` are read and
// written only when kWithAttrs; `z_out` may be null.
template <int kGroup, bool kWithAttrs>
__device__ __forceinline__ void rasterize_cluster(
    const float4* __restrict__ tri_rows,      // [B, T, 16]
    const float* __restrict__ corner_attrs,   // [B, T, 3, A]
    int* __restrict__ ids,                    // [B, H, W]
    float* __restrict__ bc,                   // [B, H, W, 3]
    float* __restrict__ z_out,                // [B, H, W] or null
    float* __restrict__ attrs,                // [B, H, W, A]
    int num_tris, int num_attrs, int width, int height, int row_offset,
    float scale_x, float scale_y) {
  cluster_winners<kGroup>(
      tri_rows, num_tris, width, height, row_offset, scale_x, scale_y,
      [&](int b, int xo, int yo, const Winner& w) {
        const size_t pixel =
            (static_cast<size_t>(b) * height + yo) * static_cast<size_t>(width) +
            xo;
        const float sum_e = w.we0 + w.we1 + w.we2;
        const float inv_sum = 1.0f / (sum_e != 0.0f ? sum_e : 1.0f);
        const float b0 = w.we0 * inv_sum;
        const float b1 = w.we1 * inv_sum;
        const float b2 = w.we2 * inv_sum;
        ids[pixel] = w.id > 0 ? w.id : 0;
        bc[pixel * 3 + 0] = b0;
        bc[pixel * 3 + 1] = b1;
        bc[pixel * 3 + 2] = b2;
        if (z_out != nullptr) z_out[pixel] = w.z;
        if constexpr (kWithAttrs) {
          float* out = attrs + pixel * num_attrs;
          if (w.id < 0) {
            for (int a = 0; a < num_attrs; ++a) out[a] = 0.0f;
          } else {
            const float* corner = corner_attrs +
                (static_cast<size_t>(b) * num_tris + w.id) * 3 * num_attrs;
            for (int a = 0; a < num_attrs; ++a) {
              out[a] = corner[a] * b0 + corner[num_attrs + a] * b1 +
                       corner[2 * num_attrs + a] * b2;
            }
          }
        }
      });
}

// Launches `kernel` (an instance of the body at kGroup) in clusters of
// `split` CTAs per group of pixel blocks on `stream`, with its arguments;
// returns the launch's CUDA error (0 on success). A split the body does not
// take (0, above kMaxSplit, not dividing the group's pixels) or a grid
// deeper than 65,535 returns cudaErrorInvalidConfiguration.
template <int kGroup, typename Kernel, typename... Args>
int launch_group(Kernel kernel, int batch, int width, int height, int split,
                 void* stream, Args... args) {
  constexpr int kSide = kGroup * kBlockX;
  if (split < 1 || split > kMaxSplit || group_pixels<kGroup>() % split != 0 ||
      static_cast<long long>(batch) * split > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return launch_cluster(
      kernel,
      dim3((width + kSide - 1) / kSide, (height + kSide - 1) / kSide,
           batch * split),
      dim3(kBlockX, kBlockY), 0, split, stream, args...);
}

// A card's SMs and resident CTA slots for a launcher's group-1 kernel
// (SMs x CTAs per SM), queried once per process and device; `error` is the
// query's CUDA error.
struct Card {
  int sms = 0;
  int slots = 0;
  cudaError_t error = cudaSuccess;
};

constexpr int kMaxDevices = 64;

// The current device's Card for `group_one` (the launcher's kernel at
// group 1), or the error of finding the device. The cache is per kernel
// type: each translation unit that calls it asks for one kernel.
template <typename Kernel>
cudaError_t current_card(Kernel group_one, const Card** out) {
  static Card cards[kMaxDevices];
  static std::once_flag queried[kMaxDevices];
  int device = 0;
  const cudaError_t error = cudaGetDevice(&device);
  if (error != cudaSuccess) return error;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Card& c = cards[device];
  std::call_once(queried[device], [&c, device, group_one] {
    int per_sm = 0;
    c.error = cudaDeviceGetAttribute(
        &c.sms, cudaDevAttrMultiProcessorCount, device);
    if (c.error == cudaSuccess) {
      c.error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, group_one, kThreads, 0);
    }
    c.slots = c.sms * per_sm;
  });
  *out = &c;
  return c.error;
}

// Rows a launch of single-block clusters may stream per SM (pixel blocks
// x triangles / SMs) before groups of 2x2 blocks, which read each row
// once per group, pay for their four pixels a thread.
constexpr long long kGroupOneRowsPerSm = 32768;

// K3's launch rule, which S2's prod takes too: the group and split
// for `batch` images of width x height and `num_tris` rows, launched as
// `group_one` at group 1. The group: 1 while the launch's row stream stays
// under kGroupOneRowsPerSm per SM, else 2. The split: the most CTAs (8, 4
// or 2) per cluster whose launch fits in four waves of the card's resident
// CTA slots, else 2. A batch too deep for the grid at that split takes a
// smaller one. Chosen from the device times of every group and split on
// the teapot (2,464 rows) and sphere72 (10,368) at one 256x256 / 512x512
// image and four on the H100 (PERF.md); returns the card query's CUDA
// error.
template <typename Kernel>
int choose_launch(Kernel group_one, int batch, int num_tris, int width,
                  int height, int* group, int* split) {
  const Card* card = nullptr;
  const cudaError_t error = current_card(group_one, &card);
  if (error != cudaSuccess) return static_cast<int>(error);
  const Card& c = *card;
  const long long blocks = static_cast<long long>(batch) *
                           ((width + kBlockX - 1) / kBlockX) *
                           ((height + kBlockY - 1) / kBlockY);
  *group = blocks * num_tris <= kGroupOneRowsPerSm * c.sms ? 1 : 2;
  const long long groups = static_cast<long long>(batch) *
                           ((width + kBlockX * *group - 1) /
                            (kBlockX * *group)) *
                           ((height + kBlockY * *group - 1) /
                            (kBlockY * *group));
  *split = 2;
  for (int s = kMaxSplit; s > 2; s /= 2) {
    if (groups * s <= 4LL * c.slots) {
      *split = s;
      break;
    }
  }
  while (*split > 1 && static_cast<long long>(batch) * *split > 65535) {
    *split /= 2;
  }
  return 0;
}

}  // namespace
