// The work split of the soft backward kernels K6 (soft_sil_bwd.cu) and K8
// (soft_bwd.cu): kSplit CTAs per 16x16 pixel block, CTA s staging the
// table rows t = s (mod kSplit) (`stage_rows`' row stride, kStageRows rows
// a pass), and inside a CTA the (staged triangle, 16x2 row pair its bbox
// rows touch) items cut into one equal run per warp, one pixel per lane.
// Both kernels call these pieces in the same order:
//
//   for each pass (split_pass_rows):
//     stage_rows; at the first staged row, stage_residuals;
//     scan_row_pairs; warp_run;
//     for each item i of the run: the pair chain, then at row_ends(...)
//     the warp's sums of row k go to the table, and next_row.
//
// What that buys and what bounds it is in each kernel's header.

#pragma once

#include "soft_common.cuh"

namespace {

constexpr int kWarps = kSoftThreads / 32;
// A warp's item covers 16x2 pixels: one row pair of the block.
constexpr int kRowPairs = kSoftBlockY / 2;
static_assert(kSoftBlockX == 16 && kSoftBlockY % 2 == 0,
              "a warp is one 16x2 row pair");
// Rows a CTA tests per pass: all 256 threads cull, so a CTA's share of a
// 2,464-row table (308 rows at kSplit 8) takes 2 passes, not 3. The slab
// of kept rows is dynamic shared memory: 60,416 bytes.
constexpr int kStageRows = kSoftThreads;
constexpr int kSlabBytes = kStageRows * kCols * sizeof(float);

// The split's bookkeeping in shared memory.
struct SplitShared {
  int kept_ids[kStageRows];  // stage_rows' kept rows, offsets from t0
  int warp_kept[kStageRows / 32];
  int start[kStageRows];  // each staged row's first item
  int first[kStageRows];  // and its first row pair
  int warp_items[kWarps];
  float py[kSoftBlockY];  // the block's pixel-row centres
};

// The rows that CTA `part` of `split` tests in the pass starting at t0:
// t0, t0 + split, ... (at most kStageRows).
__device__ __forceinline__ int split_pass_rows(int t0, int num_tris,
                                               int split) {
  return min(kStageRows, (num_tris - t0 + split - 1) / split);
}

// Once per CTA, at its first staged row: the block's pixel-row centres
// into sh.py and, through stage(tid, pixel), each thread's per-pixel
// residuals into the kernel's own shared arrays; `pixel` is the thread's
// index in the [B, H, W] images, or -1 outside the image. Ends with a
// block barrier.
template <class Stage>
__device__ __forceinline__ void stage_residuals(int b, int width, int height,
                                                float row_off,
                                                int full_height,
                                                SplitShared& sh,
                                                Stage stage) {
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int x0 = blockIdx.x * kSoftBlockX;
  const int y0 = blockIdx.y * kSoftBlockY;
  if (tid < kSoftBlockY) sh.py[tid] = pixel_y(y0 + tid, row_off, full_height);
  const int xr = x0 + tid % kSoftBlockX;
  const int yr = y0 + tid / kSoftBlockX;
  long long pixel = -1;
  if (xr < width && yr < height) {
    pixel = (static_cast<long long>(b) * height + yr) * width + xr;
  }
  stage(tid, pixel);
  __syncthreads();
}

// The CTA's work is every (staged triangle, row pair its bbox rows touch)
// item, in triangle order. Thread k counts row k's pairs (a contiguous
// range: py falls as the row grows); a scan gives each row its first item
// (sh.start) and first pair (sh.first). Returns the item count. Every
// thread calls it; it ends with a block barrier.
__device__ __forceinline__ int scan_row_pairs(const float* slab, int n_kept,
                                              int rows_here,
                                              SplitShared& sh) {
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  int n_pairs = 0, first_pair = 0;
  if (tid < n_kept) {
    const float* r = slab + tid * kCols;
    int last_pair = -1;
    first_pair = kRowPairs;
    for (int pair = 0; 2 * pair < rows_here; ++pair) {
      const float py_top = sh.py[2 * pair];
      const float py_bottom = sh.py[min(2 * pair + 1, rows_here - 1)];
      if (py_top >= r[24] && py_bottom <= r[25]) {
        first_pair = min(first_pair, pair);
        last_pair = pair;
      }
    }
    n_pairs = max(last_pair - first_pair + 1, 0);
  }
  int items_to = n_pairs;  // inclusive scan over the warp
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int v = __shfl_up_sync(kFullMask, items_to, offset);
    if (lane >= offset) items_to += v;
  }
  if (lane == 31) sh.warp_items[warp] = items_to;
  __syncthreads();
  int n_items = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) sh.start[tid] = n_items + items_to - n_pairs;
    n_items += sh.warp_items[w];
  }
  sh.first[tid] = first_pair;
  __syncthreads();
  return n_items;
}

// This warp's run of items, [i0, i1): one of kWarps equal runs, so a large
// triangle's row pairs spread over warps and a CTA with few triangles
// keeps its warps busy; k is the staged row of item i0.
struct WarpRun {
  int i0, i1, k;
};

__device__ __forceinline__ WarpRun warp_run(int n_items, int n_kept,
                                            const SplitShared& sh) {
  const int warp = (threadIdx.y * kSoftBlockX + threadIdx.x) / 32;
  WarpRun run{n_items * warp / kWarps, n_items * (warp + 1) / kWarps, 0};
  for (int lo = 1, hi = n_kept - 1; lo <= hi;) {  // the last row whose
    const int mid = (lo + hi) / 2;                // first item <= i0
    if (sh.start[mid] <= run.i0) {
      run.k = mid;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  return run;
}

// The row pair of item i of staged row k: its first pixel row.
__device__ __forceinline__ int item_row0(const SplitShared& sh, int k,
                                         int i) {
  return 2 * (sh.first[k] + i - sh.start[k]);
}

// Whether item i is row k's last in the run [.., i1): then the warp's sums
// of row k go to the table.
__device__ __forceinline__ bool row_ends(const SplitShared& sh, int k, int i,
                                         int i1, int n_kept) {
  return i + 1 >= i1 || (k + 1 < n_kept && sh.start[k + 1] <= i + 1);
}

// The staged row of item i + 1 (rows with no items are passed over).
__device__ __forceinline__ int next_row(const SplitShared& sh, int k, int i,
                                        int n_kept) {
  while (k + 1 < n_kept && sh.start[k + 1] <= i + 1) ++k;
  return k;
}

// Reduce-scatter of t[0, 2 kHalf) over the warp, one halving step per lane
// bit from kBit down: each step keeps half of the columns (the upper half
// where the lane's bit is set), adds the partner lane's copy of that half
// and sends it the other. <32, 16> leaves lane l the warp's totals of
// columns 2l and 2l + 1 in t[0] and t[1]; <4, 16> leaves it column
// (l >> 2) & 7 in t[0], summed over the 8 lanes that share bits 0-1.
template <int kHalf, int kBit>
__device__ __forceinline__ void reduce_scatter(float* t, int lane) {
  const bool upper = (lane & kBit) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? t[i] : t[i + kHalf];
    const float keep = upper ? t[i + kHalf] : t[i];
    t[i] = keep + __shfl_xor_sync(kFullMask, send, kBit);
  }
  if constexpr (kHalf > 1 && kBit > 1) {
    reduce_scatter<kHalf / 2, kBit / 2>(t, lane);
  }
}

}  // namespace
