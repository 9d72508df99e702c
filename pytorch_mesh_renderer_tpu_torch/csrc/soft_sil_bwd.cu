// Silhouette-only SoftRas analytic backward, for Hopper.
//
// Replaces the TPU kernel K6 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/soft_rasterize_pallas.py
//   `_bwd_kernel_sil` (:881-948), launched by `_run_backward_sil` (:1034).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/soft_rasterize_cuda.py
//   `soft_silhouette_backward_torch_packed`.
//
// Alpha touches the table only through coverage = sigmoid(sgn d^2 / sigma)
// gated by validity, so only the six edge-endpoint columns (9-14) and
// sigma take a gradient: per valid pair dsq = sgn / sigma * dA * sil * cov
// (d alpha / d cov = prod_{j != c}(1 - cov_j), whose (1 - cov) cancels
// against the sigmoid's derivative), the squared-distance chain of the
// nearest edge, split evenly among the edges of an exact tie
// (edge_gradients without the offset-t chain) and
// dsigma = -dsq * d^2 / sigma.
//
// What bounds it: the busy pixel blocks' pairs, as in K8 (soft_bwd.cu).
// On the 256x256 batch-4 teapot 208 of the 1,024 pixel blocks hold a
// valid pair and the busiest stages 191 triangles; at the cow fit's shape
// (128x128, 4 views, 1,152 triangles) 144 of 256 blocks are busy and the
// busiest stages 70. One CTA per block ran them in sequence on its 8
// warps, each (warp, triangle) a latency-bound chain (the geometry phase,
// 7 warp sums, up to 7 atomics from lane 0).
//
// The work split is K8's (soft_split.cuh). The grid is (ceil(W / 16),
// ceil(H / 16), B x kSplit): CTA s of a pixel block stages only the rows
// t = s (mod kSplit), 256 rows a pass; a CTA that stages a row reads the
// block's residuals (sil = 1 - alpha and the cotangent) into shared memory
// once, and one that stages none leaves. Its (staged triangle, row pair)
// items are cut into one equal run per warp, one pixel per lane; a pair in
// which no lane is valid is skipped (one ballot). A lane keeps columns
// 9-14 and dsigma in registers; at the end of a triangle's items in the
// run one butterfly reduce-scatter (9 shuffles) leaves column
// (l >> 2) & 7 with lane l, and lanes 0, 4, ..., 20 hold the six columns.
// With no light loop and 6 columns the pair chain is short, so three CTAs
// share an SM (the slab of staged rows, 224 of them here, allows no
// more). Every
// per-pair value keeps the plain version's operation order
// (--fmad=false).
//
// The sums are taken in a fixed order, with no atomic, so two calls on the
// same inputs give the same bits (the silhouette fits repeat). A row's
// items are one contiguous range and the warps' runs contiguous equal
// ranges in warp order, so only the first and the last row of a run can
// be shared with another warp. A row inside a run writes its six sums to
// its slot of a scratch buffer of partials, one slot per (image, kept
// row, pixel block), [B, rows, blocks, 6]; the two boundary rows of each
// warp go to 16 shared slots, which the CTA adds in warp order (a row
// longer than a run is the sum of every run that touches it), and a kept
// row with no item gets a zero slot. So every row that a block keeps has
// its slot written once, by one CTA. The boundary slots are double
// buffered by pass: a pass's are added after a barrier the CTA passes
// anyway (the next pass's cull, or the end's dsigma sum), 48 threads at
// once, one (shared row, column) each, each a chain of one or two adds,
// so the adds put no barrier and no long chain on the CTA's path.
// dsigma: each CTA writes its warps' sums, added in warp order, to its
// own slot.
//
// A second kernel, soft_sil_bwd_reduce_kernel, gives one warp to each
// row: its lanes test the pixel blocks around the row's bbox with the
// cull K6 stages by (`block_keeps` at `block_extent_at`), so they read
// exactly the slots that K6 wrote (the buffer needs no zero fill), add
// them in block order per lane and then over the warp as a fixed tree,
// and write columns 9-14 of the table gradient; its last CTA per image
// adds the image's CTA dsigma slots as a fixed tree. The partials take 24
// bytes per (image, row, block): 60 MB at the 256x256 batch-4 teapot
// (2,464 rows, 256 blocks). Past kScratchFloats the launcher runs the
// rows in chunks, each chunk its own K6 and reduce launch over the same
// scratch, so the scratch stays bounded at any size.

#include <algorithm>

#include "soft_split.cuh"

namespace {

// CTAs per pixel block; each stages the rows of one residue mod kSplit.
// Chosen from the device times at 4, 8 and 16 on the H100 (PERF.md).
constexpr int kSplit = 4;
// Columns 9-14 padded to 8 for the butterfly.
constexpr int kEdgeCols = 6;
constexpr int kPaddedCols = 8;
// Boundary slots of a pass: a warp's first and last row.
constexpr int kBoundary = 2 * kWarps;
// Rows a CTA stages a pass (K8 stages kStageRows = 256). Three CTAs share
// an SM either way; with 224 the three need 180 KB of shared memory, not
// the 197 KB that 256 rows and the boundary slots would take, which is
// past the 196 KB carveout and would leave the SM 28 KB of L1, not 60.
constexpr int kSilStageRows = 224;
constexpr int kSilSlabBytes = kSilStageRows * kCols * sizeof(float);
// Threads of a reduce CTA: a warp per table row.
constexpr int kReduceThreads = 256;
constexpr int kReduceWarps = kReduceThreads / 32;
// The partials of one launch are at most this many floats (256 MB); more
// rows run in chunks.
constexpr long long kScratchFloats = 1ll << 26;

// The slot of (image b, row t of a chunk of `rows`, pixel block) in the
// partials.
__device__ __forceinline__ size_t partial_slot(int b, int rows, int t,
                                               int block, int n_blocks) {
  return ((static_cast<size_t>(b) * rows + t) * n_blocks + block) *
         kEdgeCols;
}

// Adds a pass's boundary slots (one buffer), one (warp, column) a thread
// for tid < kWarps x kEdgeCols. A warp's second slot holds a row that
// begins in its run and goes on into the next warps', and its first slot
// a row that began before its run, so a shared row has exactly one
// second slot, its first part, and the first slots of the warps after it
// (unused slots between): that thread sums them in warp order and writes
// the row's partial.
__device__ __forceinline__ void add_boundary_rows(
    const int (&rows)[kBoundary], const float (&vals)[kBoundary][kEdgeCols],
    float* partials, int b, int row_begin, int row_count, int block,
    int n_blocks) {
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  if (tid >= kWarps * kEdgeCols) return;
  const int e = 2 * (tid / kEdgeCols) + 1;
  const int col = tid % kEdgeCols;
  const int row = rows[e];
  if (row < 0) return;
  float sum = vals[e][col];
  for (int f = e + 1; f < kBoundary; ++f) {
    if (rows[f] < 0) continue;
    if (rows[f] != row) break;
    sum += vals[f][col];
  }
  partials[partial_slot(b, row_count, row - row_begin, block, n_blocks) +
           col] = sum;
}

__global__ void __launch_bounds__(kSoftThreads, 3) soft_sil_bwd_kernel(
    const float* __restrict__ table,    // [B, T, 59]
    const float* __restrict__ params,   // sigma, gamma, blur^2, row offset
    const float* __restrict__ alpha,    // [B, H, W] forward output
    const float* __restrict__ d_alpha,  // [B, H, W] cotangent
    float* __restrict__ partials,       // [B, row_count, blocks, 6]
    float* __restrict__ dsigma_parts,   // [B x split, blocks]
    int num_tris, int row_begin, int row_count, int width, int height,
    int full_height, int split) {
  extern __shared__ float slab[];  // kSilStageRows x kCols
  __shared__ SplitShared sh;
  // Per-pixel residuals of the block: sil = 1 - alpha and the cotangent.
  // Neutral outside the image.
  __shared__ float s_sil[kSoftThreads];
  __shared__ float s_da[kSoftThreads];
  // Each warp's first and last row of a pass where another warp shares it
  // (its table row; -1: none), with the warp's six sums for it; two
  // buffers, by the parity of the CTA's passes that staged rows.
  __shared__ int s_bnd_row[2][kBoundary];
  __shared__ float s_bnd_val[2][kBoundary][kEdgeCols];
  __shared__ float s_dsig[kWarps];

  const int b = blockIdx.z / split;
  const int part = blockIdx.z - b * split;
  const int tid = threadIdx.y * kSoftBlockX + threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int x0 = blockIdx.x * kSoftBlockX;
  const int y0 = blockIdx.y * kSoftBlockY;
  const int n_blocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const int row_end = row_begin + row_count;
  const SoftParams p = load_params(params);
  const BlockExtent extent = block_extent(width, height, p.row_off,
                                          full_height);
  const float* rows_b = table + static_cast<size_t>(b) * num_tris * kCols;
  float* dsigma_part =
      dsigma_parts + static_cast<size_t>(blockIdx.z) * n_blocks + block;

  // This lane's pixel column, and which row of a pair it takes.
  const int x = x0 + lane % kSoftBlockX;
  const float px = pixel_x(x, width);
  const int pair_row = lane / kSoftBlockX;
  const int rows_here = min(kSoftBlockY, height - y0);
  // After the butterfly, lane l holds the warp's sum of column c.
  const int c = (lane >> 2) & 7;
  const bool col_writer = (lane & 3) == 0 && c < kEdgeCols;

  float dsig = 0.0f;  // this lane's sum over its pairs
  bool residuals_staged = false;
  int passes = 0;  // passes that staged rows
  for (int t0 = row_begin + part; t0 < row_end;
       t0 += kSilStageRows * split) {
    const int n_kept = stage_rows<kSilStageRows>(
        rows_b, t0, min(kSilStageRows, (row_end - t0 + split - 1) / split),
        split, extent,
        slab, sh.kept_ids, sh.warp_kept);
    if (n_kept > 0 && !residuals_staged) {  // uniform over the block
      stage_residuals(b, width, height, p.row_off, full_height, sh,
                      [&](int t, long long pixel) {
        s_sil[t] = pixel >= 0 ? 1.0f - alpha[pixel] : 1.0f;
        s_da[t] = pixel >= 0 ? d_alpha[pixel] : 0.0f;
      });
      residuals_staged = true;
    }
    if (n_kept == 0) continue;  // uniform over the block
    const int buf = passes & 1;
    // The previous staged pass's boundary rows (written before the
    // barriers of stage_rows); this pass's buffer was added a pass ago.
    if (passes > 0) {
      add_boundary_rows(s_bnd_row[buf ^ 1], s_bnd_val[buf ^ 1], partials, b,
                        row_begin, row_count, block, n_blocks);
    }
    if (tid < kBoundary) s_bnd_row[buf][tid] = -1;  // scan_row_pairs syncs
    ++passes;

    const int n_items = scan_row_pairs(slab, n_kept, rows_here, sh);
    // A kept row with no item (its bbox falls between two pixel rows of
    // a pair) still owns a slot: zero.
    if (tid < n_kept) {
      const int end = tid + 1 < n_kept ? sh.start[tid + 1] : n_items;
      if (end == sh.start[tid]) {
        float* slot = partials + partial_slot(
            b, row_count, t0 + sh.kept_ids[tid] - row_begin, block,
            n_blocks);
#pragma unroll
        for (int col = 0; col < kEdgeCols; ++col) slot[col] = 0.0f;
      }
    }
    const WarpRun run = warp_run(n_items, n_kept, sh);
    int k = run.k;
    float acc[kCols];  // this lane's column gradients of row k (9-14)
#pragma unroll
    for (int col = 9; col < 9 + kEdgeCols; ++col) acc[col] = 0.0f;
    bool any_valid = false;  // uniform over the warp
    for (int i = run.i0; i < run.i1; ++i) {  // uniform over the warp
      const float* r = slab + k * kCols;
      const int row0 = item_row0(sh, k, i);
      const float py = sh.py[row0 + pair_row];
      SoftGeometry g;
      g.valid = false;
      if (x < width && row0 + pair_row < rows_here) {
        g = soft_geometry(r, px, py, p.sigma, p.sq_blur);
      }
      if (__any_sync(kFullMask, g.valid)) {
        any_valid = true;
        if (g.valid) {
          const int pix = row0 * kSoftBlockX + lane;
          const float dsq =
              (g.sgn / p.sigma) * s_da[pix] * s_sil[pix] * g.coverage;
          edge_gradients<false>(r, g, px, py, dsq, nullptr, acc);
          dsig += -dsq * g.sq_dist / p.sigma;
        }
      }

      // Row k's last item of this run: its 6 columns, summed over the
      // warp once, go to its slot, or to a boundary slot where another
      // warp shares the row; then on to the next row with items.
      if (!row_ends(sh, k, i, run.i1, n_kept)) continue;
      float t[kPaddedCols];
#pragma unroll
      for (int col = 0; col < kPaddedCols; ++col) {
        t[col] = col < kEdgeCols ? acc[9 + col] : 0.0f;
      }
      if (any_valid) {  // else every sum is 0
        reduce_scatter<kPaddedCols / 2, 16>(t, lane);
        t[0] += __shfl_xor_sync(kFullMask, t[0], 2);
        t[0] += __shfl_xor_sync(kFullMask, t[0], 1);
      }
      const int begin = sh.start[k];
      const int end = k + 1 < n_kept ? sh.start[k + 1] : n_items;
      const int row = t0 + sh.kept_ids[k];
      if (begin >= run.i0 && end <= run.i1) {  // this warp's alone
        if (col_writer) {
          partials[partial_slot(b, row_count, row - row_begin, block,
                                n_blocks) + c] = t[0];
        }
      } else {
        const int e = 2 * warp + (begin < run.i0 ? 0 : 1);
        if (col_writer) s_bnd_val[buf][e][c] = t[0];
        if (lane == 0) s_bnd_row[buf][e] = row;
      }
#pragma unroll
      for (int col = 9; col < 9 + kEdgeCols; ++col) acc[col] = 0.0f;
      any_valid = false;
      k = next_row(sh, k, i, n_kept);
    }
  }
  // Most CTAs stage no row: their dsigma is 0.
  if (!residuals_staged) {  // uniform over the block
    if (tid == 0) *dsigma_part = 0.0f;
    return;
  }
  const float sig_total = warp_sum(dsig);
  if (lane == 0) s_dsig[warp] = sig_total;
  __syncthreads();
  if (passes > 0) {  // the last staged pass's boundary rows
    const int buf = (passes - 1) & 1;
    add_boundary_rows(s_bnd_row[buf], s_bnd_val[buf], partials, b,
                      row_begin, row_count, block, n_blocks);
  }
  if (tid == 0) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum += s_dsig[w];
    *dsigma_part = sum;
  }
}

// The first pixel block along an axis of n blocks whose pixel index is
// at most `pixel`, clamped to [-1, n] (a bbox may lie far off the image).
__device__ __forceinline__ int block_floor(float pixel, int n) {
  const float blocks = pixel / static_cast<float>(kSoftBlockX);
  return static_cast<int>(
      floorf(fminf(fmaxf(blocks, -1.0f), static_cast<float>(n))));
}

// One warp per row t of a chunk of image b (grid (ceil(rows /
// kReduceWarps) + 1, B)): the sum of its partials over the pixel blocks
// that keep it, in block order (rows of blocks, then columns) per lane
// and then over the lanes as a fixed tree, into columns 9-14 of dtable.
// A block keeps the row as K6's cull decides (block_keeps at
// block_extent_at), which is where K6 wrote the row's slots; the blocks
// tested are those within one block of the pixels at the row's bbox
// bounds, which hold every block that keeps it (the pixel index of an NDC
// bound is off by far less than a block). With `dsigma` given, the last
// CTA of an image adds its dsigma parts over the `n_chunks` launches,
// [chunk][B x split][blocks], as a fixed tree.
__global__ void __launch_bounds__(kReduceThreads) soft_sil_bwd_reduce_kernel(
    const float* __restrict__ table, const float* __restrict__ params,
    const float* __restrict__ partials,
    const float* __restrict__ dsigma_parts, float* __restrict__ dtable,
    float* __restrict__ dsigma, int num_tris, int row_begin, int row_count,
    int n_chunks, int width, int height, int full_height, int split) {
  const int b = blockIdx.y;
  const int nbx = (width + kSoftBlockX - 1) / kSoftBlockX;
  const int nby = (height + kSoftBlockY - 1) / kSoftBlockY;
  const int n_blocks = nbx * nby;
  if (blockIdx.x == gridDim.x - 1 && dsigma != nullptr) {
    __shared__ float s_sum[kReduceThreads];
    const int per_chunk = split * n_blocks;
    float sum = 0.0f;
    for (int i = threadIdx.x; i < n_chunks * per_chunk;
         i += kReduceThreads) {
      const int chunk = i / per_chunk;
      sum += dsigma_parts[(static_cast<size_t>(chunk) * gridDim.y + b) *
                              per_chunk + (i - chunk * per_chunk)];
    }
    s_sum[threadIdx.x] = sum;
    __syncthreads();
    for (int half = kReduceThreads / 2; half > 0; half /= 2) {
      if (threadIdx.x < half) s_sum[threadIdx.x] += s_sum[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) dsigma[b] = s_sum[0];
    return;
  }
  const int lane = threadIdx.x % 32;
  const int local = blockIdx.x * kReduceWarps + threadIdx.x / 32;
  if (local >= row_count) return;  // uniform over the warp
  const int t = row_begin + local;
  const float* r = table + (static_cast<size_t>(b) * num_tris + t) * kCols;
  if (!(r[21] > 0.0f)) return;  // kept by no block
  const SoftParams p = load_params(params);
  // Pixel column of NDC x: px = 2 (x + 0.5) / W - 1; pixel row of NDC y:
  // py = -2 (y + row_off + 0.5) / full_height + 1.
  const float half_w = 0.5f * static_cast<float>(width);
  const float half_h = 0.5f * static_cast<float>(full_height);
  const int bx_lo = max(block_floor((r[22] + 1.0f) * half_w - 0.5f, nbx) - 1,
                        0);
  const int bx_hi = min(block_floor((r[23] + 1.0f) * half_w - 0.5f, nbx) + 1,
                        nbx - 1);
  const int by_lo = max(
      block_floor((1.0f - r[25]) * half_h - 0.5f - p.row_off, nby) - 1, 0);
  const int by_hi = min(
      block_floor((1.0f - r[24]) * half_h - 0.5f - p.row_off, nby) + 1,
      nby - 1);
  const int nx = bx_hi - bx_lo + 1;
  const int n_candidates = nx * max(by_hi - by_lo + 1, 0);
  float sums[kPaddedCols] = {};
  const float* row_parts = partials + partial_slot(b, row_count, local, 0,
                                                   n_blocks);
  for (int i = lane; i < n_candidates; i += 32) {
    const int by = by_lo + i / nx;
    const int bx = bx_lo + i % nx;
    if (!block_keeps(r, block_extent_at(bx, by, width, height, p.row_off,
                                        full_height))) {
      continue;
    }
    const float* slot = row_parts + (by * nbx + bx) * kEdgeCols;
#pragma unroll
    for (int col = 0; col < kEdgeCols; ++col) sums[col] += slot[col];
  }
  // Lane l keeps column (l >> 2) & 7, summed over the warp.
  reduce_scatter<kPaddedCols / 2, 16>(sums, lane);
  sums[0] += __shfl_xor_sync(kFullMask, sums[0], 2);
  sums[0] += __shfl_xor_sync(kFullMask, sums[0], 1);
  const int col = (lane >> 2) & 7;
  if ((lane & 3) == 0 && col < kEdgeCols) {
    dtable[(static_cast<size_t>(b) * num_tris + t) * kCols + 9 + col] =
        sums[0];
  }
}

// Floats of scratch that one chunk of `rows` rows takes, with every
// chunk's CTA dsigma parts after it.
long long scratch_of(int batch, int num_tris, int n_blocks, int split,
                     long long rows) {
  const long long chunks =
      num_tris > 0 ? (num_tris + rows - 1) / rows : 1;
  return static_cast<long long>(batch) * n_blocks *
         (rows * kEdgeCols + chunks * split);
}

// Rows of one launch: all, or as many as keep scratch_of within
// `scratch_floats` (a fixed point from above: the chunks' dsigma parts
// grow as the rows shrink); 0 if not one row fits.
int chunk_rows(int batch, int num_tris, int n_blocks, int split,
               long long scratch_floats) {
  const long long per_row = static_cast<long long>(batch) * n_blocks *
                            kEdgeCols;
  long long rows = std::max(num_tris, 1);
  while (rows > 0 &&
         scratch_of(batch, num_tris, n_blocks, split, rows) > scratch_floats) {
    const long long parts =
        scratch_of(batch, num_tris, n_blocks, split, rows) - rows * per_row;
    rows = std::min(rows - 1, (scratch_floats - parts) / per_row);
  }
  return static_cast<int>(std::max(rows, 0ll));
}

}  // namespace

// Floats of scratch that soft_sil_bwd takes at these sizes and split (0:
// kSplit): all rows in one launch, or in chunks whose partials stay
// within kScratchFloats.
extern "C" long long soft_sil_bwd_scratch_floats(int batch, int num_tris,
                                                 int width, int height,
                                                 int split) {
  if (split == 0) split = kSplit;
  const int n_blocks = ((width + kSoftBlockX - 1) / kSoftBlockX) *
                       ((height + kSoftBlockY - 1) / kSoftBlockY);
  const long long per_row = static_cast<long long>(batch) * n_blocks *
                            kEdgeCols;
  const long long rows = std::max(
      1ll, std::min(per_row > 0 ? kScratchFloats / per_row : num_tris,
                    static_cast<long long>(num_tris)));
  return scratch_of(batch, num_tris, n_blocks, split, rows);
}

// Launches the kernel and its reduce pass on `stream` (once per chunk of
// rows) and returns cudaGetLastError() (0 on success). Pointers are
// device pointers to contiguous tensors; dtable is zeroed (the kernels
// write columns 9-14 of the rows some block keeps), dsigma [B] is
// written, `scratch` holds `scratch_floats` floats and needs no fill: the
// rows run in as few chunks as it holds (soft_sil_bwd_scratch_floats:
// one, up to kScratchFloats of partials). The caller checks shapes and
// types. `split` is the CTAs per pixel block: 0 for kSplit, the kernel's
// own; other values serve only to measure that choice.
extern "C" int soft_sil_bwd(const void* table, const void* params,
                            const void* alpha, const void* d_alpha,
                            void* dtable, void* dsigma, void* scratch,
                            long long scratch_floats, int batch,
                            int num_tris, int width, int height,
                            int full_height, int split, void* stream) {
  if (split == 0) split = kSplit;
  if (split < 1 || static_cast<long long>(batch) * split > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t error = cudaFuncSetAttribute(
      soft_sil_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSilSlabBytes);
  if (error != cudaSuccess) return static_cast<int>(error);
  const int nbx = (width + kSoftBlockX - 1) / kSoftBlockX;
  const int nby = (height + kSoftBlockY - 1) / kSoftBlockY;
  const int rows = chunk_rows(batch, num_tris, nbx * nby, split,
                              scratch_floats);
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = num_tris > 0 ? (num_tris + rows - 1) / rows : 1;
  float* partials = static_cast<float*>(scratch);
  float* dsigma_parts = partials + static_cast<size_t>(batch) * rows * nbx *
                                       nby * kEdgeCols;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kSoftBlockX, kSoftBlockY);
  const dim3 grid(nbx, nby, batch * split);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int row_begin = chunk * rows;
    const int row_count = std::min(rows, num_tris - row_begin);
    soft_sil_bwd_kernel<<<grid, block, kSilSlabBytes, s>>>(
        static_cast<const float*>(table), static_cast<const float*>(params),
        static_cast<const float*>(alpha),
        static_cast<const float*>(d_alpha), partials,
        dsigma_parts + static_cast<size_t>(chunk) * batch * split * nbx * nby,
        num_tris, row_begin, std::max(row_count, 0), width, height,
        full_height, split);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
    const bool last = chunk == n_chunks - 1;
    const dim3 reduce_grid(
        (std::max(row_count, 0) + kReduceWarps - 1) / kReduceWarps +
            (last ? 1 : 0),
        batch);
    if (reduce_grid.x > 0) {
      soft_sil_bwd_reduce_kernel<<<reduce_grid, kReduceThreads, 0, s>>>(
          static_cast<const float*>(table),
          static_cast<const float*>(params), partials, dsigma_parts,
          static_cast<float*>(dtable),
          last ? static_cast<float*>(dsigma) : nullptr, num_tris, row_begin,
          std::max(row_count, 0), n_chunks, width, height, full_height,
          split);
    }
    const cudaError_t reduced = cudaGetLastError();
    if (reduced != cudaSuccess) return static_cast<int>(reduced);
  }
  return 0;
}

// Resident CTAs of soft_sil_bwd_kernel per SM at its block size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int soft_sil_bwd_blocks_per_sm() {
  cudaError_t error = cudaFuncSetAttribute(
      soft_sil_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSilSlabBytes);
  int blocks = 0;
  if (error == cudaSuccess) {
    error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, soft_sil_bwd_kernel, kSoftThreads, kSilSlabBytes);
  }
  return error == cudaSuccess ? blocks : -static_cast<int>(error);
}
