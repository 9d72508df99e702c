// Barycentric-only forward hard rasterizer (the reference kernel's
// contract: ids, barycentrics, z), for Hopper.
//
// Replaces the TPU kernel K3 of the JAX package:
//   pytorch_mesh_renderer_tpu/ops/rasterize_pallas.py `_kernel` (:348-412),
//   launched by `_forward_from_packed` (:582).
// The plain PyTorch version it is held against is
//   pytorch_mesh_renderer_tpu_torch/ops/rasterize_barycentric_cuda.py
//   `rasterize_barycentric_torch`.
//
// It is K1 without the attribute columns: the same cluster body
// (rasterize_cluster_fwd.cuh), so its ids, bc and z equal K1's by
// construction, whatever group and split either launches with (the merge
// of partial winners is order-free). What bounds it is the body's: every
// pixel block must see every triangle row, and the busiest block's chain
// of per-pixel tests. Its caller, `rasterize_barycentric`, renders one
// image a launch: a 256x256 image is 256 pixel blocks, under two per SM of
// the H100's 132, so one CTA per block leaves the card idle and each
// block's stream of rows latency-bound. The launch is therefore sized to
// its own shape: the rule in `choose_launch` picks the group of blocks a
// cluster covers from the launch's row stream per SM and the number of
// CTAs that split its rows from its pixel blocks against the card's
// resident CTA slots (PERF.md has the times it was chosen from).

#include <mutex>

#include "rasterize_cluster_fwd.cuh"

namespace {

template <int kGroup>
__global__ void __launch_bounds__(kThreads) rasterize_bary_fwd_kernel(
    const float4* __restrict__ tri_rows,  // [B, T, 16]
    int* __restrict__ ids,                // [B, H, W]
    float* __restrict__ bc,               // [B, H, W, 3]
    float* __restrict__ z_out,            // [B, H, W]
    int num_tris, int width, int height, int row_offset, float scale_x,
    float scale_y) {
  rasterize_cluster<kGroup, false>(tri_rows, nullptr, ids, bc, z_out,
                                   nullptr, num_tris, 0, width, height,
                                   row_offset, scale_x, scale_y);
}

// A card's SMs and resident CTA slots for the group-1 body (SMs x CTAs
// per SM), queried once per process and device; `error` is the query's
// CUDA error.
struct Card {
  int sms = 0;
  int slots = 0;
  cudaError_t error = cudaSuccess;
};

constexpr int kMaxDevices = 64;

// The current device's Card, or the error of finding the device.
cudaError_t current_card(const Card** out) {
  static Card cards[kMaxDevices];
  static std::once_flag queried[kMaxDevices];
  int device = 0;
  const cudaError_t error = cudaGetDevice(&device);
  if (error != cudaSuccess) return error;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Card& c = cards[device];
  std::call_once(queried[device], [&c, device] {
    int per_sm = 0;
    c.error = cudaDeviceGetAttribute(
        &c.sms, cudaDevAttrMultiProcessorCount, device);
    if (c.error == cudaSuccess) {
      c.error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rasterize_bary_fwd_kernel<1>, kThreads, 0);
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

// The launch's group and split for `batch` images of width x height and
// `num_tris` rows. The group: 1 while the launch's row stream stays under
// kGroupOneRowsPerSm per SM, else 2. The split: the most CTAs (8, 4 or 2)
// per cluster whose launch fits in four waves of the card's resident CTA
// slots, else 2. A batch too deep for the grid at that split takes a
// smaller one. Chosen from the device times of every group and split on
// the teapot (2,464 rows) and sphere72 (10,368) at one 256x256 / 512x512
// image and four on the H100 (PERF.md); returns the card query's CUDA
// error.
int choose_launch(int batch, int num_tris, int width, int height,
                  int* group, int* split) {
  const Card* card = nullptr;
  const cudaError_t error = current_card(&card);
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

// Launches the kernel on `stream` and returns the launch's CUDA error (0 on
// success). `group` (1 or 2 pixel blocks per side of a cluster's group) and
// `split` (1, 2, 4 or 8 CTAs per cluster) are both 0 for the rule of
// choose_launch; other values serve only to measure that choice. Pointers
// are device pointers to contiguous tensors. The caller checks shapes,
// types and alignment.
extern "C" int rasterize_bary_fwd(const void* tri_rows, void* ids, void* bc,
                                  void* z, int batch, int num_tris,
                                  int width, int height, int row_offset,
                                  float scale_x, float scale_y, int group,
                                  int split, void* stream) {
  if (group == 0 && split == 0) {
    const int error =
        choose_launch(batch, num_tris, width, height, &group, &split);
    if (error != 0) return error;
  }
  const auto rows = static_cast<const float4*>(tri_rows);
  const auto out_ids = static_cast<int*>(ids);
  const auto out_bc = static_cast<float*>(bc);
  const auto out_z = static_cast<float*>(z);
  if (group == 1) {
    return launch_group<1>(rasterize_bary_fwd_kernel<1>, batch, width,
                           height, split, stream, rows, out_ids, out_bc,
                           out_z, num_tris, width, height, row_offset,
                           scale_x, scale_y);
  }
  if (group == 2) {
    return launch_group<2>(rasterize_bary_fwd_kernel<2>, batch, width,
                           height, split, stream, rows, out_ids, out_bc,
                           out_z, num_tris, width, height, row_offset,
                           scale_x, scale_y);
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}
