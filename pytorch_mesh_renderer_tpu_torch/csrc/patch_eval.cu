// Patch evaluation of the patch-scatter microbenchmark, for Hopper.
//
// Replaces the Pallas kernel of scripts/patch_scatter_microbench.py (S3):
// `kernel` (:191), launched by `run_kernel` (:229). The plain PyTorch
// version it is held against is
// pytorch_mesh_renderer_tpu_torch/microbench/patch_scatter.py
// `patch_eval_torch`.
//
// The function: for every patch instance (a triangle's packed row and the
// pixel origin of one PH x PW window of its bbox, PH * PW = 128) and every
// lane of the window, the production per-pixel test with no winner: the
// lane's pixel centre, edge functions, inside test, depth, and the valid
// test (inside, live, -1 <= z <= 1, inside the image). Outputs per lane:
// z where valid, else 2, and the three raw edge values where valid, else 0
// (four [B, S, 128] f32 planes).
//
// What bounds it: device-memory bytes. A lane reads its instance's 80-byte
// row (shared by 128 lanes) and writes 16 bytes, for ~43 fp32 operations:
// 128 x 16 bytes of output per 80 bytes read.
//
// What the design does about it: one thread per (instance, lane), 128
// threads per instance, blocks of 256 (two instances). A thread reads its
// row as five 16-byte loads that every thread of the instance shares
// (broadcast from L1), and the four output planes are written with
// consecutive lanes at consecutive addresses. The per-lane arithmetic is
// rasterize_common.cuh's (pixel_ndc and the edge and depth expressions of
// consider_row, in the same order), so with --fmad=false the kernel
// equals its plain version bit for bit.

#include "rasterize_common.cuh"

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 128;
constexpr int kEvalThreads = 256;
constexpr int kInstanceFloat4s = 5;  // 16 packed columns, ox, oy, 0, 0

__global__ void __launch_bounds__(kEvalThreads) patch_eval_kernel(
    const float4* __restrict__ table,  // [n_inst, 20]
    float* __restrict__ out,           // [4, n_inst, 128]: z, we0, we1, we2
    int n_inst, int size, int patch_w, float scale) {
  const int index = blockIdx.x * kEvalThreads + threadIdx.x;
  const int inst = index / kLanes;
  const int lane = index % kLanes;
  if (inst >= n_inst) return;
  const float4* row = table + static_cast<size_t>(inst) * kInstanceFloat4s;
  const float4 r0 = __ldg(row + 0);  // a0 b0 c0 a1
  const float4 r1 = __ldg(row + 1);  // b1 c1 a2 b2
  const float4 r2 = __ldg(row + 2);  // c2 z0 z1 z2
  const float4 r3 = __ldg(row + 3);  // w0 w1 w2 live
  const float4 r4 = __ldg(row + 4);  // ox oy 0 0
  // The origin holds whole pixels: the plain version's float sums
  // ox + dx are these integers exactly.
  const int ix = static_cast<int>(r4.x) + lane % patch_w;
  const int iy = static_cast<int>(r4.y) + lane / patch_w;
  const float px = pixel_ndc(ix, scale);
  const float py = pixel_ndc(iy, scale);
  const float e0 = r0.x * px + r0.y * py + r0.z;
  const float e1 = r0.w * px + r1.x * py + r1.y;
  const float e2 = r1.z * px + r1.w * py + r2.x;
  const float min_e = fminf(fminf(e0, e1), e2);
  const float max_e = fmaxf(fmaxf(e0, e1), e2);
  const bool inside = min_e >= 0.0f && max_e > 0.0f;
  const float num = e0 * r2.y + e1 * r2.z + e2 * r2.w;
  const float den = e0 * r3.x + e1 * r3.y + e2 * r3.z;
  const float z = num / (den != 0.0f ? den : 1.0f);
  const bool valid = inside && r3.w > 0.0f && z >= -1.0f && z <= 1.0f &&
                     ix < size && iy < size;
  const float wf = valid ? 1.0f : 0.0f;
  const size_t plane = static_cast<size_t>(n_inst) * kLanes;
  const size_t i = static_cast<size_t>(inst) * kLanes + lane;
  out[i] = valid ? z : 2.0f;
  out[plane + i] = wf * e0;
  out[2 * plane + i] = wf * e1;
  out[3 * plane + i] = wf * e2;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Device pointers to contiguous tensors: table [n_inst, 20]
// (16-byte aligned), out [4, n_inst, 128]. The caller checks shapes, types,
// alignment and that n_inst * 128 fits an int.
extern "C" int patch_eval(const void* table, void* out, int n_inst, int size,
                          int patch_w, float scale, void* stream) {
  const int threads = n_inst * kLanes;
  const int blocks = (threads + kEvalThreads - 1) / kEvalThreads;
  if (blocks > 0) {
    patch_eval_kernel<<<blocks, kEvalThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table), static_cast<float*>(out), n_inst,
        size, patch_w, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
