// Hard Phong shading, diffuse and ambient, forward and backward, for Hopper.
//
// Replaces no TPU kernel. The JAX package shades with plain XLA ops
// (pytorch_mesh_renderer_tpu/ops/shading.py `phong_shader`, called from
// models/mesh_renderer.py `render`), which XLA fuses on the TPU. The same
// ops in PyTorch (the port's ops/shading.py `phong_shader` after
// models/mesh_renderer.py `_shade_torch`'s slices of the attributes) run
// as some ninety kernels over [B, L, P, 3] broadcasts, forward and
// backward. These two kernels compute the same function in one pass each
// way. Their plain versions are those ops (forward) and
// ops/shading.py `phong_diffuse_backward_torch` (the backward that
// autograd takes through them, written out).
//
// The function, per pixel p of image b, from the rasterized attributes
// x = attrs[b, p, :] (normal n = x[0:3], position q = x[3:6], diffuse
// d = x[6:9]):
//   n^ = n / max(|n|, 1e-12),  u_l = (P_l - q) / max(|P_l - q|, 1e-12),
//   rgb = a * d + sum_l (d * clip(n^ . u_l, 0, 1)) * I_l,
//   mask = any(d >= 0),
// written to row H - 1 - r of out[b] (the vertical flip) as
// (mask ? rgb : 0, mask). Sums and products run in the plain ops' order,
// and with --fmad=false each rounds as PyTorch's kernels round it: a sum
// over a last axis of 3 (the norms, n^ . u) is PyTorch's reduction over
// two lanes, (v0 + v2) + v1 (`sum3`); the lights add one after another.
// The backward follows autograd's chain through those ops: `clip`'s
// derivative is 1/2 at exactly 0 or 1 (math_utils.clip), and
// `normalize`'s passes nothing through the clamp below 1e-12, so a
// zero-length vector gives 0 / 0 there as autograd does.
//
// What bounds it: device-memory bytes. A pixel reads its A attribute
// floats (36 bytes at A = 9) and writes 16 bytes forward; backward it reads
// the attributes and 16 bytes of image gradient and writes A floats, for
// some 30 (forward) and 90 (backward) fp32 operations a light.
//
// What the design does about it: one thread a pixel, blocks of 256 pixels
// of one image, the image's lights and ambient colour staged in shared
// memory (64 lights at a time); the attributes are read in place, with no
// strided copies, and each output pixel is one 16-byte store. Nothing is
// saved between the passes: the backward recomputes the forward's values.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kLightChunk = 64;
constexpr int kMaxImagesInGrid = 65535;
constexpr float kEps = 1e-12f;

// torch.clamp(norm, min=1e-12): NaN stays NaN.
__device__ __forceinline__ float clamp_eps(float norm) {
  return norm < kEps ? kEps : norm;
}

// math_utils.clip(s, 0, 1) = minimum(maximum(s, 0), 1): NaN stays NaN.
__device__ __forceinline__ float clip01(float s) {
  const float lo = s < 0.0f ? 0.0f : s;
  return lo > 1.0f ? 1.0f : lo;
}

// Its derivative (jnp.clip's): 1 inside (0, 1), 1/2 at exactly 0 or 1,
// 0 outside.
__device__ __forceinline__ float clip01_slope(float s) {
  if (s > 0.0f && s < 1.0f) return 1.0f;
  return (s == 0.0f || s == 1.0f) ? 0.5f : 0.0f;
}

// torch.sum over a contiguous last axis of 3 on the card: its reduction
// splits the axis over two lanes (0 and 2, then 1) and adds the lanes.
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}

// normalize(v) (math_utils.normalize) into `out`; returns |v|.
__device__ __forceinline__ float normalize3(const float v[3], float out[3]) {
  const float norm = sqrtf(sum3(v[0] * v[0], v[1] * v[1], v[2] * v[2]));
  const float m = clamp_eps(norm);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = v[k] / m;
  return norm;
}

// The gradient of normalize at v (|v| = norm) for the cotangent g, along
// autograd's chain: the quotient (g / m, and -(g . v) / m^2 into m), the
// clamp (nothing below eps), the square root (grad / (2 sqrt)) and the
// squares (2 v).
__device__ __forceinline__ void normalize3_backward(const float v[3],
                                                    float norm,
                                                    const float g[3],
                                                    float out[3]) {
  const float m = clamp_eps(norm);
  const float g_norm =
      norm >= kEps ? -(g[0] * v[0] + g[1] * v[1] + g[2] * v[2]) / (m * m)
                   : 0.0f;
  const float g_square = g_norm / (2.0f * norm);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = g[k] / m + g_square * (2.0f * v[k]);
}

// The lights of image b, [count, 3] positions and intensities from light
// `base` on, and its ambient colour (0 without one), into shared memory.
// Every thread of the block calls it; it ends with a barrier.
__device__ __forceinline__ void stage_lights(
    const float* __restrict__ light_pos, const float* __restrict__ light_int,
    const float* __restrict__ ambient, int b, int n_lights, int base,
    int count, float* s_pos, float* s_int, float* s_amb) {
  __syncthreads();  // the readers of the last chunk are done
  const size_t first = (static_cast<size_t>(b) * n_lights + base) * 3;
  for (int i = threadIdx.x; i < count * 3; i += kThreads) {
    s_pos[i] = light_pos[first + i];
    s_int[i] = light_int[first + i];
  }
  if (threadIdx.x < 3) {
    s_amb[threadIdx.x] =
        ambient != nullptr ? ambient[b * 3 + threadIdx.x] : 0.0f;
  }
  __syncthreads();
}

struct PixelInputs {
  float n[3], q[3], d[3];
  bool mask;
};

__device__ __forceinline__ PixelInputs load_pixel(const float* x) {
  PixelInputs in;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    in.n[k] = x[k];
    in.q[k] = x[3 + k];
    in.d[k] = x[6 + k];
  }
  in.mask = in.d[0] >= 0.0f || in.d[1] >= 0.0f || in.d[2] >= 0.0f;
  return in;
}

__global__ void __launch_bounds__(kThreads) phong_shade_fwd_kernel(
    const float* __restrict__ attrs,      // [B, H, W, A]
    const float* __restrict__ light_pos,  // [B, L, 3]
    const float* __restrict__ light_int,  // [B, L, 3]
    const float* __restrict__ ambient,    // [B, 3] or null
    float4* __restrict__ out,             // [B, H, W] of RGBA
    int batch, int n_lights, int n_attr, int height, int width) {
  __shared__ float s_pos[kLightChunk * 3];
  __shared__ float s_int[kLightChunk * 3];
  __shared__ float s_amb[3];
  const int pixels = height * width;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < pixels;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    PixelInputs in = {};
    if (live) {
      in = load_pixel(attrs + (static_cast<size_t>(b) * pixels + p) * n_attr);
    }
    float nh[3];
    normalize3(in.n, nh);
    float lit[3] = {0.0f, 0.0f, 0.0f};
    for (int base = 0; base == 0 || base < n_lights; base += kLightChunk) {
      const int count = min(kLightChunk, n_lights - base);
      stage_lights(light_pos, light_int, ambient, b, n_lights, base, count,
                   s_pos, s_int, s_amb);
      for (int l = 0; l < count; ++l) {
        float to_light[3], u[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) to_light[k] = s_pos[3 * l + k] - in.q[k];
        normalize3(to_light, u);
        const float c =
            clip01(sum3(nh[0] * u[0], nh[1] * u[1], nh[2] * u[2]));
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          lit[k] = lit[k] + in.d[k] * c * s_int[3 * l + k];
        }
      }
    }
    if (live) {
      float rgb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float base_colour = ambient != nullptr ? s_amb[k] * in.d[k]
                                                     : 0.0f;
        rgb[k] = in.mask ? base_colour + lit[k] : 0.0f;
      }
      const int row = p / width;
      const int col = p - row * width;
      out[(static_cast<size_t>(b) * height + (height - 1 - row)) * width +
          col] = make_float4(rgb[0], rgb[1], rgb[2], in.mask ? 1.0f : 0.0f);
    }
  }
}

__global__ void __launch_bounds__(kThreads) phong_shade_bwd_kernel(
    const float* __restrict__ attrs,      // [B, H, W, A]
    const float* __restrict__ light_pos,  // [B, L, 3]
    const float* __restrict__ light_int,  // [B, L, 3]
    const float* __restrict__ ambient,    // [B, 3] or null
    const float4* __restrict__ d_out,     // [B, H, W] of RGBA
    float* __restrict__ d_attrs,          // [B, H, W, A]
    int batch, int n_lights, int n_attr, int height, int width) {
  __shared__ float s_pos[kLightChunk * 3];
  __shared__ float s_int[kLightChunk * 3];
  __shared__ float s_amb[3];
  const int pixels = height * width;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < pixels;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    PixelInputs in = {};
    float g[3] = {0.0f, 0.0f, 0.0f};
    if (live) {
      in = load_pixel(attrs + (static_cast<size_t>(b) * pixels + p) * n_attr);
      if (in.mask) {  // where(alpha > 0.5, rgb, 0) passes nothing else
        const int row = p / width;
        const int col = p - row * width;
        const float4 go = d_out[(static_cast<size_t>(b) * height +
                                 (height - 1 - row)) * width + col];
        g[0] = go.x;
        g[1] = go.y;
        g[2] = go.z;
      }
    }
    float nh[3];
    const float n_norm = normalize3(in.n, nh);
    float g_d[3] = {0.0f, 0.0f, 0.0f};
    float g_nh[3] = {0.0f, 0.0f, 0.0f};
    float g_q[3] = {0.0f, 0.0f, 0.0f};
    for (int base = 0; base == 0 || base < n_lights; base += kLightChunk) {
      const int count = min(kLightChunk, n_lights - base);
      stage_lights(light_pos, light_int, ambient, b, n_lights, base, count,
                   s_pos, s_int, s_amb);
      for (int l = 0; l < count; ++l) {
        float to_light[3], u[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) to_light[k] = s_pos[3 * l + k] - in.q[k];
        const float to_norm = normalize3(to_light, u);
        const float s = sum3(nh[0] * u[0], nh[1] * u[1], nh[2] * u[2]);
        const float c = clip01(s);
        float g_lit[3];  // the cotangent of d * c
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          g_lit[k] = g[k] * s_int[3 * l + k];
          g_d[k] = g_d[k] + g_lit[k] * c;
        }
        const float g_s =
            (g_lit[0] * in.d[0] + g_lit[1] * in.d[1] + g_lit[2] * in.d[2]) *
            clip01_slope(s);
        float g_u[3], g_to[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          g_nh[k] = g_nh[k] + g_s * u[k];
          g_u[k] = g_s * nh[k];
        }
        normalize3_backward(to_light, to_norm, g_u, g_to);
#pragma unroll
        for (int k = 0; k < 3; ++k) g_q[k] = g_q[k] - g_to[k];
      }
    }
    if (live) {
      float g_n[3];
      normalize3_backward(in.n, n_norm, g_nh, g_n);
      float* row = d_attrs + (static_cast<size_t>(b) * pixels + p) * n_attr;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        row[k] = g_n[k];
        row[3 + k] = g_q[k];
        row[6 + k] = g_d[k] + (ambient != nullptr ? g[k] * s_amb[k] : 0.0f);
      }
      for (int a = 9; a < n_attr; ++a) row[a] = 0.0f;
    }
  }
}

dim3 shade_grid(int batch, int pixels) {
  return dim3((pixels + kThreads - 1) / kThreads,
              batch < kMaxImagesInGrid ? batch : kMaxImagesInGrid);
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success). Device
// pointers to contiguous f32 tensors: attrs [B, H, W, A] with A >= 9,
// light_pos and light_int [B, L, 3], ambient [B, 3] or null, out and d_out
// [B, H, W, 4], d_attrs [B, H, W, A]. The caller checks shapes, types,
// devices and that B H W A fits a size_t and H W an int.
extern "C" int phong_shade_fwd(const void* attrs, const void* light_pos,
                               const void* light_int, const void* ambient,
                               void* out, int batch, int n_lights,
                               int n_attr, int height, int width,
                               void* stream) {
  if (batch > 0 && height * width > 0) {
    phong_shade_fwd_kernel<<<shade_grid(batch, height * width), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(attrs),
        static_cast<const float*>(light_pos),
        static_cast<const float*>(light_int),
        static_cast<const float*>(ambient), static_cast<float4*>(out),
        batch, n_lights, n_attr, height, width);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int phong_shade_bwd(const void* attrs, const void* light_pos,
                               const void* light_int, const void* ambient,
                               const void* d_out, void* d_attrs, int batch,
                               int n_lights, int n_attr, int height,
                               int width, void* stream) {
  if (batch > 0 && height * width > 0) {
    phong_shade_bwd_kernel<<<shade_grid(batch, height * width), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(attrs),
        static_cast<const float*>(light_pos),
        static_cast<const float*>(light_int),
        static_cast<const float*>(ambient),
        static_cast<const float4*>(d_out), static_cast<float*>(d_attrs),
        batch, n_lights, n_attr, height, width);
  }
  return static_cast<int>(cudaGetLastError());
}
