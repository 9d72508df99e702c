// Tensor-core helpers of the microbenchmark kernels (mxu_edge.cu,
// mxu_full.cu): warp-level `mma.sync` products in TF32 and bf16 with fp32
// accumulation, the rounding of their operands, `ldmatrix` fragment loads
// and `cp.async` copies into shared memory.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k8"), for
// lane = 4 * g + q (g = lane / 4, q = lane % 4):
//   m16n8k8 .tf32: A (16x8, row) a0 = A[g][q], a1 = A[g+8][q],
//     a2 = A[g][q+4], a3 = A[g+8][q+4]; B (8x8, col) b0 = B[q][g],
//     b1 = B[q+4][g];
//   m16n8k8 .bf16: A (16x8) a0 = A[g][2q..2q+1], a1 = A[g+8][2q..2q+1];
//     B (8x8) b0 = B[2q..2q+1][g], the lower index in the low 16 bits;
//   both: C/D (16x8 f32) c0 = D[g][2q], c1 = D[g][2q+1], c2 = D[g+8][2q],
//     c3 = D[g+8][2q+1].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// x rounded to TF32 (10 explicit mantissa bits, to nearest, ties away
// from zero), the 13 low bits cleared: the plain versions' tf32_round.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// The operands of a 3xTF32 product: hi = tf32(x), lo = tf32(x - hi).
struct Tf32Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32Split split_tf32(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// Two floats as one bf16x2 register, each rounded to nearest even; `lo`
// in the low 16 bits.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d = a * b + c, m16n8k8, TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2],
                                         const float c[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d = a * b + c, m16n8k8, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16_k8(float d[4], const uint32_t a[2],
                                            uint32_t b, const float c[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "f"(c[0]), "f"(c[1]), "f"(c[2]),
        "f"(c[3]));
}

// ldmatrix: each lane gives the shared address of one 16-byte row (lanes
// 8j..8j+7 the rows of matrix j) and receives, of matrix j, the 32 bits at
// row lane / 4, word lane % 4 in register j. Of 32-bit elements (TF32)
// that is element [lane / 4][lane % 4] of an 8x4 matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  const unsigned address =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(address));
}

// ldmatrix of two matrices: lanes 0-15 give the rows' addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* row) {
  const unsigned address =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(address));
}

// Asynchronous 16-byte copy from device to shared memory (cp.async, which
// bypasses the registers). cp_async_commit closes this thread's group of
// copies; cp_async_wait<N> waits until at most N of its groups are in
// flight, whose copies are then complete and visible to it.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned address =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(address),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kInFlight>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kInFlight) : "memory");
}

// d = a * b as a 3xTF32 product (hi*hi + hi*lo + lo*hi) for a B whose lo
// part is zero (b_lo == 0 on every lane): lo*hi, then hi*hi, summed in the
// accumulator. The dropped hi*lo product is exactly zero.
__device__ __forceinline__ void mma_tf32x3_exact_b(float d[4],
                                                   const uint32_t a_hi[4],
                                                   const uint32_t a_lo[4],
                                                   const uint32_t b_hi[2]) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(d, a_lo, b_hi, zero);
  mma_tf32(d, a_hi, b_hi, d);
}

}  // namespace
