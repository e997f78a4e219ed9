// Inline-PTX wrappers for the tensor-core paths (sm_80+ instructions, run here
// on sm_90a): cp.async into shared memory, ldmatrix, the warp-wide m16n8k16
// bf16 product and the m16n8k8 TF32 product, both with f32 accumulation, and
// the 3xTF32 split that carries f32 operands through the TF32 product.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4), each register
// holding two bf16 (the lower column or k index in the low half):
//   A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                           a2 (row g, k 2t+8..),   a3 (row g+8, k 2t+8..)
//   B (16 x 8, col-major):  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C (16 x 8, f32):        c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same)
// So the C fragments of two neighbouring n8 tiles are, rounded to bf16 in
// pairs, the A fragment of a product over their 16 columns.
//
// Fragment layouts of mma.m16n8k8 with tf32 operands, one value a register:
//   A (16 x 8, row-major):  a0 (row g, k t), a1 (row g+8, k t),
//                           a2 (row g, k t+4), a3 (row g+8, k t+4)
//   B (8 x 8, col-major):   b0 (k t, col g), b1 (k t+4, col g)
//   C (16 x 8, f32):        as for m16n8k16
// A product sums over k, so the fp32 kernels permute k inside each 8-wide
// step: fragment index t stands for k = 2t and t+4 for k = 2t+1. A B fragment
// is then two neighbours (one 64-bit load where they are neighbours in
// memory), and a C fragment (cols 2t, 2t+1) is, as (c0, c2, c1, c3), the A
// fragment of a product over those 8 columns, with no shuffle.
//
// 3xTF32: a TF32 product keeps 11 significant bits of each operand. An f32 x
// splits into hi = tf32(x) and lo = tf32(x - hi), which hold x to ~2^-22 of
// |x|; a b = lo_a hi_b + hi_a lo_b + hi_a hi_b, small products first, in one
// f32 accumulator, leaving out lo_a lo_b (~2^-22 of |a b|). Three TF32
// products (495 TFLOP/s dense on an H100 SXM) per f32 product: ~165 TFLOP/s,
// against 67 for f32 FMAs on the CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, not through L1; with valid false no
// byte is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// wait for every cp.async this thread issued; the caller then syncs the
// threads that read the data
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b over one 16 x 8 x 16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two raw bf16 into one register, lo in the low half
__device__ __forceinline__ uint32_t pack_raw(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// f32 -> tf32, rounded to nearest with ties away from zero: the 13 low
// mantissa bits cleared
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 of |x|, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo for a 3xTF32 product: hi = tf32(x) (cvt.rna, as mma.cuh), lo =
// x - hi exactly, left for the tensor core to truncate to TF32 as it reads it
// (its low 13 bits dropped: lo to ~2^-21 of |x| rather than ~2^-22, and one
// cvt fewer per operand; tests/test_torch_tf32x3.py emulates it)
__device__ __forceinline__ void split_hi(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b over one 16 x 8 x 8 tile, tf32 operands
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32, a and b given as their hi and lo parts
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

}  // namespace
