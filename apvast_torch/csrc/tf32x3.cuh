// 3xTF32: fp32 matrix products on the tensor cores at about fp32 accuracy.
// A tool of K1 (streaming_conv.cu) and K6 (statistics.cu), not a kernel.
//
// Each fp32 operand x is split into a TF32 high part and a TF32 low part,
//   hi = tf32(x),  lo = tf32(x - hi)      (cvt.rna: nearest, ties away)
// and a product a * b is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi on
// mma.sync m16n8k8 (TF32 in, fp32 accumulate). x - hi is exact in fp32, so
// hi + lo holds x to ~2^-22 of |x|, and the one dropped term, a_lo*b_lo, is
// ~2^-22 of |a b|. The two small cross terms are issued first, while the
// accumulator is small. One TF32 pass alone keeps ~11 significant bits
// (~2^-12 of |a b| per product) and stays refused: the GEVD needs fp32.
// Three passes at 495 TFLOP/s (dense TF32, H100 SXM) are an fp32 rate of
// 165 TFLOP/s, against 67 TFLOP/s of fp32 FMA on the CUDA cores.
//
// Fragment layout of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// lane = 4g + t (g < 8, t < 4), (row, column):
//   A (16 x 8): a[0] = (g, t), a[1] = (g+8, t), a[2] = (g, t+4), a[3] = (g+8, t+4)
//   B (8 x 8):  b[0] = (k = t, n = g), b[1] = (k = t+4, n = g)
//   C (16 x 8): c[0] = (g, 2t), c[1] = (g, 2t+1), c[2] = (g+8, 2t), c[3] = (g+8, 2t+1)
// The kernels load fragments from shared memory themselves (their operands
// are Toeplitz or Hankel slices, which no tile copy expresses) and add the
// MMA sums of every 32-deep stretch into a separate fp32 total with plain
// (round-to-nearest) adds: the tensor core's accumulator does not round to
// nearest, so a long sum left in it drifts from fp32 accuracy.

#pragma once

#include <cstdint>

namespace tf32x3 {

// cvt.rna.tf32.f32, with the 13 bits below TF32's 10-bit mantissa cleared.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a * b, one m16n8k8 TF32 tensor-core product.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the cross terms, then the main term.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

}  // namespace tf32x3
