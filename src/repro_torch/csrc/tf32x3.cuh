// Split-TF32 products on the tensor cores and the cp.async copies that feed
// them, as the float32 sliding-window attention kernels use them (the
// forward, swa_attention_tf32x3.cu, and the backward,
// swa_attention_bwd_tf32x3.cu).
//
// A float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest with ties away (cvt.rna.tf32's rounding, done on the
// bits: add half an ulp of the 10-bit mantissa, clear the 13 low bits); a
// product is taken as lo*hi + hi*lo + hi*hi, three mma.sync m16n8k8 TF32
// products into one float32 accumulator (lo*lo, ~2^-22 relative, is
// dropped).  m16n8k8 fragments, lane = 4 g + t: A a0 (row g, k t), a1 (row
// g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4); B b0 (k t,
// column g), b1 (k t + 4, column g); C c0, c1 (row g, columns 2t, 2t + 1),
// c2, c3 (row g + 8, the same columns).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// TF32 of x, rounded to nearest with ties away from zero (cvt.rna.tf32).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(nbytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int nbytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(nbytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace tf32x3
