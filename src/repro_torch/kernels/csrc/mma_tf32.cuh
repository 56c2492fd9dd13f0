// Shared by the tensor-core kernels (flash_attention.cu, lora_matmul.cu):
// fp32-accurate products on the TF32 tensor cores (3xTF32 mma.sync) and
// cp.async staging into shared memory.
//
// Each operand x is cut into big = tf32(x) and small = tf32(x − big)
// (round to nearest), and a·b ≈ small_a·big_b + big_a·small_b +
// big_a·big_b: the two small terms first, then big·big, into a fresh
// fragment per step of 8 that is added to the running sum in fp32 (mma3).
// The dropped small·small term and the two roundings of the small parts
// are near 2^-22 of a product, below fp32's own summation error; one TF32
// pass (2^-11) misses the port's fp32 gates by 100x.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a TF32 value (the error is ~2^-22 |x|)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// x = big + small with big = tf32(x) (round to nearest, ties away: the
// integer form of cvt.rna, the same bits) and small = x − big left in
// fp32: the mma reads its top 19 bits (a truncation, ~2^-21 |x|).  Two
// integer operations and a subtraction, no conversion; an fp32 product
// summed from it measured 1.01x the rms error against fp64 of split's.
__device__ __forceinline__ void split_fast(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// A fragment of m16n8k8 (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); B fragment (8 x 8, col): b0 (k t, n g), b1 (k t+4, n g);
// C fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1); with
// g = lane / 4 and t = lane % 4.
struct FragA { uint4 big, small; };
struct FragB { uint32_t big[2], small[2]; };

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a,
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

// acc += a·b at fp32 accuracy: the small terms first, then big·big, into a
// fresh fragment that is added to acc in fp32 (round to nearest)
__device__ __forceinline__ void mma3(float (&acc)[4], const FragA& a,
                                     const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
  #pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace
