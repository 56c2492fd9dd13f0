// Shared by the tensor-core kernels (flash_attention.cu, lora_matmul.cu):
// fp32-accurate products on the TF32 tensor cores (3xTF32 mma.sync, and
// 3xTF32 wgmma from shared memory) and cp.async staging into shared memory.
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

// ---- wgmma (sm_90a): a warpgroup of 4 warps, operands in shared memory ----
//
// An operand tile is K-major (tf32 wgmma takes no other): each of its rows
// holds 32 fp32 of the contraction in 128 bytes, in the 128-byte swizzle
// (the 16-byte chunk c of row r sits at chunk c ^ (r % 8) of the row), and
// the tile starts on a 1024-byte boundary; 8-row groups lie 1024 bytes
// apart.  A step of 8 of the contraction is the descriptor of the tile
// advanced by 32 bytes.
__device__ __forceinline__ int swizzle128(int row, int chunk) {
  return row * 32 + ((chunk ^ (row & 7)) << 2);   // the float index
}

__device__ __forceinline__ uint64_t wgmma_desc(const float* tile) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(tile);
  return (uint64_t)((addr & 0x3FFFF) >> 4)        // start address
         | (uint64_t)(16 >> 4) << 16               // leading offset (unused)
         | (uint64_t)(1024 >> 4) << 32             // 8-row groups
         | (uint64_t)1 << 62;                      // 128-byte swizzle
}

// d (64 x 128, fp32) = A·Bᵀ + (scale_d ? d : 0) for the 64-row A tile and
// the 128-row B tile a step of 8 of the contraction; TF32 operands (the
// tensor core reads the top 19 bits of each fp32 word).  d's fragment:
// warp w of the group, lane l: d[4j + 2h + e] is (row 16w + l / 4 + 8h,
// column 8j + 2(l % 4) + e).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator across a wait
template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// makes this thread's st.shared visible to the wgmmas (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace
