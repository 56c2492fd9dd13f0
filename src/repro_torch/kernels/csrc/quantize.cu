// Fused top-k + symmetric int quantization kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/quantize.py:
//   * topk_quantize_kernel <- topk_quantize_rows / _topk_kernel: per row of
//       x (R, C), the k largest values (ties to the lower index, the order
//       of lax.top_k), then scale = max(absmax / qmax, 1e-12) over those k
//       and q = clamp(round_half_even(v / scale), -qmax, qmax) in int8,
//       qmax = 2^(bits-1) - 1.  Outputs q int8 (R, k), idx int32 (R, k),
//       scale fp32 (R, 1): the KD b3 logit upload.
//
// What bounds it on this card: the data is read once in principle
// (R*C*4 bytes in, R*k*5 + R*4 out), so the bound is bytes: 39 KB at the
// main path's (150, 77), 257 MB (0.077 ms) at (1280, 50257).  The
// selection does k passes over each row, k*C compares, served from L1/L2
// after the first pass; at k = 64 over C = 50257 that re-reading, not
// device memory, is what this simple kernel spends its time on.
//
// The simple design: one row per warp (C <= 2048) or per 256-thread block.
// Round t takes the maximum, in the order (value descending, index
// ascending), among the elements that come strictly after pick t-1 in
// that order, so the row needs no writable copy: it equals the reference's
// "first argmax, then overwrite it with -1e30" for every row with no entry
// <= -1e30.  Each thread scans its strided columns; the threads reduce in
// a xor butterfly within the warp and in warp order through shared memory,
// so every thread learns the pick.  The quantization uses IEEE division and
// rintf (no fast math), so q, idx and scale are bit-identical to the plain
// PyTorch version.  A later PR should stage a row in shared memory (201 KB
// at C = 50257 fits in 227 KB) or select with a radix pass.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int K_MAX = 512;       // largest k

struct Pick {
  float v;
  int j;
};

// a comes before b in the order (value descending, index ascending)
__device__ __forceinline__ bool before(float av, int aj, float bv, int bj) {
  return av > bv || (av == bv && aj < bj);
}

__device__ __forceinline__ Pick warp_best(Pick p) {
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, p.v, off);
    const int oj = __shfl_xor_sync(0xffffffffu, p.j, off);
    if (before(ov, oj, p.v, p.j)) p = Pick{ov, oj};
  }
  return p;
}

__device__ __forceinline__ float warp_max(float v) {
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int TPR>
__global__ void __launch_bounds__(NT)
topk_quantize_kernel(const float* __restrict__ X, int8_t* __restrict__ Q,
                     int* __restrict__ IDX, float* __restrict__ SCALE, int R,
                     int C, int k, float qmax) {
  constexpr int RPB = NT / TPR;          // rows per block
  constexpr int WPR = TPR / 32;          // warps per row
  __shared__ float pv[RPB][K_MAX];
  __shared__ int pj[RPB][K_MAX];
  __shared__ Pick red[RPB][WPR];
  __shared__ float redm[RPB][WPR];
  const int rb = threadIdx.x / TPR, tr = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + rb;
  const bool live = row < R;
  const float* x = X + (size_t)(live ? row : 0) * C;

  // the previous pick; the first round takes the row's first element in
  // the order, i.e. everything comes "after" (+inf, -1)
  float prev_v = INFINITY;
  int prev_j = -1;
  for (int t = 0; t < k; ++t) {
    Pick best{-INFINITY, INT_MAX};
    if (live) {
      for (int j = tr; j < C; j += TPR) {
        const float v = x[j];
        if (before(prev_v, prev_j, v, j) && before(v, j, best.v, best.j))
          best = Pick{v, j};
      }
    }
    best = warp_best(best);
    if constexpr (WPR > 1) {
      if (tr % 32 == 0) red[rb][tr / 32] = best;
      __syncthreads();
      best = red[rb][0];
      for (int w = 1; w < WPR; ++w)
        if (before(red[rb][w].v, red[rb][w].j, best.v, best.j))
          best = red[rb][w];
      __syncthreads();                   // red is rewritten next round
    }
    if (tr == 0) {
      pv[rb][t] = best.v;
      pj[rb][t] = best.j;
    }
    prev_v = best.v;
    prev_j = best.j;
  }
  __syncthreads();

  float am = 0.f;
  for (int t = tr; t < k; t += TPR) am = fmaxf(am, fabsf(pv[rb][t]));
  am = warp_max(am);
  if constexpr (WPR > 1) {
    if (tr % 32 == 0) redm[rb][tr / 32] = am;
    __syncthreads();
    am = redm[rb][0];
    for (int w = 1; w < WPR; ++w) am = fmaxf(am, redm[rb][w]);
  }
  if (!live) return;
  const float scale = fmaxf(am / qmax, 1e-12f);
  for (int t = tr; t < k; t += TPR) {
    const float q = fminf(fmaxf(rintf(pv[rb][t] / scale), -qmax), qmax);
    Q[(size_t)row * k + t] = (int8_t)q;
    IDX[(size_t)row * k + t] = pj[rb][t];
  }
  if (tr == 0) SCALE[row] = scale;
}

}  // namespace

extern "C" {

// q int8 (R, k), idx int32 (R, k), scale fp32 (R,) from x fp32 (R, C).
int topk_quantize(const float* x, int8_t* q, int* idx, float* scale, int R,
                  int C, int k, int bits, void* stream) {
  if (R <= 0 || C <= 0 || k < 1 || k > C || k > K_MAX || bits < 2 ||
      bits > 8)
    return (int)cudaErrorInvalidValue;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 2048) {
    const int rpb = NT / 32;
    topk_quantize_kernel<32><<<(R + rpb - 1) / rpb, NT, 0, s>>>(
        x, q, idx, scale, R, C, k, qmax);
  } else {
    topk_quantize_kernel<NT><<<R, NT, 0, s>>>(x, q, idx, scale, R, C, k,
                                              qmax);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
